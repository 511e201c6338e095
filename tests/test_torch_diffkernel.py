"""The fused differentiable kernel's host side and its plain twin (ops/
diffkernel.py, ops/diffkernel_packed.py) against the JAX package.

The twin of K5 runs on the CPU here; the CUDA kernel is held to the twin
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 12). Torch
runs single-threaded and keeps every tensor under its 32768-element
parallel grain (see tests/test_torch_intersect.py).

Tolerances, with what was measured (this CPU):
  - the host structure, the flat table and the table-to-field mapping:
    bit for bit;
  - the twin against JAX's K5 in interpret mode (cornell_spheres 16x16,
    spp=2, mb=3, seed 5): XLA fuses a*b + c inside jit on the CPU, which
    the port never does, and at this seed that moves one pixel's path
    across a discrete edge (max |d| 9.0e-3; every other pixel within
    1e-5). The loss within LOSS_RTOL (measured 2.3e-6); the image within
    1e-5 on all but IMG_MAX_OFF pixels, and those within IMG_OFF_ATOL;
    each gradient field of its largest entry within GRAD_RTOL, `tests/
    test_diffkernel.py:_compare`'s default (measured at most 1.5e-3,
    sph_radius), except sph_center, which the flipped path moves: within
    _compare's rtol for cornell_spheres, CORNELL_GRAD_RTOL (measured
    0.022);
  - the twin against the port's modular `render_loss` (the oracle of
    tests/test_diffkernel.py:59-86, seed 0): the loss within LOSS_RTOL
    (measured 3.8e-6), sph_center within CORNELL_GRAD_RTOL (measured
    0.033; the two tracers' formulas decide a few winner ties
    differently), every other field within GRAD_RTOL (measured at most
    1.7e-3, mat_emit);
  - the replay of dead bounces: bit for bit (their terms are exact
    zeros, which is what lets the CUDA kernel skip them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.ops import diffkernel as jdk
from tinyraytracer_tpu.ops import diffkernel_packed as jdkp
from tinyraytracer_tpu_torch.diff import inverse as tinv
from tinyraytracer_tpu_torch.diff import params as tpar
from tinyraytracer_tpu_torch.models import camera as tcam
from tinyraytracer_tpu_torch.models import world as tworld
from tinyraytracer_tpu_torch.ops import diffkernel as tdk
from tinyraytracer_tpu_torch.ops import diffkernel_packed as tdkp
from tinyraytracer_tpu_torch.ops import scene_table
from tinyraytracer_tpu_torch.ops import trace as trace_ops
from test_diffkernel import _mixed_world

FIELDS = tpar.FLOAT_FIELDS + ("background",)
LOSS_RTOL = 1e-4
IMG_MAX_OFF = 4          # pixels of 256 beyond 1e-5 (measured: 1)
IMG_OFF_ATOL = 0.02      # how far those may be (measured: 9.0e-3)
GRAD_RTOL = 5e-3         # _compare's default rtol
CORNELL_GRAD_RTOL = 0.1  # _compare's rtol on cornell_spheres


def field_rtol(field):
    return CORNELL_GRAD_RTOL if field == "sph_center" else GRAD_RTOL


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def to_port(js, jc):
    """The JAX scene and camera in the port, bit for bit."""
    scene = tworld.scene_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in tworld._FIELD_DTYPES}, "cpu")
    cam = tcam.Camera.from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in tcam._VEC_FIELDS},
        jc.width, jc.height)
    return scene, cam


def jax_scene(name):
    if name == "mixed":
        return _mixed_world()
    maker = getattr(jpresets, name)
    w, c, kw = maker(width=16, height=12)
    return w.build(), c, kw["background"]


# random_spheres (500 spheres, 500 materials) is a K4 scene: K4 reads the
# same flat table
SCENES = ("cornell_spheres", "mixed", "three_spheres", "random_spheres")


@pytest.mark.parametrize("name", SCENES)
def test_diff_static_equals_jax(name):
    js, _, _ = jax_scene(name)
    ts, _ = to_port(js, _mixed_world()[1])
    assert (tdk.build_diff_static(ts).__dict__
            == jdk.build_diff_static(js).__dict__)


@pytest.mark.parametrize("name", SCENES)
def test_static_kind_flags_equal_jax(name):
    js, _, _ = jax_scene(name)
    ts, _ = to_port(js, _mixed_world()[1])
    want = jdk.static_kind_flags(jdk.build_diff_static(js))
    assert tdk.static_kind_flags(tdk.build_diff_static(ts)) == want


@pytest.mark.parametrize("name", SCENES)
def test_packed_flat_table_bitwise(name):
    js, _, _ = jax_scene(name)
    ts, _ = to_port(js, _mixed_world()[1])
    jtab, jprims, jlo = jdkp.packed_flat_table(js, jdk.build_diff_static(js))
    tab, prims, lo = tdkp.packed_flat_table(ts, tdk.build_diff_static(ts))
    np.testing.assert_array_equal(tab.numpy().view(np.int32),
                                  np.asarray(jtab).view(np.int32))
    assert prims == jprims and lo == jlo


@pytest.mark.parametrize("name", SCENES)
def test_grads_to_scene_maps_tables_as_jax(name):
    js, _, _ = jax_scene(name)
    ts, _ = to_port(js, _mixed_world()[1])
    st = jdk.build_diff_static(js)
    rs = np.random.RandomState(2)
    tabs = [rs.normal(size=s).astype(np.float32) for s in
            ((st.ns, 8), (st.nq, 16), (st.nm, 8), (st.nl, 16), (8, 128))]
    want = jdk._grads_to_scene(js, st, *map(jnp.asarray, tabs))
    got = tdk._grads_to_scene(ts, tdk.build_diff_static(ts),
                              *map(torch.from_numpy, tabs))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_mixed_materials_is_the_jax_parity_scene():
    """presets.mixed_materials, which the card's K5 checks use, is
    tests/test_diffkernel.py's `_mixed_world`: the scene bit for bit, the
    camera within 1 ulp (tests/test_torch_scene.py)."""
    from tinyraytracer_tpu_torch.models import presets as tpresets

    js, jc, bg = _mixed_world()
    world, cam, kw = tpresets.mixed_materials()
    scene = world.build()
    for f in tworld._FIELD_DTYPES:
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in tcam._VEC_FIELDS:
        np.testing.assert_array_max_ulp(getattr(cam, f).numpy(),
                                        np.asarray(getattr(jc, f)), maxulp=1)
    assert (cam.width, cam.height) == (jc.width, jc.height)
    assert kw["background"] == bg


# --- the twin against JAX's K5 in interpret mode ---------------------------

@pytest.fixture(scope="module")
def k5_pair():
    jw, jc, kw = jpresets.cornell_spheres(width=16, height=16)
    js = jw.build()
    ts, tc = to_port(js, jc)
    target = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32) * 0.5
    kws = dict(spp=2, max_bounces=3, background=kw["background"], seed=5)
    jl, ji, jg = jdkp.render_value_and_grad_packed(
        js, jc, target, interpret=True, tile=(8, 128), **kws)
    want = (float(jl), np.asarray(ji), {k: np.asarray(v) for k, v in
                                        jg.items()})
    tl, ti, tg = tdkp.render_value_and_grad_packed_reference(
        ts, tc, target, **kws)
    return want, (float(tl), ti.numpy(), {k: v.numpy() for k, v in
                                          tg.items()})


def test_k5_twin_loss_matches_jax(k5_pair):
    (jl, _, _), (tl, _, _) = k5_pair
    assert abs(tl - jl) <= LOSS_RTOL * jl


def test_k5_twin_image_matches_jax(k5_pair):
    (_, ji, _), (_, ti, _) = k5_pair
    d = np.abs(ti - ji).max(-1)
    assert ti.shape == (16, 16, 3) and (d > 1e-5).sum() <= IMG_MAX_OFF
    assert d.max() <= IMG_OFF_ATOL


@pytest.mark.parametrize("field", FIELDS)
def test_k5_twin_gradient_matches_jax(k5_pair, field):
    (_, _, jg), (_, _, tg) = k5_pair
    a, b = jg[field], tg[field]
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-8)
    assert np.abs(a - b).max() <= field_rtol(field) * scale


# --- the twin against the port's modular gradients (no JAX) ---------------

@pytest.fixture(scope="module")
def modular_pair():
    from tinyraytracer_tpu_torch.models import presets as tpresets

    w, c, kw = tpresets.cornell_spheres(width=16, height=16)
    scene, bg = w.build(), kw["background"]
    target = trace_ops.render_image(scene, c, spp=4, max_bounces=3,
                                    background=torch.tensor(bg), seed=9,
                                    nee=True)
    lo, go = tinv.value_and_grad(
        lambda p: tinv.render_loss(p, scene, c, target, spp=2, max_bounces=3,
                                   background=bg, seed=0),
        tpar.scene_params(scene))
    lk, _, gk = tdk.render_value_and_grad(scene, c, target, spp=2,
                                          max_bounces=3, background=bg,
                                          seed=0)
    return (float(lo), go), (float(lk), gk)


def test_twin_loss_matches_modular(modular_pair):
    (lo, _), (lk, _) = modular_pair
    assert abs(lo - lk) <= LOSS_RTOL * lo


@pytest.mark.parametrize("field", tpar.FLOAT_FIELDS)
def test_twin_gradient_matches_modular(modular_pair, field):
    (_, go), (_, gk) = modular_pair
    a, b = go[field].numpy(), gk[field].numpy()
    scale = max(np.abs(a).max(), 1e-8)
    assert np.abs(a - b).max() <= field_rtol(field) * scale


@pytest.mark.parametrize("surr_quad, sil", [(True, True), (False, False)])
def test_dead_bounces_add_exact_zeros(surr_quad, sil):
    """The TPU kernel replays every bounce of a sample; the CUDA kernel
    stops at the last live one. The twin both ways: bit for bit."""
    js, jc, bg = _mixed_world()
    ts, tc = to_port(js, jc)
    st = tdk.build_diff_static(ts)
    tab, _, lo = tdkp.packed_flat_table(ts, st)
    spec = tdkp.packed_spec(st, lo, sil=sil, surr_quad=surr_quad)
    cam = torch.from_numpy(scene_table.camera_vector(tc, bg)[0])
    cam[23] = float(tc.width * tc.height)
    target = torch.from_numpy(np.random.RandomState(3).rand(
        24, 32, 3).astype(np.float32))
    kw = dict(spec=spec, width=32, height=24, spp=1, max_bounces=6, seed=2)
    full = tdkp.packed_diff_reference(tab.view(-1), cam, target, **kw)
    live = tdkp.packed_diff_reference(tab.view(-1), cam, target,
                                      replay_dead=False, **kw)
    for a, b in zip(full, live):
        assert torch.equal(a, b)
