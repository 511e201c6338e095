"""The fused training objective's mesh route (diffkernel.render_value_and_
grad(mesh=), make_fused_train_step(mesh=)) on meshes of repeated CPU
devices: each cell runs the fused kernel's twin over its pixel range, the
images join and the gradient tables sum in mesh order.

Setting as tests/test_diffkernel.py:130-160: cornell_spheres 16x16,
spp=2, mb=3, seed 5, a (2 x 2) mesh. Tolerances:
  - against the port's one-device route, the JAX package's mesh
    tolerances: the loss within 1e-6 relative, the image within 1e-6, each
    gradient field within 1e-5 of its largest entry (measured: 1.1e-7,
    0.0 and at most 1.6e-7);
  - against JAX's render_value_and_grad_packed(mesh=) in interpret mode
    (one call per module): the port's cross-framework tolerances of
    tests/test_torch_diffkernel.py (LOSS_RTOL, IMG_MAX_OFF pixels beyond
    1e-5 and those within IMG_OFF_ATOL, field_rtol);
  - the twin over a pixel range against the whole-image twin: the image
    rows bit for bit, the loss and tables within TABLE_RTOL.
Torch runs single-threaded here (see tests/test_torch_intersect.py).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.ops import diffkernel_packed as jdkp
from tinyraytracer_tpu_torch.diff import inverse as tinv
from tinyraytracer_tpu_torch.ops import diffkernel as tdk
from tinyraytracer_tpu_torch.ops import diffkernel_packed as tdkp
from tinyraytracer_tpu_torch.ops import scene_table
from tinyraytracer_tpu_torch.parallel import sharded
from test_torch_diffkernel import (
    FIELDS,
    IMG_MAX_OFF,
    IMG_OFF_ATOL,
    LOSS_RTOL,
    field_rtol,
    to_port,
)

KW = dict(spp=2, max_bounces=3, seed=5)


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def fused_mesh():
    """JAX's sharded packed kernel (interpret mode), and the port's
    one-device and (2 x 2)-mesh routes, on the same inputs."""
    jw, jc, kw = jpresets.cornell_spheres(width=16, height=16)
    js = jw.build()
    ts, tc = to_port(js, jc)
    target = np.random.RandomState(1).rand(16, 16, 3).astype(np.float32) * 0.5
    bg = kw["background"]
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("tile", "sample"))
    jl, ji, jg = jdkp.render_value_and_grad_packed(
        js, jc, target, background=bg, interpret=True, tile=(8, 128),
        mesh=jmesh, **KW)
    jax_out = (float(jl), np.asarray(ji),
               {k: np.asarray(v) for k, v in jg.items()})
    mesh = sharded.make_mesh(["cpu"] * 4, sample_parallel=2)
    one = tdk.render_value_and_grad(ts, tc, target, background=bg, **KW)
    calls = []
    real = tdkp.packed_diff
    tdkp.packed_diff = lambda *a, **k: calls.append(k["pixels"]) or real(
        *a, **k)
    try:
        sharded_out = tdk.render_value_and_grad(ts, tc, target,
                                                background=bg, mesh=mesh,
                                                **KW)
    finally:
        tdkp.packed_diff = real
    return jax_out, one, sharded_out, calls


def test_mesh_route_runs_k5_once_per_cell(fused_mesh):
    *_, calls = fused_mesh
    assert calls == sharded.split_pixels(256, 4) == [(0, 64), (64, 64),
                                                     (128, 64), (192, 64)]


def test_mesh_loss_and_image_match_one_device(fused_mesh):
    _, (l1, i1, _), (lm, im, _), _ = fused_mesh
    assert abs(float(lm) - float(l1)) <= 1e-6 * abs(float(l1))
    assert im.shape == (16, 16, 3)
    assert float((im - i1).abs().max()) <= 1e-6


@pytest.mark.parametrize("field", FIELDS)
def test_mesh_gradient_matches_one_device(fused_mesh, field):
    _, (_, _, g1), (_, _, gm), _ = fused_mesh
    a, b = g1[field], gm[field]
    assert a.shape == b.shape
    scale = max(float(a.abs().max()), 1e-8)
    assert float((a - b).abs().max()) <= 1e-5 * scale


def test_mesh_loss_and_image_match_jax(fused_mesh):
    (jl, ji, _), _, (tl, ti, _), _ = fused_mesh
    assert abs(float(tl) - jl) <= LOSS_RTOL * jl
    d = np.abs(ti.numpy() - ji).max(-1)
    assert (d > 1e-5).sum() <= IMG_MAX_OFF and d.max() <= IMG_OFF_ATOL


@pytest.mark.parametrize("field", FIELDS)
def test_mesh_gradient_matches_jax(fused_mesh, field):
    (_, _, jg), _, (_, _, tg), _ = fused_mesh
    a, b = jg[field], tg[field].numpy()
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-8)
    assert np.abs(a - b).max() <= field_rtol(field) * scale


@pytest.mark.parametrize("surr_quad", [True, False])
def test_twin_on_a_pixel_range_is_its_share(surr_quad):
    """packed_diff_reference over ranges that split the mixed-material
    scene's 32x24 image (one of a single pixel, one starting mid-row), on
    the full and the sphere-only surrogate scope: the image rows bit for
    bit, and the tables and loss summed over the ranges within TABLE_RTOL
    of the whole image's (the loss keeps the whole image's scale)."""
    from test_diffkernel import _mixed_world

    js, jc, bg = _mixed_world()
    ts, tc = to_port(js, jc)
    st = tdk.build_diff_static(ts)
    tab, _, lo = tdkp.packed_flat_table(ts, st)
    spec = tdkp.packed_spec(st, lo, surr_quad=surr_quad)
    cam = torch.from_numpy(scene_table.camera_vector(tc, bg)[0])
    w, h = tc.width, tc.height
    cam[23] = float(w * h)
    target = torch.from_numpy(np.random.RandomState(3).rand(
        h, w, 3).astype(np.float32))
    kw = dict(spec=spec, width=w, height=h, spp=1, max_bounces=4, seed=2)
    whole = tdkp.packed_diff_reference(tab.view(-1), cam, target, **kw)
    rows = target.view(-1, 3)
    npix = w * h
    cuts = [(0, 37), (37, 1), (38, npix - 38)]
    parts = [tdkp.packed_diff_reference(tab.view(-1), cam,
                                        rows[b:b + n].contiguous(),
                                        pixels=(b, n), **kw)
             for b, n in cuts]
    img = torch.cat([p[0] for p in parts])
    assert torch.equal(img, whole[0].view(-1, 3))
    for k in range(1, 6):
        total = sum(p[k] for p in parts)
        scale = max(float(whole[k].abs().max()), 1e-8)
        assert float((total - whole[k]).abs().max()) <= \
            tdkp.TABLE_RTOL * scale
    with pytest.raises(ValueError, match="target"):
        tdkp.packed_diff_reference(tab.view(-1), cam, target,
                                   pixels=(0, 5), **kw)
    with pytest.raises(ValueError, match="range"):
        tdkp.packed_diff_reference(tab.view(-1), cam, rows[:5].contiguous(),
                                   pixels=(npix - 2, 5), **kw)


def test_fused_mesh_step_matches_one_device():
    """make_fused_train_step(mesh=) and fit(engine="fused", mesh=) take
    the one-device step's loss and params (tests/test_diff.py's mesh
    tolerances), on K5's twin and, with trainable_rows, K4's."""
    from tinyraytracer_tpu_torch.models import presets as tpresets

    tw, tc, kw = tpresets.cornell_spheres(width=12, height=10)
    scene = tw.build()
    target = torch.from_numpy(np.random.RandomState(2).rand(
        10, 12, 3).astype(np.float32) * 0.5)
    row = int(np.flatnonzero(scene.sph_valid.numpy())[0])
    common = dict(spp=2, max_bounces=3, background=kw["background"],
                  trainable=("sph_center", "mat_albedo"))
    mesh = sharded.make_mesh(["cpu"] * 4, sample_parallel=2)
    for rows in (None, {"sph": (row,)}):
        one, (p1, o1) = tinv.make_fused_train_step(
            scene, tc, target, device="cpu", trainable_rows=rows, **common)
        msh, (pm, om) = tinv.make_fused_train_step(
            scene, tc, target, mesh=mesh, trainable_rows=rows, **common)
        for i in range(2):
            p1, o1, l1 = one(p1, o1, i)
            pm, om, lm = msh(pm, om, i)
            assert abs(float(lm) - float(l1)) <= 1e-6 * float(l1)
        for k in p1:
            torch.testing.assert_close(pm[k], p1[k], rtol=1e-3, atol=1e-6)
    _, losses = tinv.fit(scene, tc, target, steps=1, engine="fused",
                         mesh=mesh, **common)
    assert len(losses) == 1 and np.isfinite(losses[0])
