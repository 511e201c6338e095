"""The port's mesh routes (parallel/sharded.py) for rendering and the
modular train step, on meshes of repeated CPU devices, against the port's
one-device results and the JAX package's mesh routes (tests/conftest.py
gives JAX 8 CPU devices).

Tolerances (tests/test_sharded.py, tests/test_megakernel.py:172-186 and
tests/test_diff.py:114-131 state them for the JAX package):
  - a tile-only mesh gives the one-device image bit for bit (the counter
    RNG keys on global pixel and sample ids), for the modular tracer and
    for both megakernel twins, also at an uneven pixel count (23x17);
  - a sample split changes only the sample mean's summation order:
    within atol 1e-6;
  - the port's sharded image against JAX's on the same mesh shape: the
    port's one-device tolerance against JAX (tests/test_torch_trace.py,
    IMG_ATOL on all but IMG_MAX_FRAC of the pixels, means within
    IMG_MEAN_RTOL);
  - the modular mesh step against the one-device step: the loss within
    1e-5, the params within rtol 1e-3, atol 1e-6; against JAX's mesh
    step: the port's one-device step tolerances (tests/test_torch_diff.py:
    the loss within LOSS_RTOL, each param's move within STEP_ATOL;
    measured 7.2e-6 relative on the loss, as on one device).
Torch runs single-threaded here (see tests/test_torch_intersect.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.diff import inverse as jinv
from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.parallel import sharded as jsharded
from tinyraytracer_tpu_torch import Renderer
from tinyraytracer_tpu_torch.diff import inverse as tinv
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.ops import megakernel as tmk
from tinyraytracer_tpu_torch.ops import megakernel_packed as tmkp
from tinyraytracer_tpu_torch.ops import trace as ttr
from tinyraytracer_tpu_torch.parallel import sharded
from test_torch_diff import LOSS_RTOL, STEP_ATOL
from test_torch_trace import IMG_ATOL, IMG_MAX_FRAC, IMG_MEAN_RTOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
TRAINABLE = ("sph_center", "mat_albedo")


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cornell_small():
    world, camera, kw = tpresets.cornell_box(width=24, height=20)
    scene = world.build()
    ref = ttr.render_image(scene, camera, spp=4, max_bounces=4,
                           background=torch.tensor(kw["background"]), seed=0)
    return scene, camera, kw, ref


def _render(scene, camera, kw, mesh, spp=4, mb=4, seed=0):
    return sharded.render_image_sharded(
        scene, camera, spp=spp, max_bounces=mb, background=kw["background"],
        seed=seed, mesh=mesh)


def test_tile_sharding_bitwise_equal(cornell_small):
    scene, camera, kw, ref = cornell_small
    img = _render(scene, camera, kw, sharded.make_mesh(CPU8))
    assert torch.equal(img, ref)


@pytest.mark.parametrize("sample_parallel", [2, 4])
def test_sample_sharding_within_rounding(cornell_small, sample_parallel):
    scene, camera, kw, ref = cornell_small
    mesh = sharded.make_mesh(CPU8, sample_parallel=sample_parallel)
    assert mesh.shape == {"tile": 8 // sample_parallel,
                          "sample": sample_parallel}
    img = _render(scene, camera, kw, mesh)
    torch.testing.assert_close(img, ref, rtol=0, atol=1e-6)


def test_uneven_pixel_count_splits_correctly():
    world, camera, kw = tpresets.cornell_box(width=23, height=17)
    scene = world.build()            # 391 pixels = 8 x 48 + 7
    ref = ttr.render_image(scene, camera, spp=2, max_bounces=3,
                           background=torch.tensor(kw["background"]), seed=5)
    img = _render(scene, camera, kw, sharded.make_mesh(CPU8), spp=2, mb=3,
                  seed=5)
    assert torch.equal(img, ref)
    ranges = sharded.split_pixels(391, 8)
    assert {n for _, n in ranges} == {48, 49}
    assert ranges[0][0] == 0 and sum(n for _, n in ranges) == 391
    assert all(a + n == b for (a, n), (b, _) in zip(ranges, ranges[1:]))


def test_sharded_image_matches_jax():
    """The port's render_image_sharded against JAX's on a (4 x 2) mesh, at
    tests/test_torch_megakernel.py's Cornell size. At 24x20 spp=4 three
    of 480 pixels sit on the light/ceiling z-fight edge and flip between
    the frameworks (measured; the image mean then moves 2.04 %), on one
    device as on the mesh: the port's sharded image equals its one-device
    image (the tests above)."""
    jw, jc, kw = jpresets.cornell_box(width=16, height=12)
    want = np.asarray(jsharded.render_image_sharded(
        jw.build(), jc, spp=4, max_bounces=4, background=kw["background"],
        seed=0, mesh=jsharded.make_mesh(sample_parallel=2)))
    tw, tc, tkw = tpresets.cornell_box(width=16, height=12)
    got = _render(tw.build(), tc, tkw,
                  sharded.make_mesh(CPU8, sample_parallel=2)).numpy()
    bad = np.abs(got - want).max(-1) > IMG_ATOL
    assert bad.mean() <= IMG_MAX_FRAC
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=IMG_MEAN_RTOL)


def test_renderer_sample_parallel_wiring(cornell_small):
    """Renderer(devices=, sample_parallel=) reaches the mesh: a (4 tile x
    2 sample) mesh through the public API, on the modular route and on
    the megakernel's, in the batch and the progress-bar paths (rounds of
    2 samples, a multiple of the sample axis)."""
    scene, camera, kw, ref = cornell_small
    mk_ref = tmk.MegakernelRenderer(scene, camera, kw["background"],
                                    "cpu").render(spp=4, max_bounces=4)
    for accelerator, want in (("none", ref), ("auto", mk_ref)):
        for progressbar in (False, True):
            r = Renderer(4, max_bounces=4, background_color=kw["background"],
                         seed=0, devices=CPU8, sample_parallel=2,
                         progressbar=progressbar, spp_per_round=3,
                         accelerator=accelerator)
            assert r.device == torch.device("cpu")
            if progressbar:
                img = r._render_with_progress(camera, scene)
            else:
                img = r.render_array(camera, scene)
            torch.testing.assert_close(img, want, rtol=0, atol=1e-6)
    frames = r.render_batch(camera, scene, [0, 1])
    assert len(frames) == 2 and frames[0].data.shape == (20, 24, 3)


@pytest.mark.parametrize("route", ["packed", "flat"])
def test_megakernel_twins_sharded_match_single(route):
    """MegakernelRenderer.render(mesh=) on the twins of K1 (three_spheres)
    and K2 (random_spheres, 60 spheres): tile-only bit for bit, a sample
    split within atol 1e-6, and an uneven tile split (23x17, 8 tiles) bit
    for bit."""
    name, pkw = (("three_spheres", {}) if route == "packed"
                 else ("random_spheres", dict(n=60)))
    for w, h in ((16, 12), (23, 17)):
        world, camera, kw = tpresets.PRESETS[name](width=w, height=h, **pkw)
        r = tmk.MegakernelRenderer(world.build(), camera, kw["background"],
                                   "cpu")
        assert (r.n_sph + r.n_quad <= tmkp.PACKED_MAX_PRIMS) == (
            route == "packed")
        ref = r.render(spp=4, max_bounces=3, seed=5)
        tile_only = r.render(spp=4, max_bounces=3, seed=5,
                             mesh=sharded.make_mesh(CPU8))
        assert torch.equal(tile_only, ref)
        split = r.render(spp=4, max_bounces=3, seed=5,
                         mesh=sharded.make_mesh(CPU8, sample_parallel=2))
        torch.testing.assert_close(split, ref, rtol=0, atol=1e-6)


def test_twins_on_a_pixel_range_equal_the_image_rows():
    """A forward twin over a range of flat pixel ids gives those rows of
    the whole image bit for bit (ranges starting mid-row, of one pixel,
    and the whole image), and refuses ranges outside the image."""
    world, camera, kw = tpresets.three_spheres(width=13, height=7)
    r = tmk.MegakernelRenderer(world.build(), camera, kw["background"],
                               "cpu")
    low = r.lowered
    args = dict(n_sph=low.n_sph, n_quad=low.n_quad, width=13, height=7,
                spp=3, max_bounces=3, seed=2, spp_offset=5,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky)
    whole = tmkp.render_packed(r.table, r.cam, **args).reshape(-1, 3)
    flat = r.flat_args(spp=3, max_bounces=3, seed=2, spp_offset=5)
    flat.pop("pixels")
    for b, n in ((0, 91), (5, 17), (90, 1), (40, 13)):
        got = tmkp.render_packed(r.table, r.cam, pixels=(b, n), **args)
        assert got.shape == (n, 3) and torch.equal(got, whole[b:b + n])
        got = tmk.render_flat(pixels=(b, n), **flat)
        assert torch.equal(got, whole[b:b + n])
    for bad in ((-1, 4), (0, 0), (80, 12)):
        with pytest.raises(ValueError, match="range"):
            tmkp.render_packed(r.table, r.cam, pixels=bad, **args)
        with pytest.raises(ValueError, match="range"):
            tmk.render_flat(pixels=bad, **flat)


@pytest.fixture(scope="module")
def step_scene():
    jw, jc, kw = jpresets.cornell_spheres(width=8, height=8)
    tw, tc, _ = tpresets.cornell_spheres(width=8, height=8)
    target = np.random.RandomState(0).uniform(0, 0.3, (8, 8, 3)).astype(
        np.float32)
    return jw.build(), jc, tw.build(), tc, kw["background"], target


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_modular_mesh_step_matches_single_device(step_scene, shape):
    _, _, ts, tc, bg, target = step_scene
    kw = dict(spp=4, max_bounces=4, background=bg, seed=3,
              trainable=TRAINABLE, use_kernel=True)
    mesh = sharded.make_mesh(["cpu"] * 4, sample_parallel=shape[1])
    assert mesh.shape == {"tile": shape[0], "sample": shape[1]}
    s1, (p1, o1) = tinv.make_train_step(ts, tc, target, device="cpu", **kw)
    sm, (pm, om) = tinv.make_train_step(ts, tc, target, mesh=mesh, **kw)
    for i in range(2):
        p1, o1, l1 = s1(p1, o1, i)
        pm, om, lm = sm(pm, om, i)
        assert abs(float(l1) - float(lm)) < 1e-5 * max(1.0, abs(float(l1)))
    for k in p1:
        torch.testing.assert_close(pm[k], p1[k], rtol=1e-3, atol=1e-6)
    assert float((pm["sph_center"] - ts.sph_center).abs().max()) > 0
    with pytest.raises(ValueError, match="single-device"):
        tinv.make_train_step(ts, tc, target, mesh=mesh, grad_chunks=2, **kw)


def test_modular_mesh_step_matches_jax(step_scene):
    """One step of make_train_step(mesh=) on a (2 x 2) mesh against the
    JAX package's on the same mesh shape (use_kernel=False there; the
    port selects with K3's twin)."""
    js, jc, ts, tc, bg, target = step_scene
    kw = dict(spp=4, max_bounces=4, background=bg, seed=3,
              trainable=TRAINABLE, learning_rate=1e-2)
    jstep, (jp, jo) = jinv.make_train_step(
        js, jc, jnp.asarray(target), use_kernel=False,
        mesh=jsharded.make_mesh(jax.devices()[:4], sample_parallel=2), **kw)
    jp0 = {k: np.asarray(v) for k, v in jp.items()}
    jp, jo, jloss = jstep(jp, jo, 0)
    mesh = sharded.make_mesh(["cpu"] * 4, sample_parallel=2)
    step, (p, o) = tinv.make_train_step(ts, tc, target, mesh=mesh,
                                        use_kernel=True, **kw)
    p, o, loss = step(p, o, 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for k in p:
        np.testing.assert_allclose(p[k].numpy() - jp0[k],
                                   np.asarray(jp[k]) - jp0[k], rtol=0,
                                   atol=STEP_ATOL, err_msg=k)
    assert np.abs(np.asarray(jp["sph_center"]) - jp0["sph_center"]).max() \
        > 5e-3


def test_make_mesh_checks_devices(monkeypatch):
    """No device list takes every CUDA device and raises without CUDA;
    a CUDA device the machine lacks raises (no quiet CPU fallback), and
    so do mixed device types and a sample axis that does not divide."""
    with pytest.raises(ValueError, match="divisible"):
        sharded.make_mesh(["cpu"] * 3, sample_parallel=2)
    with pytest.raises(ValueError, match="unsupported"):
        sharded.make_mesh(["cpu", "meta"])
    with pytest.raises(ValueError):
        sharded.split_pixels(3, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.make_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(4, devices=["cuda:0", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="does not exist"):
        sharded.make_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="all be CUDA or all CPU"):
        sharded.make_mesh(["cpu", "cuda:0"])


def test_sharded_module_imports_no_jax():
    """With jax unimportable, the mesh module imports and renders a
    (2 x 2) CPU mesh, and no JAX module gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from tinyraytracer_tpu_torch.parallel import sharded\n"
        "from tinyraytracer_tpu_torch.models import presets\n"
        "w, c, kw = presets.cornell_box(width=6, height=4)\n"
        "m = sharded.make_mesh(['cpu'] * 4, sample_parallel=2)\n"
        "img = sharded.render_image_sharded(w.build(), c, spp=2,\n"
        "    max_bounces=2, background=kw['background'], mesh=m)\n"
        "assert img.shape == (4, 6, 3) and bool(torch.isfinite(img).all())\n"
        "bad = [m for m in sys.modules if m == 'tinyraytracer_tpu' or "
        "m.startswith(('tinyraytracer_tpu.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
