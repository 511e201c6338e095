"""PyTorch port's classic-layout megakernel (K2) against the JAX package.

The host lowering (Morton order, compaction, payload, chunk AABBs) must
equal the JAX package's bit for bit. The port's plain twin
(`render_flat_reference`, what a CPU render runs) is held to the JAX
package's `_make_kernel` run in interpret mode, dense and row-streamed
with the chunk cull, and to the port's packed twin bit for bit. The CUDA
kernel is held to the twin on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.ops import intersect_pallas as jip
from tinyraytracer_tpu.ops import megakernel as jmk
from tinyraytracer_tpu_torch import Lambertian, Renderer, Sphere, World
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.ops import megakernel as tmk
from tinyraytracer_tpu_torch.ops import megakernel_packed as tmkp
from tinyraytracer_tpu_torch.ops import scene_table as st
from tinyraytracer_tpu_torch.ops import tonemap
from tinyraytracer_tpu_torch.utils import profiling

# Image tolerance, as tests/test_torch_megakernel.py states it for K1:
# per-pixel |d| <= ATOL on at least 1 - MAX_FRAC of the pixels, image
# means within MEAN_RTOL (sin/cos/exp/log and rsqrt differ by ulps between
# the frameworks). Measured at the size below, dense and row-streamed with
# the cull: every pixel equal (max |d| 0).
ATOL = 1e-5
MAX_FRAC = 0.05
MEAN_RTOL = 0.02

W, H, SPP, MB, SEED = 24, 16, 2, 5, 3


def _assert_image_close(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    d = np.abs(got - want).max(-1)
    assert (d > ATOL).mean() <= MAX_FRAC, f"{(d > ATOL).mean():.3%} off"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=MEAN_RTOL)
    return float(d.max())


def _random_spheres(width=W, height=H):
    return (jpresets.random_spheres(width=width, height=height, n=60),
            tpresets.random_spheres(width=width, height=height, n=60))


@pytest.mark.parametrize("morton", [False, True])
def test_flat_lowering_bitwise(morton):
    """morton_order, compact_scene(sphere_order), the payload, the chunk
    AABBs (one block width that tiles the rows, one whose tail block
    clamps its base) and lower_flat's arrays equal the JAX package's."""
    (jw, _, _), (tw, tc, tkw) = _random_spheres()
    js, ts = jw.build(), tw.build()
    a = ts.numpy()
    order = None
    if morton:
        order = st.morton_order(a["sph_center"][a["sph_valid"]])
        want = jmk._morton_order(
            np.asarray(js.sph_center)[np.asarray(js.sph_valid)])
        np.testing.assert_array_equal(order, want)
        assert not np.array_equal(order, np.arange(order.size))
    jcs = jip.compact_scene(js, sphere_order=order)
    tcs = st.compact_scene(ts, sphere_order=order)
    for f in ("sph_c", "sph_r2", "quad_n", "quad_dp", "quad_av", "quad_ca",
              "quad_bv", "quad_cb", "index_map"):
        np.testing.assert_array_equal(getattr(tcs, f),
                                      np.asarray(getattr(jcs, f)), err_msg=f)
    jpay = jmk._payload_matrix(js, jcs)
    np.testing.assert_array_equal(st.payload_matrix(ts, tcs),
                                  np.asarray(jpay))
    for chunk in (16, 24, st.ROW_CHUNK):
        for got, want in zip(st.build_chunk_aabbs(tcs, chunk),
                             jmk._build_chunk_aabbs(jcs, chunk)):
            np.testing.assert_array_equal(got, np.asarray(want))

    flat = st.lower_flat(ts, tc, tkw["background"], chunk_cull=morton)
    active, _, _ = jmk._active_payload(jcs, jpay)
    np.testing.assert_array_equal(flat.pay, np.asarray(active).T)
    np.testing.assert_array_equal(
        flat.sph, np.concatenate([jcs.sph_c, jcs.sph_r2], 1))
    np.testing.assert_array_equal(flat.quad, np.concatenate(
        [jcs.quad_n, jcs.quad_dp, jcs.quad_av, jcs.quad_ca, jcs.quad_bv,
         jcs.quad_cb], 1))
    assert (flat.n_sph, flat.n_quad, flat.pay.shape) == (60, 0, (64, 16))
    if morton:
        cmin, cmax = jmk._build_chunk_aabbs(jcs, st.ROW_CHUNK)
        np.testing.assert_array_equal(flat.aabbs[:, 0:3], np.asarray(cmin))
        np.testing.assert_array_equal(flat.aabbs[:, 4:7], np.asarray(cmax))
        assert not flat.aabbs[:, 3].any() and not flat.aabbs[:, 7].any()
    else:
        assert flat.aabbs is None


def _jax_k2(streamed: bool, spp=SPP, mb=MB, width=W,
            height=H) -> np.ndarray:
    """JAX K2 in interpret mode: the dense regen kernel, or the
    row-streamed one (16-row blocks) with the chunk cull over
    Morton-ordered rows, called as tests/test_megakernel.py calls it."""
    (jw, jc, kw), _ = _random_spheres(width, height)
    r = jmk.MegakernelRenderer(jw.build(), jc, kw["background"],
                               interpret=True, chunk_cull=streamed)
    ctl = jnp.asarray([[SEED, 0, 0, 0]], jnp.int32)
    if not streamed:
        return np.asarray(jmk._render_flat(
            r.cs, r.pay, r.cam_vec, ctl, spp=spp, max_bounces=mb,
            width=width, height=height, interpret=True, regen=True,
            has_met=r.has_met, has_die=r.has_die, sky=r.sky))
    pay_active, has_sph, has_quad = jmk._active_payload(r.cs, r.pay)
    pid, px, py, inv, _ = jmk._block_pixel_arrays(width, height, 128)
    color = jmk._run_kernel(
        r.cs, pay_active, r.cam_vec, ctl, jnp.asarray(pid), jnp.asarray(px),
        jnp.asarray(py), spp, mb, has_sph, has_quad, True, False, None, 128,
        True, r.has_met, r.has_die, sky=r.sky, row_chunk=16,
        chunk_aabbs=jmk._build_chunk_aabbs(r.cs, 16))
    return np.asarray(jnp.take(color, jnp.asarray(inv), axis=1).T.reshape(
        height, width, 3))


# The dense and the streamed kernel at the module's shape, then the edges
# of the sampler: the budget kill on the first bounce, and an odd image
# size that no block shape tiles.
@pytest.mark.parametrize("streamed, spp, mb, width, height", [
    pytest.param(False, SPP, MB, W, H, id="False"),
    pytest.param(True, SPP, MB, W, H, id="True"),
    pytest.param(False, 3, 1, 16, 12, id="False-3-1"),
    pytest.param(True, 2, 4, 13, 11, id="True-2-4-13x11"),
])
def test_twin_matches_jax_classic_kernel(streamed, spp, mb, width, height):
    want = _jax_k2(streamed, spp, mb, width, height)
    _, (tw, tc, tkw) = _random_spheres(width, height)
    r = tmk.MegakernelRenderer(tw.build(), tc, tkw["background"], "cpu",
                               chunk_cull=streamed)
    assert r.flat.n_sph + r.flat.n_quad > tmkp.PACKED_MAX_PRIMS
    got = r.render(spp=spp, max_bounces=mb, seed=SEED)
    assert got.device.type == "cpu"
    _assert_image_close(got.numpy(), want)


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box",
                                  "sphere_ground", "cornell_spheres"])
def test_flat_twin_equals_packed_twin(name):
    """K2's twin over the compacted rows equals K1's over the scene table
    bit for bit: the same sampler and hit tests over the same values, and
    the winner payload gathered by index, from a quad block that follows
    the sphere block in cornell_spheres."""
    world, camera, kw = tpresets.PRESETS[name](width=16, height=12)
    r = tmk.MegakernelRenderer(world.build(), camera, kw["background"],
                               "cpu")
    packed = r.render(spp=2, max_bounces=5, seed=3, packed=True)
    flat = r.render(spp=2, max_bounces=5, seed=3, packed=False)
    assert torch.equal(flat, packed)


def test_large_scene_routes_to_flat_twin(monkeypatch):
    """Above PACKED_MAX_PRIMS a CPU render runs K2's twin; neither launch
    counter moves, and Renderer.render gives the twin's image."""
    calls = []
    real = tmk.render_flat_reference

    def spy(*a, **k):
        calls.append(k["n_sph"])
        return real(*a, **k)

    def no_packed(*a, **k):
        raise AssertionError("the packed twin must not run")

    monkeypatch.setattr(tmk, "render_flat_reference", spy)
    monkeypatch.setattr(tmkp, "render_packed_reference", no_packed)
    before = (profiling.counter("launches.render_packed"),
              profiling.counter("launches.render_flat"))
    world, camera, kw = tpresets.random_spheres(width=12, height=8, n=60)
    img = Renderer(2, max_bounces=4, background_color=kw["background"],
                   seed=1, device="cpu").render(camera, world)
    assert calls == [60]
    assert (profiling.counter("launches.render_packed"),
            profiling.counter("launches.render_flat")) == before
    r = tmk.MegakernelRenderer(world.build(), camera, kw["background"],
                               "cpu")
    args = r.flat_args(spp=2, max_bounces=4, seed=1)
    del args["aabbs"]
    fb = real(**args)
    np.testing.assert_array_equal(
        img.data, np.maximum(fb.numpy(), 0.0) ** (1.0 / tonemap.GAMMA))


def test_auto_chunk_cull_threshold():
    """The cull (and Morton order) turns on above AUTO_CULL_ROWS padded
    active rows with at least one sphere, as the JAX package's
    auto_tile_rays(n_rows) == 0; True/False force it."""
    def world(n):
        w = World()
        w.add_material("m", Lambertian((0.5, 0.5, 0.5)))
        for i in range(n):
            w.add_geometry(Sphere((float(i % 64), float(i // 64), 0.0),
                                  0.25, "m"))
        return w.build()

    _, camera, _ = tpresets.sphere_ground(width=4, height=4)
    for n, want in ((4096, False), (4097, True)):
        r = tmk.MegakernelRenderer(world(n), camera, (0.5, 0.5, 0.5), "cpu")
        assert r.chunk_cull is want, n
        assert (jmk.auto_tile_rays(st.compact_scene(world(n)).ns) == 0) \
            is want
    small = world(60)
    assert not tmk.MegakernelRenderer(small, camera, (0, 0, 0),
                                      "cpu").chunk_cull
    forced = tmk.MegakernelRenderer(small, camera, (0, 0, 0), "cpu",
                                    chunk_cull=True)
    assert forced.chunk_cull and forced.flat.aabbs.shape == (1, 8)


def test_flat_wrapper_validates_and_counts_only_kernel_launches():
    world, camera, kw = tpresets.random_spheres(width=8, height=6, n=60)
    r = tmk.MegakernelRenderer(world.build(), camera, kw["background"],
                               "cpu", chunk_cull=True)
    args = r.flat_args(spp=1, max_bounces=2)
    before = profiling.counter("launches.render_flat")
    img = tmk.render_flat(**args)
    assert tuple(img.shape) == (6, 8, 3)
    # the twin is no launch
    assert profiling.counter("launches.render_flat") == before
    bad = [
        dict(sph=args["sph"].double()),
        dict(quad=args["quad"][:, :8].contiguous()),
        dict(pay=args["pay"][:-8].contiguous()),
        dict(cam=args["cam"][:16]),
        dict(aabbs=torch.zeros(3, 8)),
        dict(n_sph=65),
        dict(n_sph=0, n_quad=0),
        dict(spp=0),
        dict(width=1),
    ]
    for change in bad:
        with pytest.raises(ValueError):
            tmk.render_flat(**{**args, **change})
