"""CUDA kernels of the PyTorch port against their plain twins, on the card.

Every test here carries the `cuda` marker and skips where there is no
CUDA device. This file imports neither JAX nor the JAX package, so it
also runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -o addopts= -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import intersect_kernel as ik
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
from tinyraytracer_tpu_torch.ops import trace as trace_ops
from torch_k3_scenes import k3_world

# Kernel vs twin on one card. Both use the card's sinf/cosf/expf/logf,
# IEEE sqrt and division, and no FMA contraction (the kernel is built
# with --fmad=false; the twin runs one operation per launch), so most
# pixels agree exactly. A pixel may still differ where a path crosses a
# discrete edge after a last-bit difference, so a bounded fraction may.
ATOL = 1e-5
MAX_FRAC = 0.01
MEAN_RTOL = 1e-3
SCENES = ["sphere_ground", "three_spheres", "cornell_box", "five_quads",
          "rtiow_sky"]
# K2 scenes: (preset, preset kwargs, forced onto K2 below 49 primitives)
FLAT_SCENES = [("random_spheres", dict(n=500), False),
               ("random_spheres", dict(n=8000), False),
               ("three_spheres", {}, True), ("cornell_box", {}, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_packed_kernel_matches_twin(cuda, name):
    """64x48 spp=4, max_bounces up to 8: the same check as the parity
    phase of chip_smoke.py."""
    world, camera, kw = presets.PRESETS[name](width=64, height=48)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    low = r.lowered
    args = dict(n_sph=low.n_sph, n_quad=low.n_quad, width=64, height=48,
                spp=4, max_bounces=min(kw["max_bounces"], 8), seed=3,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky)
    before = mkp.render_packed.launches
    got = mkp.render_packed(r.table, r.cam, **args)
    torch.cuda.synchronize()
    assert mkp.render_packed.launches == before + 1
    want = mkp.render_packed_reference(r.table, r.cam, **args)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == (48, 64, 3) and np.isfinite(got).all()
    bad = np.abs(got - want).max(-1) > ATOL
    assert bad.mean() <= MAX_FRAC, f"{bad.mean():.3%} of pixels off"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=MEAN_RTOL)


@pytest.mark.cuda
def test_renderer_on_cuda_launches_kernel(cuda):
    from tinyraytracer_tpu_torch import Renderer

    world, camera, kw = presets.cornell_box(width=32, height=32)
    before = mkp.render_packed.launches
    img = Renderer(4, max_bounces=4, background_color=kw["background"],
                   device=cuda).render(camera, world)
    assert mkp.render_packed.launches == before + 1
    assert img.data.shape == (32, 32, 3) and np.isfinite(img.data).all()


def _assert_close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = np.abs(got - want).max(-1) > ATOL
    assert bad.mean() <= MAX_FRAC, f"{bad.mean():.3%} of pixels off"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=MEAN_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name, pkw, forced", FLAT_SCENES)
def test_flat_kernel_matches_twin(cuda, name, pkw, forced):
    """K2 at 64x48 spp=4 against its twin (culled at 8000 spheres); on
    the forced small scenes also bit for bit against K1."""
    world, camera, kw = presets.PRESETS[name](width=64, height=48, **pkw)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    assert r.chunk_cull == (pkw.get("n") == 8000)
    args = r.flat_args(spp=4, max_bounces=min(kw["max_bounces"], 8), seed=3)
    before = mk.render_flat.launches
    got = mk.render_flat(**args)
    torch.cuda.synchronize()
    assert mk.render_flat.launches == before + 1
    del args["aabbs"]
    _assert_close(got, mk.render_flat_reference(**args))
    if forced:
        k1 = r.render(spp=4, max_bounces=args["max_bounces"], seed=3,
                      packed=True)
        assert torch.equal(got, k1)


# Edges of the sampler, as chip_smoke.py phase 3: the budget kill on the
# first bounce, an odd sample count at an offset, and partial blocks.
EDGE_SHAPES = [pytest.param(64, 48, dict(max_bounces=1), id="mb1"),
               pytest.param(64, 48, dict(spp=7, spp_offset=3),
                            id="spp7-offset3"),
               pytest.param(61, 37, {}, id="61x37")]


@pytest.mark.cuda
@pytest.mark.parametrize("width, height, change", EDGE_SHAPES)
@pytest.mark.parametrize("name", ["three_spheres", "cornell_box"])
def test_packed_kernel_edge_shapes_bitwise(cuda, name, width, height,
                                           change):
    """K1 against its twin bit for bit at the sampler's edges, and two
    launches bit for bit."""
    world, camera, kw = presets.PRESETS[name](width=width, height=height)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    low = r.lowered
    args = dict(n_sph=low.n_sph, n_quad=low.n_quad, width=width,
                height=height, spp=4, max_bounces=8, seed=3,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky)
    args.update(change)
    got = mkp.render_packed(r.table, r.cam, **args)
    assert torch.equal(got, mkp.render_packed(r.table, r.cam, **args))
    assert torch.equal(got, mkp.render_packed_reference(r.table, r.cam,
                                                        **args))


@pytest.mark.cuda
@pytest.mark.parametrize("width, height, change", EDGE_SHAPES)
@pytest.mark.parametrize("n", [500, 8000])
def test_flat_kernel_edge_shapes_bitwise(cuda, n, width, height, change):
    """K2 (dense at 500 spheres, culled at 8000) against its twin bit for
    bit at the sampler's edges, and two launches bit for bit."""
    world, camera, kw = presets.random_spheres(width=width, height=height,
                                               n=n)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    args = r.flat_args(spp=4, max_bounces=8, seed=3)
    args.update(change)
    got = mk.render_flat(**args)
    assert torch.equal(got, mk.render_flat(**args))
    del args["aabbs"]
    assert torch.equal(got, mk.render_flat_reference(**args))


@pytest.mark.cuda
@pytest.mark.parametrize("name, pkw", [("cornell_box", {}),
                                       ("random_spheres", dict(n=500))])
def test_kernels_equal_twins_on_each_side_of_the_sample_split(cuda, name,
                                                              pkw):
    """K1 (cornell_box) and K2 (500 spheres) at 512 pixels wide, on the
    last image height under one wave of the card, where each pixel's
    samples are split over threads and folded in sample order, and one
    block row taller, where they are not: bit for bit equal to the twin."""
    from tinyraytracer_tpu_torch import _build

    lib = _build.load()
    width, spp = 512, 4

    def renderer(height):
        world, camera, kw = presets.PRESETS[name](width=width, height=height,
                                                  **pkw)
        return mk.MegakernelRenderer(world.build(), camera, kw["background"],
                                     cuda)

    r = renderer(8)
    low, f = r.lowered, r.flat
    if name == "cornell_box":
        split = lambda h: lib.tinyrt_megakernel_packed_split(  # noqa: E731
            low.table.size, width, h, spp, int(low.has_met),
            int(low.has_die), int(low.sky))
    else:
        split = lambda h: lib.tinyrt_megakernel_flat_split(  # noqa: E731
            width, h, spp, int(f.has_met), int(f.has_die), int(f.sky))
    height = 8
    while split(height) > 1:
        height += 8
    assert height > 8 and split(height - 8) > 1
    for h in (height - 8, height):
        r = renderer(h)
        packed = name == "cornell_box"
        got = r.render(spp=spp, max_bounces=8, seed=3, packed=packed)
        if packed:
            low = r.lowered
            want = mkp.render_packed_reference(
                r.table, r.cam, n_sph=low.n_sph, n_quad=low.n_quad,
                width=width, height=h, spp=spp, max_bounces=8, seed=3,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky)
        else:
            args = r.flat_args(spp=spp, max_bounces=8, seed=3)
            del args["aabbs"]
            want = mk.render_flat_reference(**args)
        assert torch.equal(got, want), h


@pytest.mark.cuda
def test_culled_flat_kernel_equals_unculled(cuda):
    world, camera, kw = presets.random_spheres(width=96, height=54, n=8000)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    args = r.flat_args(spp=4, max_bounces=16, seed=1)
    culled = mk.render_flat(**args)
    assert torch.equal(culled, mk.render_flat(**{**args, "aabbs": None}))


@pytest.mark.cuda
@pytest.mark.parametrize("name, pkw", [("sphere_ground", {}),
                                       ("random_spheres", dict(n=500))])
def test_batch_and_async_on_cuda(cuda, name, pkw):
    from tinyraytracer_tpu_torch import Renderer

    world, camera, kw = presets.PRESETS[name](width=48, height=32, **pkw)
    r = Renderer(2, max_bounces=4, background_color=kw["background"],
                 seed=0, device=cuda)
    frames = r.render_batch(camera, world, [2, 9])
    r.seed = 9
    single = r.render(camera, world).data
    np.testing.assert_array_equal(frames[1].data, single)
    handle = r.render_async(camera, world)
    np.testing.assert_array_equal(handle.result().data, single)
    assert handle.done()


@pytest.mark.cuda
def test_flat_kernel_refuses_misaligned_rows(cuda):
    """The kernel reads rows as float4: a row array that starts off a
    16-byte boundary is refused before launch."""
    world, camera, kw = presets.random_spheres(width=16, height=12, n=60)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    args = r.flat_args(spp=1, max_bounces=2)
    sph = args["sph"]
    shifted = torch.empty(sph.numel() + 1, device=cuda)[1:].view(sph.shape)
    shifted.copy_(sph)
    before = mk.render_flat.launches
    with pytest.raises(ValueError, match="aligned"):
        mk.render_flat(**{**args, "sph": shifted})
    assert mk.render_flat.launches == before


class _RayCapture:
    """A selection tape keeping every ray batch trace selects for."""

    def __init__(self):
        self.rays = []

    def __call__(self, select, o, d, need_j=True):
        self.rays.append((o.clone(), d.clone()))
        return select(o, d)


@pytest.mark.cuda
@pytest.mark.parametrize("name, pkw", [("cornell_box", {}),
                                       ("random_spheres", dict(n=500))])
def test_closest_hit_kernel_equals_twin(cuda, name, pkw):
    """K3 against its twin, bit for bit on t and j: primary rays and the
    shadow and scattered rays of a traced bounce (as chip_smoke.py
    phase 8)."""
    world, camera, kw = presets.PRESETS[name](width=32, height=24, **pkw)
    scene = world.build().to(cuda)
    cs = ik.compact_rows(scene, cuda)
    pid, sid = trace_ops.round_ids(torch.arange(32 * 24, device=cuda), 2, 0)
    o, d = generate_rays(camera.to(cuda), pid, sid, 3)
    cap = _RayCapture()
    with torch.no_grad():
        trace_ops.trace(scene, o, d, pid, sid, 3, 2, kw["background"],
                        compact=ik.compact_rows(scene, cuda, plain=True),
                        nee=True, tape=cap)
    assert len(cap.rays) == 4
    for ro, rd in cap.rays:
        before = ik.closest_hit.launches
        t, j = ik.closest_hit(cs, ro, rd)
        torch.cuda.synchronize()
        assert ik.closest_hit.launches == before + 1
        t_r, j_r = ik.closest_hit_reference(cs, ro, rd)
        assert torch.equal(t, t_r) and torch.equal(j, j_r)


def _k3_routes(cs):
    """The scene's routes: the parameter bank where it fits, and always
    the global rows."""
    import dataclasses
    glob = dataclasses.replace(cs, bank=None)
    return [cs, glob] if cs.bank is not None else [glob]


def _k3_bitwise(cs, o, d):
    """K3 through each route, (t, j) and t-only, launched twice: t and j
    bit for bit with the twin and with the other launch. Returns the
    twin's j."""
    t_r, j_r = ik.closest_hit_reference(cs, o, d)
    for c in _k3_routes(cs):
        for need_j in (True, False):
            runs = []
            for _ in range(2):
                before = ik.closest_hit.launches
                runs.append(ik.closest_hit(c, o, d, need_j))
                torch.cuda.synchronize()
                assert ik.closest_hit.launches == before + (o.shape[0] > 0)
            for t, j in runs:
                assert torch.equal(t, t_r), (c.route, need_j)
                if need_j:
                    assert torch.equal(j, j_r), c.route
                else:
                    assert j is None
    return j_r


def _k3_wavefronts(cuda, scene, camera, kw):
    """Primary rays and the shadow, scattered and shadow rays of a traced
    bounce (32x24, 2 samples)."""
    pid, sid = trace_ops.round_ids(torch.arange(32 * 24, device=cuda), 2, 0)
    o, d = generate_rays(camera.to(cuda), pid, sid, 3)
    cap = _RayCapture()
    with torch.no_grad():
        trace_ops.trace(scene, o, d, pid, sid, 3, 2, kw["background"],
                        compact=ik.compact_rows(scene, cuda, plain=True),
                        nee=True, tape=cap)
    return cap.rays


@pytest.mark.cuda
@pytest.mark.parametrize("name, n, extra, coincident", [
    ("cornell_box", None, 0, False),          # no spheres
    ("random_spheres", 48, 0, False),         # no quads, the bank's limit
    ("random_spheres", 49, 0, False),         # one row over
    ("cornell_box", None, 30, False),         # 18 quads + 30: the limit
    ("cornell_box", None, 31, False),         # one row over
    ("sphere_ground", None, 0, True),         # two coincident spheres
])
def test_closest_hit_edge_scenes_on_both_routes(cuda, name, n, extra,
                                                coincident):
    """K3's edge scenes through the parameter bank and the global rows,
    (t, j) and t-only: bit for bit with the twin, launches repeatable; a
    scene of at most 48 real rows takes the bank, one more the global
    route; of two coincident spheres the first row wins every tie."""
    world, camera, kw = k3_world(name, n, extra, coincident)
    scene = world.build().to(cuda)
    cs = ik.compact_rows(scene, cuda)
    rows = cs.n_sph + cs.n_quad
    assert cs.route == ("bank" if rows <= ik.BANK_MAX_ROWS else "global")
    assert rows in (18, 48, 49, 3)
    for i, (ro, rd) in enumerate(_k3_wavefronts(cuda, scene, camera, kw)):
        j = _k3_bitwise(cs, ro, rd)
        if coincident:
            sph, im = cs.sph[:cs.n_sph].cpu(), cs.index_map.cpu()
            a, b = next((a, b) for a in range(cs.n_sph)
                        for b in range(a + 1, cs.n_sph)
                        if torch.equal(sph[a], sph[b]))
            assert not (j == int(im[b])).any()
            if i == 0:                  # the camera sees the sphere
                assert (j == int(im[a])).any()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 1, 31, 33, 127, 129, 389])
def test_closest_hit_ray_counts(cuda, r):
    """Ray counts around a warp and K3's block of 128 (csrc/closest_hit.cu
    kThreads), bit for bit on both routes and t-only (cornell_spheres'
    scattered rays)."""
    world, camera, kw = presets.cornell_spheres(width=32, height=24)
    scene = world.build().to(cuda)
    cs = ik.compact_rows(scene, cuda)
    ro, rd = _k3_wavefronts(cuda, scene, camera, kw)[2]
    _k3_bitwise(cs, ro[:r], rd[:r])


@pytest.mark.cuda
def test_closest_hit_strided_rays_and_t_only(cuda):
    """(R, 3) views of an (R, 6) array and (3, R).T views give the
    contiguous rays' bits; the t-only launch gives the full launch's t,
    j None, and counts as one launch."""
    world, camera, kw = presets.cornell_spheres(width=32, height=24)
    scene = world.build().to(cuda)
    cs = ik.compact_rows(scene, cuda)
    assert cs.route == "bank"
    ro, rd = _k3_wavefronts(cuda, scene, camera, kw)[1]
    wide = torch.cat([ro, rd], 1)
    _k3_bitwise(cs, wide[:, :3], wide[:, 3:])
    _k3_bitwise(cs, ro.t().contiguous().t(), rd.t().contiguous().t())
    t, j = ik.closest_hit(cs, ro, rd)
    before = ik.closest_hit.launches
    t1, j1 = ik.closest_hit(cs, ro, rd, need_j=False)
    torch.cuda.synchronize()
    assert ik.closest_hit.launches == before + 1 and j1 is None
    assert torch.equal(t, t1)


@pytest.mark.cuda
def test_train_step_kernel_equals_twin_and_counts_launches(cuda):
    """One modular train step (32x32 spp=2 mb=4) with K3 selection and
    with the twin's: loss and params bit for bit; K3 launched
    2 x bounces x rounds times, and not at all on the twin run."""
    from tinyraytracer_tpu_torch.diff import inverse

    world, camera, kw = presets.cornell_spheres(width=32, height=32)
    scene = world.build()
    target = torch.zeros((32, 32, 3))
    step, (p0, o0) = inverse.make_train_step(
        scene, camera, target, spp=2, max_bounces=4,
        background=kw["background"], trainable=("sph_center", "mat_albedo"),
        device=cuda)
    assert step.__defaults__[0] is not None          # K3 by default
    plain = ik.compact_rows(scene.to(cuda), cuda, plain=True)
    before = ik.closest_hit.launches
    pk, _, lk = step(p0, o0, 0)
    torch.cuda.synchronize()
    assert ik.closest_hit.launches == before + 2 * 4 * 1
    pt, _, lt = step(p0, o0, 0, plain)
    torch.cuda.synchronize()
    assert ik.closest_hit.launches == before + 8
    assert torch.equal(lk, lt)
    for k in pk:
        assert torch.equal(pk[k], pt[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed", "cornell_spheres"])
@pytest.mark.parametrize("flags", [{}, dict(surr_quad=False),
                                   dict(surr_quad=False, sil=False)])
def test_diff_kernel_matches_twin(cuda, name, flags):
    """K5 (32x24 spp=2 mb=5) against its twin, as chip_smoke.py phase 12:
    every surrogate scope and the silhouette off; the image bit for bit,
    the loss and gradient tables within TABLE_RTOL of each table's largest
    entry (measured on the H100: at most 2e-7), two launches bit for
    bit."""
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    maker = (presets.mixed_materials if name == "mixed"
             else presets.cornell_spheres)
    world, camera, kw = maker(width=32, height=24)
    scene, bg = world.build(), kw["background"]
    target = torch.from_numpy(np.random.RandomState(0).rand(
        24, 32, 3).astype(np.float32))
    _, tab, cam, tgt, spec = dkp._inputs(
        scene.to(cuda), camera, target, bg, None, True,
        flags.get("sil", True), True, flags.get("surr_quad", True))
    kw = dict(spec=spec, width=32, height=24, spp=2, max_bounces=5, seed=3)
    before = dkp.packed_diff.launches
    got = dkp.packed_diff(tab, cam, tgt, **kw)
    again = dkp.packed_diff(tab, cam, tgt, **kw)
    torch.cuda.synchronize()
    assert dkp.packed_diff.launches == before + 2
    want = dkp.packed_diff_reference(tab, cam, tgt, **kw)
    assert torch.equal(got[0], want[0])
    for a, b, c in zip(got, want, again):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= dkp.TABLE_RTOL * scale


@pytest.mark.cuda
def test_fused_train_step_runs_on_k5(cuda):
    """One fused step on the card: one K5 launch, finite params, and the
    untrained fields unmoved."""
    from tinyraytracer_tpu_torch.diff import inverse
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    world, camera, kw = presets.cornell_spheres(width=32, height=32)
    scene = world.build()
    step, (p0, o0) = inverse.make_fused_train_step(
        scene, camera, torch.zeros((32, 32, 3)), spp=2, max_bounces=4,
        background=kw["background"], trainable=("sph_center", "mat_albedo"),
        device=cuda)
    before = dkp.packed_diff.launches
    p1, _, loss = step(p0, o0, 0)
    torch.cuda.synchronize()
    assert dkp.packed_diff.launches == before + 1
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(v).all()) for v in p1.values())
    assert torch.equal(p1["quad_corner"], p0["quad_corner"])
    assert not torch.equal(p1["mat_albedo"], p0["mat_albedo"])


def _lit_spheres(n, width, height):
    """random_spheres with a lamp quad above it (examples/manysphere_fit
    .py's scene): many spheres under a light, so the soft shadows run."""
    from tinyraytracer_tpu_torch.models.geometry import Quad
    from tinyraytracer_tpu_torch.models.materials import Light

    world, camera, kw = presets.random_spheres(width=width, height=height,
                                               n=n)
    world.add_material("lamp", Light((12.0, 12.0, 12.0)))
    world.add_geometry(Quad((-4.0, 11.99, -4.0), (8.0, 0.0, 0.0),
                            (0.0, 0.0, 8.0), "lamp"))
    return world.build(), camera, (0.01, 0.01, 0.015)


def _k4_check(dkp, got, want, again):
    """K4 against its twin: the image bit for bit, each table within
    TABLE_RTOL of its largest entry, two launches bit for bit."""
    assert torch.equal(got[0], want[0])
    for a, b, c in zip(got, want, again):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= dkp.TABLE_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["dense", "subset", "off"])
def test_classic_diff_kernel_matches_twin(cuda, scope):
    """K4 (random_spheres n=40 under a lamp, 32x24 spp=2 mb=4) against
    its twin with every kind of surrogate scope, as chip_smoke.py phase
    15; the launch counter rises once per launch."""
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    scene, camera, bg = _lit_spheres(40, 32, 24)
    n_sph = int(scene.sph_valid.sum())
    surr = {"dense": True, "subset": (0, 5, n_sph - 1), "off": False}[scope]
    target = torch.from_numpy(np.random.RandomState(0).rand(
        24, 32, 3).astype(np.float32))
    _, tab, cam, tgt, spec = dkp._inputs(scene.to(cuda), camera, target, bg,
                                         None, True, True, surr, True)
    kw = dict(spec=spec, width=32, height=24, spp=2, max_bounces=4, seed=3)
    before = dk.classic_diff.launches
    got = dk.classic_diff(tab, cam, tgt, **kw)
    again = dk.classic_diff(tab, cam, tgt, **kw)
    torch.cuda.synchronize()
    assert dk.classic_diff.launches == before + 2
    _k4_check(dkp, got, dkp.packed_diff_reference(tab, cam, tgt, **kw),
              again)


@pytest.mark.cuda
def test_classic_diff_kernel_equals_packed_on_mixed(cuda):
    """On the mixed-material scene forced onto K4, K4 equals K5: the
    image bit for bit, the tables within TABLE_RTOL (another summation
    order)."""
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    world, camera, kw = presets.mixed_materials(width=32, height=24)
    target = torch.from_numpy(np.random.RandomState(0).rand(
        24, 32, 3).astype(np.float32))
    for surr_quad in (True, False):
        _, tab, cam, tgt, spec = dkp._inputs(
            world.build().to(cuda), camera, target, kw["background"], None,
            True, True, True, surr_quad)
        args = dict(spec=spec, width=32, height=24, spp=2, max_bounces=5,
                    seed=3)
        k4 = dk.classic_diff(tab, cam, tgt, **args)
        k5 = dkp.packed_diff(tab, cam, tgt, **args)
        assert torch.equal(k4[0], k5[0])
        for a, b in zip(k4[1:], k5[1:]):
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= dkp.TABLE_RTOL * scale


def _fused_inputs(dkp, scene, camera, bg, nee=True, sil=True, surr_sph=True,
                  surr_quad=True, device="cuda"):
    target = torch.from_numpy(np.random.RandomState(0).rand(
        camera.height, camera.width, 3).astype(np.float32))
    _, tab, cam, tgt, spec = dkp._inputs(scene.to(device), camera, target, bg,
                                         None, nee, sil, surr_sph, surr_quad)
    return tab, cam, tgt, spec


def _fused_run(kernel, tab, cam, tgt, kw):
    """Two launches of K5 or K4 and the twin: (got, again, want)."""
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    fn = dkp.packed_diff if kernel == "K5" else dk.classic_diff
    before = fn.launches
    got = fn(tab, cam, tgt, **kw)
    again = fn(tab, cam, tgt, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    return got, again, dkp.packed_diff_reference(tab, cam, tgt, **kw)


# Edge shapes of the fused kernels' loops: (label, width, height, launch
# arguments, chunk samples k or None for the shipped one).
FUSED_EDGES = [
    ("spp=1", 32, 24, dict(spp=1, max_bounces=4), None),
    ("spp=k+1 at offset 3", 32, 24, dict(spp=17, max_bounces=4,
                                          spp_offset=3), 16),
    ("spp=5 at offset 3, k=1 and 2", 32, 24, dict(spp=5, max_bounces=4,
                                                  spp_offset=3), (1, 2)),
    ("max_bounces=1", 32, 24, dict(spp=2, max_bounces=1), None),
    ("61x37", 61, 37, dict(spp=2, max_bounces=4), None),
    ("over twice the resident threads", 512, 288,
     dict(spp=1, max_bounces=3), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label, width, height, args, ks", FUSED_EDGES,
                         ids=[e[0] for e in FUSED_EDGES])
@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_fused_kernels_edge_shapes(cuda, monkeypatch, kernel, label, width,
                                   height, args, ks):
    """K5 (cornell_spheres, class scope) and K4 (random_spheres n=40 under
    a lamp, a row subset) against their twin where the regeneration loops
    and the chunked replay/adjoint can go wrong: the image bit for bit,
    the tables within TABLE_RTOL, two launches bit for bit. The first
    shape has fewer pixels than the grid has threads, the last gives a
    thread at least three pixels."""
    from tinyraytracer_tpu_torch.ops import diff_schedule as ds
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    if kernel == "K5":
        world, camera, kw = presets.cornell_spheres(width=width,
                                                    height=height)
        tab, cam, tgt, spec = _fused_inputs(dkp, world.build(), camera,
                                            kw["background"],
                                            surr_quad=False)
    else:
        scene, camera, bg = _lit_spheres(40, width, height)
        n_sph = int(scene.sph_valid.sum())
        tab, cam, tgt, spec = _fused_inputs(dkp, scene, camera, bg,
                                            surr_sph=(0, 5, n_sph - 1))
    kw = dict(spec=spec, width=width, height=height, seed=3, **args)
    plans = []
    real_plan = ds.plan

    def recording_plan(*a, **k):
        plans.append(real_plan(*a, **k))
        return plans[-1]

    monkeypatch.setattr(ds, "plan", recording_plan)
    for k in ks if isinstance(ks, tuple) else (ks,):
        if k is not None:
            monkeypatch.setattr(ds, "CHUNK_SAMPLES", k)
        got, again, want = _fused_run(kernel, tab, cam, tgt, kw)
        _k4_check(dkp, got, want, again)
    # the grids the launches took on this card
    assert len(plans) == 2 * len(ks if isinstance(ks, tuple) else (ks,))
    if label.startswith("over twice"):
        assert min(p.rounds for p in plans) >= 3
    else:
        assert all(p.rounds == 1 for p in plans)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_fused_kernels_image_split_parts_of_several_samples(cuda, kernel):
    """K5 and K4 against their twin on an image just under one wave of
    the image kernel, whose 12 samples split into at most 5 parts of
    several samples each (csrc/diff_common.cuh image_thread): the image
    bit for bit, the tables within TABLE_RTOL, two launches bit for bit.
    The height comes from the image kernel's occupancy on this card."""
    from tinyraytracer_tpu_torch import _build
    from tinyraytracer_tpu_torch.ops import diff_schedule as ds
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    spp, parts, width = 12, 5, 320

    def inputs(height):
        if kernel == "K5":
            world, camera, kw = presets.cornell_spheres(width=width,
                                                        height=height)
            return _fused_inputs(dkp, world.build(), camera,
                                 kw["background"], surr_quad=False)
        scene, camera, bg = _lit_spheres(40, width, height)
        return _fused_inputs(dkp, scene, camera, bg, surr_sph=(0, 5))

    tab, _, _, spec = inputs(8)
    kern, nw = ("packed", tab.numel()) if kernel == "K5" else ("classic", 0)
    lib, flags = _build.load(), ds.variant_flags(spec)
    per_sm, sms = dkp._occupancy(lib, kern, flags, nw, 0, False, True,
                                 torch.cuda.current_device())
    blocks = -(-ds.SPLIT_WAVES * per_sm * sms // parts)
    height = -(-blocks * ds.BLOCK // width)
    split = dkp.image_plan(lib, kern, flags, nw, width * height, spp)
    assert 1 < split <= parts
    tab, cam, tgt, spec = inputs(height)
    kw = dict(spec=spec, width=width, height=height, spp=spp, max_bounces=4,
              spp_offset=3, seed=3)
    got, again, want = _fused_run(kernel, tab, cam, tgt, kw)
    _k4_check(dkp, got, want, again)


def _variant_world(met, die):
    """mixed_materials (24x16) with its metal and glass spheres kept or
    made diffuse: the four material combinations under a quad light."""
    from tinyraytracer_tpu_torch.models.camera import Camera
    from tinyraytracer_tpu_torch.models.geometry import Quad, Sphere
    from tinyraytracer_tpu_torch.models.materials import (
        Dielectric, Lambertian, Light, Metal)
    from tinyraytracer_tpu_torch.models.world import World

    world = World()
    world.add_material("ground", Lambertian((0.6, 0.5, 0.4)))
    world.add_material("met", Metal((0.8, 0.8, 0.9), 0.3) if met
                       else Lambertian((0.8, 0.8, 0.9)))
    world.add_material("glass", Dielectric((0.95, 0.95, 0.95), 1.5) if die
                       else Lambertian((0.95, 0.95, 0.95)))
    world.add_material("lamp", Light((10.0, 10.0, 10.0)))
    world.add_geometry(Sphere((0.0, -100.5, -1.0), 100.0, "ground"))
    world.add_geometry(Sphere((-0.7, 0.0, -1.2), 0.5, "met"))
    world.add_geometry(Sphere((0.7, 0.0, -1.2), 0.5, "glass"))
    world.add_geometry(Quad((-1.5, 2.0, -2.5), (3.0, 0.0, 0.0),
                            (0.0, 0.0, 2.0), "lamp"))
    camera = Camera.new(focus_distance=1.0, defocus_angle=0.0,
                        position=(0.0, 0.3, 1.0), look_at=(0.0, 0.0, -1.0),
                        up=(0.0, 1.0, 0.0), vertical_fov=60.0, width=24,
                        height=16)
    return world, camera


@pytest.mark.cuda
@pytest.mark.parametrize("met, die", [(False, False), (True, False),
                                      (False, True), (True, True)])
@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_fused_kernels_every_variant(cuda, kernel, met, die):
    """Each compiled switch combination (NEE, silhouette, metal,
    dielectric) of K5 and K4 launched and held against the twin, with a
    background colour and without one."""
    from tinyraytracer_tpu_torch.ops import diff_schedule as ds
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    world, camera = _variant_world(met, die)
    seen = set()
    for nee in (True, False):
        for sil in (True, False):
            for bg in ((0.05, 0.06, 0.08), (0.0, 0.0, 0.0)):
                tab, cam, tgt, spec = _fused_inputs(dkp, world.build(),
                                                    camera, bg, nee=nee,
                                                    sil=sil)
                assert (spec.has_met, spec.has_die) == (met, die)
                kw = dict(spec=spec, width=24, height=16, spp=2,
                          max_bounces=4, seed=5)
                got, again, want = _fused_run(kernel, tab, cam, tgt, kw)
                _k4_check(dkp, got, want, again)
                seen.add(ds.variant_key(ds.variant_flags(spec)))
    assert seen == {8 * n + 4 * s + 2 * met + die for n in (0, 1)
                    for s in (0, 1)}



# --- pixel ranges and the mesh route (parallel/sharded.py) -----------------

# Ranges of a 61x37 image (2 257 pixels): the first pixel, one starting
# mid-row and crossing rows, a middle cut, the last 5 pixels, the whole.
PIXEL_RANGES = [(0, 1), (70, 300), (1000, 1128), (2252, 5), (0, 2257)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["K1", "K2", "K2 culled"])
def test_forward_kernels_on_a_pixel_range_equal_twins(cuda, route):
    """K1 (cornell_box) and K2 (random_spheres n=500; 8000, culled) over
    pixel ranges of a 61x37 image, spp=5 at offset 2: bit for bit with
    the twin on the same range and with the whole image's rows, one
    launch each; a range outside the image raises."""
    name, pkw = (("cornell_box", {}) if route == "K1" else
                 ("random_spheres", dict(n=8000 if "culled" in route
                                         else 500)))
    world, camera, kw = presets.PRESETS[name](width=61, height=37, **pkw)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    if route == "K1":
        low = r.lowered
        args = dict(n_sph=low.n_sph, n_quad=low.n_quad, width=61, height=37,
                    spp=5, max_bounces=6, seed=3, spp_offset=2,
                    has_met=low.has_met, has_die=low.has_die, sky=low.sky)
        fn = lambda **o: mkp.render_packed(r.table, r.cam, **args, **o)  # noqa
        twin = lambda **o: mkp.render_packed_reference(  # noqa: E731
            r.table, r.cam, **args, **o)
        counter = mkp.render_packed
    else:
        args = r.flat_args(spp=5, max_bounces=6, seed=3, spp_offset=2)
        args.pop("pixels")
        assert (args["aabbs"] is not None) == ("culled" in route)
        fn = lambda **o: mk.render_flat(**args, **o)  # noqa: E731
        twin_args = {k: v for k, v in args.items() if k != "aabbs"}
        twin = lambda **o: mk.render_flat_reference(**twin_args, **o)  # noqa
        counter = mk.render_flat
    whole = fn().reshape(-1, 3)
    for b, n in PIXEL_RANGES:
        before = counter.launches
        got = fn(pixels=(b, n))
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert got.shape == (n, 3)
        assert torch.equal(got, twin(pixels=(b, n)))
        assert torch.equal(got, whole[b:b + n])
    with pytest.raises(ValueError, match="range"):
        fn(pixels=(2250, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_fused_kernels_on_a_pixel_range_equal_twins(cuda, kernel):
    """K5 (cornell_spheres, class scope) and K4 (the same scene forced
    onto it) over pixel ranges of a 61x37 image: the image bit for bit
    with the twin on the range and with the whole image's rows, the loss
    and tables within TABLE_RTOL of the twin's; the tables over a split of
    the image add up to the whole image's within TABLE_RTOL."""
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    world, camera, kw = presets.cornell_spheres(width=61, height=37)
    tab, cam, tgt, spec = _fused_inputs(dkp, world.build(), camera,
                                        kw["background"], surr_quad=False,
                                        device=cuda)
    fn = dkp.packed_diff if kernel == "K5" else dk.classic_diff
    kw = dict(spec=spec, width=61, height=37, spp=3, max_bounces=4, seed=1,
              spp_offset=2)
    whole = fn(tab, cam, tgt, **kw)
    rows = tgt.view(-1, 3)
    for b, n in PIXEL_RANGES:
        part = rows[b:b + n].contiguous()
        got = fn(tab, cam, part, pixels=(b, n), **kw)
        want = dkp.packed_diff_reference(tab, cam, part, pixels=(b, n), **kw)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[0], whole[0].view(-1, 3)[b:b + n])
        for a, c in zip(got[1:], want[1:]):
            scale = max(float(c.abs().max()), 1e-30)
            assert float((a - c).abs().max()) <= dkp.TABLE_RTOL * scale
    cuts = [(0, 1000), (1000, 1257)]
    parts = [fn(tab, cam, rows[b:b + n].contiguous(), pixels=(b, n), **kw)
             for b, n in cuts]
    for k in range(1, 6):
        total = parts[0][k] + parts[1][k]
        scale = max(float(whole[k].abs().max()), 1e-30)
        assert float((total - whole[k]).abs().max()) <= dkp.TABLE_RTOL * scale


@pytest.mark.cuda
def test_mesh_routes_on_one_card(cuda):
    """A (2 x 2) mesh of the one card: the forward megakernel route within
    1e-6 of one launch (a tile-only mesh bit for bit), one launch per
    cell, and the fused step's loss within 1e-6 relative of one device."""
    from tinyraytracer_tpu_torch.diff import inverse
    from tinyraytracer_tpu_torch.parallel import sharded

    world, camera, kw = presets.cornell_box(width=64, height=48)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], cuda)
    ref = r.render(spp=4, max_bounces=6, seed=3)
    dev = [cuda] * 4
    before = mkp.render_packed.launches
    tile = r.render(spp=4, max_bounces=6, seed=3,
                    mesh=sharded.make_mesh(dev))
    split = r.render(spp=4, max_bounces=6, seed=3,
                     mesh=sharded.make_mesh(dev, sample_parallel=2))
    torch.cuda.synchronize()
    assert mkp.render_packed.launches == before + 8
    assert torch.equal(tile, ref)
    assert float((split - ref).abs().max()) <= 1e-6
    world, camera, kw = presets.cornell_spheres(width=32, height=32)
    common = dict(spp=2, max_bounces=4, background=kw["background"],
                  trainable=("sph_center", "mat_albedo"))
    losses = []
    for mesh in (None, sharded.make_mesh(dev, sample_parallel=2)):
        step, (p, o) = inverse.make_fused_train_step(
            world.build(), camera, torch.zeros((32, 32, 3)), mesh=mesh,
            device=cuda, **common)
        losses.append(float(step(p, o, 0)[2]))
    assert abs(losses[1] - losses[0]) <= 1e-6 * losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name, kw", [("cornell_box", {}),
                                      ("random_spheres", dict(n=500))])
def test_bvh_walk_on_the_card_equals_the_cpu(cuda, name, kw):
    """ops/bvh.py's walk gives the CPU walk's (t, j) bit for bit, twice
    in a row over the same BVH, on primary rays."""
    from tinyraytracer_tpu_torch.ops import bvh as bvh_ops

    world, camera, _ = presets.PRESETS[name](width=64, height=48, **kw)
    scene = world.build()
    bvh = bvh_ops.build_bvh(scene)
    o, d = generate_rays(camera, torch.arange(64 * 48), 0, 3)
    t_c, j_c = bvh_ops.traverse(scene, bvh, o, d)
    g_scene, g_bvh = scene.to(cuda), bvh.to(cuda)
    for _ in range(2):
        t_g, j_g = bvh_ops.traverse(g_scene, g_bvh, o.to(cuda), d.to(cuda))
        assert torch.equal(t_g.cpu(), t_c) and torch.equal(j_g.cpu(), j_c)


@pytest.mark.cuda
def test_bvh_renderer_runs_no_kernel(cuda):
    """Renderer(accelerator="bvh") on the card renders the dense modular
    route's image (selection rounds apart: MAX_FRAC of pixels may differ)
    and launches none of K1-K5."""
    from tinyraytracer_tpu_torch import Renderer
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    def counts():
        return (mkp.render_packed.launches, mk.render_flat.launches,
                ik.closest_hit.launches, dk.classic_diff.launches,
                dkp.packed_diff.launches)

    world, camera, kw = presets.random_spheres(width=32, height=24, n=200)
    args = dict(max_bounces=6, background_color=kw["background"], seed=1,
                device=cuda)
    before = counts()
    got = Renderer(4, accelerator="bvh", **args).render_array(
        camera, world.build())
    assert counts() == before
    want = Renderer(4, accelerator="none", **args).render_array(
        camera, world.build())
    assert torch.isfinite(got).all()
    frac = float(((got - want).abs() > ATOL).any(-1).float().mean())
    assert frac <= MAX_FRAC


@pytest.mark.cuda
def test_ray_and_transform_on_the_card(cuda):
    """Ray and Transform build on the card by default and keep a card
    tensor there, also when the value was built on the CPU."""
    from tinyraytracer_tpu_torch import Ray, Transform

    args = ((1.0, 2.0, 3.0), (2.0, 2.0, 2.0), (0.0, 0.0, 90.0))
    t = Transform.new(*args)
    assert t.matrix.device.type == "cuda"
    pts = torch.randn((5, 3), generator=torch.Generator().manual_seed(0))
    want = Transform.new(*args, device="cpu").apply(pts)
    for tr in (t, Transform.new(*args, device="cpu")):
        got = tr.apply(pts.to(cuda))
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
        assert tr.apply_vector(pts.to(cuda)).device.type == "cuda"
    r = Ray.new([0.0, 0.0, 0.0], [0.0, 2.0, 0.0])
    assert r.origin.device.type == "cuda"
    cpu_ray = Ray.new([0.0, 0.0, 0.0], [0.0, 2.0, 0.0], device="cpu")
    at = cpu_ray.at(torch.ones(3, device=cuda))
    assert at.device.type == "cuda" and float(at[0, 1]) == 1.0
