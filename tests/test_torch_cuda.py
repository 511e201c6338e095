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
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp

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
