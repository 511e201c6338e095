"""K2 with participating media (its HAS_MED instantiations) on the card,
against its twin and the plain reference. Every test here carries the
`cuda` marker and skips where there is no CUDA device; like
tests/test_torch_cuda.py, this file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -o addopts= -q tests/test_torch_media_cuda.py

The kernel is built with --fmad=false and the twin runs one operation per
launch on the same card (the card's logf, sqrtf and division), so the
images agree bit for bit, on the dense search and on the walk alike.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.utils import profiling
from torch_media_scenes import CULL, DESCS, ROOT, port_world, reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _routes(cuda, name, w, h, desc=None):
    """(walk, dense) renderers of a scene on the card."""
    world, camera, bg = port_world(name, w, h, desc=desc)
    scene = world.build()
    walk = mk.MegakernelRenderer(scene, camera, bg, cuda, bvh=True)
    dense = mk.MegakernelRenderer(scene, camera, bg, cuda, bvh=False)
    assert walk.bvh and not dense.bvh and walk.flat.n_med > 0
    return walk, dense


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DESCS))
def test_media_kernel_equals_twin_on_both_routes(cuda, name):
    """At 64x48 (under one wave: the samples split over threads) the walk
    and the dense search give the twin's image bit for bit, and so do
    mesh shards' pixel ranges; each render is one HAS_MED launch."""
    walk, dense = _routes(cuda, name, 64, 48)
    lib = _build.load()
    f = walk.flat
    flags = (int(f.has_met), int(f.has_die), int(f.sky))
    assert lib.tinyrt_megakernel_flat_split(64, 48, 4, *flags, 1, 1) > 1
    args = dict(spp=4, max_bounces=12, seed=3_000_000_019, spp_offset=2)
    before = profiling.counter("launches.render_flat")
    got = walk.render(**args)
    assert torch.equal(got, dense.render(**args))
    assert profiling.counter("launches.render_flat") == before + 2
    twin = dense.flat_args(**args)
    twin.pop("aabbs")
    assert torch.equal(got, mk.render_flat_reference(**twin))
    for b, n in ((0, 1), (70, 300), (2200, 104)):
        shard = mk.render_flat(**walk.flat_args(**args, pixels=(b, n)))
        assert torch.equal(shard, got.reshape(-1, 3)[b:b + n])


@pytest.mark.cuda
def test_media_kernel_above_one_wave(cuda):
    """A whole image above one wave (no split): walk == dense bit for
    bit."""
    walk, dense = _routes(cuda, "walk", 640, 360)
    f = walk.flat
    flags = (int(f.has_met), int(f.has_die), int(f.sky))
    assert _build.load().tinyrt_megakernel_flat_split(
        640, 360, 2, *flags, 1, 1) == 1
    args = dict(spp=2, max_bounces=16, seed=7)
    assert torch.equal(walk.render(**args), dense.render(**args))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,spp", [(64, 48, 4), (640, 360, 2)],
                         ids=["split", "one-wave"])
def test_media_kernel_on_the_block_cull(cuda, w, h, spp):
    """Forced onto the block cull (600 Morton-ordered spheres in three
    blocks, then the quads and the media), K2 with media gives the image
    of the dense search over the same rows, of its twin and of the walk,
    bit for bit, under the sample split and above one wave alike."""
    world, camera, bg = port_world(None, w, h, desc=CULL)
    scene = world.build()
    cull = mk.MegakernelRenderer(scene, camera, bg, cuda, chunk_cull=True)
    walk = mk.MegakernelRenderer(scene, camera, bg, cuda)
    f = cull.flat
    assert cull.chunk_cull and walk.bvh and f.aabbs.shape[0] == 3
    flags = (int(f.has_met), int(f.has_die), int(f.sky))
    split = _build.load().tinyrt_megakernel_flat_split(w, h, spp, *flags,
                                                         0, 1)
    assert (split > 1) == (w == 64)
    args = dict(spp=spp, max_bounces=12, seed=3_000_000_019, spp_offset=2)
    got = cull.render(**args)
    dense = cull.flat_args(**args)
    dense.pop("aabbs")
    assert torch.equal(got, mk.render_flat(**dense))
    if w == 64:
        assert torch.equal(got, mk.render_flat_reference(**dense))
    assert torch.equal(got, walk.render(**args))


@pytest.mark.cuda
@pytest.mark.parametrize("bvh", [True, False], ids=["walk", "dense"])
def test_media_counters_are_the_reference_counts(cuda, bvh):
    """While a profiler records, the counting HAS_MED instantiation gives
    the image it gives uncounted, the reference's image bit for bit, and
    the reference's segments and medium scatters exactly."""
    w, h, spp, mb, seed = 32, 24, 3, 12, 3_000_000_019
    world, camera, bg = port_world("walk", w, h)
    r = mk.MegakernelRenderer(world.build(), camera, bg, cuda, bvh=bvh)
    plain = r.render(spp=spp, max_bounces=mb, seed=seed)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        img = r.render(spp=spp, max_bounces=mb, seed=seed)
        torch.cuda.synchronize()
    dev = profiling.snapshot()["device"]
    profiling.reset()
    assert torch.equal(img, plain)
    want, seg, share = reference("walk", w, h, torch.arange(w * h), spp=spp,
                                 max_bounces=mb, seed=seed, device=cuda)
    assert torch.equal(img.reshape(-1, 3), want.float())
    assert dev["lane_segments"] == round(seg * w * h * spp)
    assert dev["medium_scatters"] == round(share * dev["lane_segments"])
    assert 0 < dev["medium_scatters"] < dev["lane_segments"]
    assert 0 < dev["walk_steps"] <= dev["walk_iters"]
    if not bvh:
        rows = r.n_sph + r.n_quad + r.n_med
        assert dev["walk_steps"] == rows * dev["lane_segments"]


@pytest.mark.cuda
def test_rtnw_final_on_the_card(cuda):
    """The benchmark's `rtnw_final` scene at 48x48, 40 bounces: the walk
    (the route the rule takes) equals the dense search, the twin and the
    plain reference bit for bit."""
    from perfbench.traffic import render_media

    with open(f"{ROOT}/perfbench/configs/rtnw_final.json") as f:
        desc = render_media.description(json.load(f))
    w = h = 48
    world, camera, bg = port_world(None, w, h, desc=desc)
    scene = world.build()
    walk = mk.MegakernelRenderer(scene, camera, bg, cuda)
    dense = mk.MegakernelRenderer(scene, camera, bg, cuda, bvh=False)
    assert walk.bvh
    args = dict(spp=4, max_bounces=40, seed=2_718_281_828)
    got = walk.render(**args)
    assert torch.equal(got, dense.render(**args))
    twin = dense.flat_args(**args)
    twin.pop("aabbs")
    assert torch.equal(got, mk.render_flat_reference(**twin))
    want, _, share = reference(None, w, h, torch.arange(w * h), spp=4,
                               max_bounces=40, seed=args["seed"],
                               device=cuda, desc=desc)
    assert torch.equal(got.reshape(-1, 3), want.float())
    assert share > 0.0
