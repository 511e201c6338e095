"""PyTorch port's packed megakernel against the JAX package's K1.

The port's plain twin (`render_packed_reference`, what a CPU render runs)
is held to the JAX sublane-packed Pallas kernel run in interpret mode on
the same scene, seed and settings. The CUDA kernel is held to the twin on
the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.ops import megakernel as jmk
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.ops import megakernel as tmk
from tinyraytracer_tpu_torch.ops import megakernel_packed as tmkp
from tinyraytracer_tpu_torch.utils import profiling

# Image tolerance. Per-pixel |d| <= ATOL on at least 1 - MAX_FRAC of the
# pixels, and the image means within MEAN_RTOL. Both sides run the same
# op sequence per pixel, but sin/cos/exp/log differ by up to 1 ulp
# between the frameworks' libraries, and the JAX kernel normalises with
# XLA's rsqrt (up to 2 ulp from the port's 1/sqrt). Where a ray then lands
# on a discrete edge (the Cornell light is coplanar with the ceiling; the
# dielectric reflect/refract draw) a whole path flips. Measured: at the
# sizes below every scene matched to 1.2e-7 on every pixel; at 48x36 spp=8
# max_bounces=10, Cornell differed beyond 1e-5 on 3.5 % of pixels (up to
# 5.6) and the sphere and quad scenes on none.
ATOL = 1e-5
MAX_FRAC = 0.05
MEAN_RTOL = 0.02

SCENES = [
    ("sphere_ground", 4, 4),
    ("three_spheres", 4, 4),
    ("cornell_box", 2, 4),
    ("five_quads", 2, 4),
    ("rtiow_sky", 4, 4),
]
# Edges of the sampler, (name, spp, max_bounces, width, height): the
# budget kill on the first bounce, and an odd image size that no block
# shape tiles.
EDGE_CASES = [
    ("three_spheres", 3, 1, 16, 12),
    ("rtiow_sky", 2, 4, 13, 11),
]


def _assert_image_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    bad = np.abs(got - want).max(-1) > ATOL
    assert bad.mean() <= MAX_FRAC, f"{bad.mean():.3%} of pixels off"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=MEAN_RTOL)


def _pair(name, width=16, height=12):
    return (jpresets.PRESETS[name](width=width, height=height),
            tpresets.PRESETS[name](width=width, height=height))


@pytest.mark.parametrize(
    "name, spp, mb, width, height",
    [pytest.param(n, s, m, 16, 12, id=f"{n}-{s}-{m}") for n, s, m in SCENES]
    + [pytest.param(*c, id="{}-{}-{}-{}x{}".format(*c)) for c in EDGE_CASES])
def test_twin_matches_jax_packed_kernel(name, spp, mb, width, height):
    (jw, jc, kw), (tw, tc, tkw) = _pair(name, width, height)
    want = np.asarray(jmk.render_image_megakernel(
        jw.build(), jc, spp=spp, max_bounces=mb, background=kw["background"],
        seed=3, interpret=True, packed=True))
    got = tmk.render_image_megakernel(
        tw.build(), tc, spp=spp, max_bounces=mb,
        background=tkw["background"], device="cpu", seed=3)
    assert got.device.type == "cpu"
    _assert_image_close(got.numpy(), want)


def test_spp_offset_partitions_samples():
    """Samples [0, 2) and [2, 4) average to the 4-sample render, and an
    offset render matches the JAX kernel's offset render."""
    (jw, jc, kw), (tw, tc, tkw) = _pair("three_spheres")
    r = tmk.MegakernelRenderer(tw.build(), tc, tkw["background"], "cpu")
    full = r.render(spp=4, max_bounces=3, seed=5)
    a = r.render(spp=2, max_bounces=3, seed=5, spp_offset=0)
    b = r.render(spp=2, max_bounces=3, seed=5, spp_offset=2)
    np.testing.assert_allclose(((a + b) / 2.0).numpy(), full.numpy(),
                               atol=1e-6)
    jr = jmk.MegakernelRenderer(jw.build(), jc, kw["background"],
                                interpret=True)
    jb = jr.render(spp=2, max_bounces=3, seed=5, spp_offset=2, packed=True)
    _assert_image_close(b.numpy(), np.asarray(jb))


def _shade_inputs(seed: int, n: int = 4096):
    """Random bounce state and winner payloads, as numpy f32/bool."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    d = f(3, n)
    d /= np.linalg.norm(d, axis=0)
    state = [*(f(3, n) * 3.0), *d, *r.random((6, n), dtype=np.float32)]
    kind = r.integers(0, 4, n).astype(np.float32)
    pay = [(r.random(n) < 0.5).astype(np.float32), *f(3, n), kind,
           *r.random((4, n), dtype=np.float32),
           np.where(r.random(n) < 0.5, 1.5, 1 / 1.5).astype(np.float32),
           *(r.random((3, n), dtype=np.float32) * (kind == 3))]
    alive = r.random(n) < 0.8
    hit = r.random(n) < 0.7
    best_t = (r.random(n, dtype=np.float32) * 5.0 + 1e-3).astype(np.float32)
    return state, alive, best_t, hit, pay, r.random((4, n), dtype=np.float32)


@pytest.mark.parametrize("has_met, has_die, sky", [
    (True, True, False), (False, False, False), (True, False, True),
    (False, True, True),
])
def test_shade_bounce_matches_jax(has_met, has_die, sky):
    """One bounce on random states: throughput, color, origin and alive
    flag bit for bit; directions within 1e-5 (the final normalisation is
    rsqrt in JAX and 1/sqrt here; measured max 3.7e-6)."""
    state, alive, best_t, hit, pay, u = _shade_inputs(7)
    bg = np.float32([0.7, 0.8, 1.0])
    bg2 = np.float32([0.5, 0.7, 1.0])
    sky_kw = (dict(bg2_r=jnp.float32(bg2[0]), bg2_g=jnp.float32(bg2[1]),
                   bg2_b=jnp.float32(bg2[2])) if sky else {})
    # each framework gets its own copy of every input
    j = jnp.array
    want = jmk._shade_bounce(
        *map(j, state), j(alive), j(best_t), j(hit), *map(j, pay),
        *map(j, u), *map(jnp.float32, bg), has_met=has_met, has_die=has_die,
        **sky_kw)
    t = torch.tensor
    got = tmk.shade_bounce(
        *map(t, state), t(alive), t(best_t), t(hit), *map(t, pay),
        *map(t, u), tuple(map(torch.tensor, bg)),
        tuple(map(torch.tensor, bg2)) if sky else None,
        has_met=has_met, has_die=has_die)
    want = np.stack([np.array(x) for x in want])
    got = np.stack([x.numpy() for x in got])
    np.testing.assert_array_equal(got[:3], want[:3])      # origin
    np.testing.assert_allclose(got[3:6], want[3:6], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[6:], want[6:])      # tput, col, alive


def test_wrapper_validates_and_counts_only_kernel_launches():
    world, camera, kw = tpresets.sphere_ground(width=8, height=6)
    r = tmk.MegakernelRenderer(world.build(), camera, kw["background"],
                               "cpu")
    before = profiling.counter("launches.render_packed")
    img = r.render(spp=1, max_bounces=2)
    assert tuple(img.shape) == (6, 8, 3)
    # the twin is no launch
    assert profiling.counter("launches.render_packed") == before
    low = r.lowered
    args = dict(n_sph=low.n_sph, n_quad=low.n_quad, width=8, height=6,
                spp=1, max_bounces=2)
    with pytest.raises(ValueError):
        tmkp.render_packed(r.table.double(), r.cam, **args)
    with pytest.raises(ValueError):
        tmkp.render_packed(r.table, r.cam[:16], **args)
    with pytest.raises(ValueError):
        tmkp.render_packed(r.table, r.cam, **{**args, "n_sph": 100})


def test_lowered_scene_fields_are_consistent():
    """The lowered scene the renderer keeps matches the table layout."""
    world, camera, kw = tpresets.cornell_box(width=8, height=8)
    r = tmk.MegakernelRenderer(world.build(), camera, kw["background"],
                               "cpu")
    low = r.lowered
    assert (low.n_sph, low.n_quad) == (0, 18)
    assert not (low.has_met or low.has_die or low.sky)
    assert r.table.numel() >= 18 * 24 and r.cam.numel() == 32
