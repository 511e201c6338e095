"""The PyTorch port's modular path tracer (ops/trace.py) against the JAX
package's, on cornell_spheres (BASELINE config 5's scene) at 8x8.

Both sides trace the same primary rays (each side generates them from
the same seed; they agree to 1 ulp). Torch runs single-threaded here
(see tests/test_torch_intersect.py).

Tolerance: radiance within RAD_ATOL on every ray (measured: 1.7e-6 at
most, from ulp differences of sin/cos/exp/log between the frameworks'
libraries), alive counts equal. The JAX reference selects with the
oracle form (exact=True) where a whole image is compared: its default
expanded form runs under jit, where XLA fuses multiply-adds, and that
flipped one Cornell ray's winner at 8x8 spp=2 (measured; the port's
own dense and K3-twin selections agree with the oracle there).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu import Renderer as JRenderer
from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.models.camera import generate_rays as jgen
from tinyraytracer_tpu.ops import intersect_pallas as jip
from tinyraytracer_tpu.ops import trace as jtr
from tinyraytracer_tpu_torch import Renderer
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import intersect as tis
from tinyraytracer_tpu_torch.ops import intersect_kernel as tik
from tinyraytracer_tpu_torch.ops import trace as ttr

RAD_ATOL = 1e-5
# Renderer(accelerator="none") images, as tests/test_torch_megakernel.py
# states them: |d| <= IMG_ATOL on all but IMG_MAX_FRAC of the pixels,
# means within IMG_MEAN_RTOL.
IMG_ATOL = 1e-5
IMG_MAX_FRAC = 0.05
IMG_MEAN_RTOL = 0.02
W = H = 8
MB = 4


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cornell():
    jw, jc, kw = jpresets.cornell_spheres(width=W, height=H)
    tw, tc, tkw = tpresets.cornell_spheres(width=W, height=H)
    return jw.build(), jc, tw.build(), tc, kw["background"]


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_trace_matches_jax(cornell, nee, compact):
    """nee and silhouette off/on, dense or K3-twin selection; with the
    per-bounce alive counts."""
    js, jc, ts, tc, bg = cornell
    pid = np.arange(W * H)
    jo, jd = jgen(jc, jnp.asarray(pid, jnp.uint32), jnp.uint32(1),
                  jnp.uint32(0))
    want, want_n = jtr.trace(
        js, jo, jd, jnp.asarray(pid, jnp.uint32), jnp.uint32(1),
        jnp.uint32(0), MB, jnp.asarray(bg, jnp.float32),
        compact=jip.compact_scene(js) if compact else None, interpret=True,
        nee=nee, silhouette=nee, count_alive=True)
    to, td = generate_rays(tc, torch.from_numpy(pid), 1, 0)
    with torch.no_grad():
        got, got_n = ttr.trace(
            ts, to, td, torch.from_numpy(pid), 1, 0, MB, bg,
            compact=tik.compact_rows(ts, "cpu") if compact else None,
            nee=nee, silhouette=nee, count_alive=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RAD_ATOL)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_n[0] > 0 and float(got.mean()) > 0


def test_render_pixels_fused_rounds_match_jax(cornell):
    """fuse_spp: spp=4 traced as one wavefront of 4 samples per pixel,
    from a sample offset, as the training loss renders."""
    js, jc, ts, tc, bg = cornell
    want = jtr.render_pixels(
        js, jc, jnp.arange(W * H, dtype=jnp.uint32), spp=4, max_bounces=MB,
        background=jnp.asarray(bg), seed=jnp.uint32(3), exact=True,
        spp_offset=jnp.uint32(8), nee=True, silhouette=True, fuse_spp=True)
    assert ttr.sample_rounds(W * H, 4, True) == (4, 1)
    with torch.no_grad():
        got = ttr.render_pixels(
            ts, tc, torch.arange(W * H), spp=4, max_bounces=MB,
            background=bg, seed=3, exact=True, spp_offset=8, nee=True,
            silhouette=True, fuse_spp=True).numpy()
    # over 256 paths an ulp may flip a discrete event (measured: 2 of 64
    # pixels differ, by up to 2.4e-3): the image tolerance
    d = np.abs(got - np.asarray(want)).max(-1)
    assert (d > IMG_ATOL).mean() <= IMG_MAX_FRAC
    np.testing.assert_allclose(got.mean(), np.asarray(want).mean(),
                               rtol=IMG_MEAN_RTOL)


def test_silhouette_factor_is_exactly_one_forward(cornell):
    """The surrogate only adds a gradient: its value is 1.0 on every ray,
    alive or not, hit or miss."""
    _, _, ts, tc, _ = cornell
    rs = np.random.RandomState(0)
    pid = torch.arange(W * H)
    o, d = generate_rays(tc, pid, 0, 0)
    t, j = tis.closest_select(ts, o, d)
    alive = torch.from_numpy(rs.rand(W * H) > 0.3)
    center = ts.sph_center.clone().requires_grad_(True)
    s = dataclasses.replace(ts, sph_center=center)
    f = ttr._silhouette_factor(s, o, d, t, j, alive, ttr.scene_rows(s))
    assert torch.equal(f.detach(), torch.ones(W * H))
    f.sum().backward()
    assert center.grad[:2].abs().sum() > 0          # it carries a score
    assert torch.isfinite(center.grad).all()


def _grads(ts, tc, bg, remat):
    center = ts.sph_center.clone().requires_grad_(True)
    albedo = ts.mat_albedo.clone().requires_grad_(True)
    s = dataclasses.replace(ts, sph_center=center, mat_albedo=albedo)
    pid = torch.arange(W * H)
    o, d = generate_rays(tc, pid, 2, 1)
    c = ttr.trace(s, o, d, pid, 2, 1, MB, bg, nee=True, silhouette=True,
                  remat=remat, compact=tik.compact_rows(ts, "cpu"))
    c.square().sum().backward()
    return center.grad, albedo.grad


def test_remat_recomputes_the_same_gradient(cornell):
    """remat=True checkpoints each bounce and replays its saved
    selections in the backward pass: the gradients are those of the kept
    graph, bit for bit."""
    _, _, ts, tc, bg = cornell
    calls = []
    real = tik.closest_hit_reference

    def counting(*a):
        calls.append(1)
        return real(*a)

    ttr.closest_hit = counting      # compact.plain is False on the CPU
    try:
        kept = _grads(ts, tc, bg, remat=False)
        n_kept = len(calls)
        remat = _grads(ts, tc, bg, remat=True)
    finally:
        ttr.closest_hit = tik.closest_hit
    assert n_kept == 2 * MB and len(calls) == 4 * MB  # no reselection
    for a, b in zip(kept, remat):
        assert torch.equal(a, b)
        assert a.abs().sum() > 0


def test_selection_tape_replays_without_selecting(cornell):
    _, _, ts, tc, bg = cornell
    pid = torch.arange(W * H)
    o, d = generate_rays(tc, pid, 0, 4)
    tape = ttr.SelectionTape()
    cs = tik.compact_rows(ts, "cpu")
    with torch.no_grad():
        first = ttr.trace(ts, o, d, pid, 0, 4, MB, bg, compact=cs, nee=True,
                          tape=tape)
        assert len(tape.entries) == 2 * MB
        assert tape.entries[1][1] is None         # shadow rays keep only t
        again = ttr.trace(ts, o, d, pid, 0, 4, MB, bg, compact=None,
                          nee=True, tape=tape.replay())
        half = ttr.trace(ts, o[:32], d[:32], pid[:32], 0, 4, MB, bg,
                         nee=True, tape=tape.replay(slice(0, 32)))
    assert torch.equal(first, again)
    assert torch.equal(first[:32], half)


@pytest.mark.parametrize("name", ["cornell_spheres", "three_spheres"])
def test_renderer_accelerator_none_matches_jax(name):
    """Renderer(accelerator="none") renders with the modular tracer and
    dense selection on both sides."""
    jw, jc, kw = jpresets.PRESETS[name](width=16, height=12)
    tw, tc, tkw = tpresets.PRESETS[name](width=16, height=12)
    want = JRenderer(2, max_bounces=MB, background_color=kw["background"],
                     seed=1, accelerator="none").render(jc, jw).data
    r = Renderer(2, max_bounces=MB, background_color=tkw["background"],
                 seed=1, accelerator="none", device="cpu")
    got = r.render(tc, tw).data
    assert got.shape == want.shape == (12, 16, 3)
    d = np.abs(got.astype(np.float64) - want).max(-1)
    assert (d > IMG_ATOL).mean() <= IMG_MAX_FRAC
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=IMG_MEAN_RTOL)
    # render_batch goes through the same sampler
    np.testing.assert_array_equal(r.render_batch(tc, tw, [1])[0].data, got)
