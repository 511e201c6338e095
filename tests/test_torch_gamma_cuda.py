"""The render's gamma: numpy's power on the host, the kernel of
csrc/gamma.cu (ops/tonemap.py `gamma_cuda`) on the card.

`Image.from_linear` picks the route by the framebuffer's device alone: a
CUDA tensor is raised to the power on the card before the readback, a
CPU tensor or an array by numpy, as before. The tests without a marker
run on any machine; those with the `cuda` marker skip where there is no
CUDA device. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts= -q tests/test_torch_gamma_cuda.py
"""

import numpy as np
import pytest
import torch

from tinyraytracer_tpu_torch import Image, Renderer
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.ops import tonemap
from tinyraytracer_tpu_torch.utils import profiling

# the error numpy's float32 power may have (SIMD paths on some hosts)
MAX_ULP = 4
_TINY = np.finfo(np.float32).smallest_subnormal
EDGES = np.array([np.nan, -0.0, 0.0, -1.0, -np.inf, np.inf, _TINY, 3 * _TINY,
                  np.finfo(np.float32).tiny, 1e-30, 1e-7, 0.5, 1.0, 0.999,
                  tonemap.INTENSITY_MAX, 1.0001, 7.5, 1e30,
                  np.finfo(np.float32).max], np.float32)


def _numpy_power(x: np.ndarray) -> np.ndarray:
    """What Image has always computed: numpy's float32 power."""
    return np.maximum(x, 0.0) ** (1.0 / tonemap.GAMMA)


def _linear(h=6, w=8, seed=0) -> np.ndarray:
    """A linear (h, w, 3) image: radiance-like values, a few negatives."""
    rng = np.random.default_rng(seed)
    return (rng.standard_exponential((h, w, 3)) * 0.4 - 0.02).astype(
        np.float32)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place, for non-negative float32."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal as numbers, NaN with NaN, and with the same signs of zero."""
    return (np.array_equal(a, b, equal_nan=True)
            and np.array_equal(np.signbit(a), np.signbit(b)))


# -- any machine ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["array", "cpu_tensor"])
def test_from_linear_on_the_host_is_numpys_power(kind):
    """A CPU framebuffer keeps numpy's power bit for bit, and launches no
    gamma kernel."""
    lin = _linear()
    data = lin if kind == "array" else torch.from_numpy(lin.copy())
    before = profiling.counter("launches.gamma")
    img = Image.from_linear(data, gamma=tonemap.GAMMA)
    np.testing.assert_array_equal(img.data, _numpy_power(lin))
    assert img.data.dtype == np.float32
    assert profiling.counter("launches.gamma") == before
    if kind == "cpu_tensor":
        np.testing.assert_array_equal(data.numpy(), lin)   # input untouched


def test_cpu_renders_take_numpys_power():
    """render, render_batch and render_async's result on the CPU: numpy's
    power of the linear framebuffer, and no gamma launch."""
    world, camera, kw = presets.cornell_box(width=8, height=6)
    r = Renderer(2, max_bounces=3, background_color=kw["background"],
                 seed=5, device="cpu")
    before = profiling.counter("launches.gamma")
    want = _numpy_power(r.render_array(camera, world.build()).numpy())
    np.testing.assert_array_equal(r.render(camera, world).data, want)
    np.testing.assert_array_equal(
        r.render_batch(camera, world, [5])[0].data, want)
    np.testing.assert_array_equal(
        r.render_async(camera, world).result().data, want)
    assert profiling.counter("launches.gamma") == before


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 4, 3), dtype=torch.float64),    # not float32
    torch.zeros((4, 4, 3), dtype=torch.float16),
    torch.zeros((4, 4)),                            # not (H, W, 3)
    torch.zeros((4, 4, 4)),
    torch.zeros((48,)),
    torch.zeros((2, 2, 4, 4, 3)),
    torch.zeros((4, 3, 4)).transpose(1, 2),         # not contiguous
    torch.zeros((4, 4, 3)),                         # not on CUDA
])
def test_gamma_cuda_refuses_what_the_kernel_does_not_take(bad):
    before = profiling.counter("launches.gamma")
    with pytest.raises(ValueError, match="gamma_cuda needs"):
        tonemap.gamma_cuda(bad)
    assert profiling.counter("launches.gamma") == before


def test_reference_is_within_ulps_of_numpys_power():
    """The kernel's twin (the power in double, rounded once) against
    numpy's float32 power: within MAX_ULP everywhere, equal at the edges
    np.maximum defines (NaN passes, negatives and -0.0 give +0)."""
    x = np.concatenate([_linear(64, 64, seed=3).ravel(), EDGES])
    got, numpy_f32 = tonemap.gamma_reference(x), _numpy_power(x)
    assert got.dtype == np.float32
    finite = ~np.isnan(x)
    assert _ulps(got[finite], numpy_f32[finite]).max() <= MAX_ULP
    edge = tonemap.gamma_reference(EDGES)
    assert np.isnan(edge[0]) and np.isnan(EDGES[0])
    assert not np.signbit(edge[1:]).any()        # -0.0, -1, -inf: +0
    assert (edge[1:5] == 0).all()
    assert edge[5] == np.inf and edge[12] == 1.0
    assert (edge[6:9] > 0).all() and np.isfinite(edge[6:]).all()
    assert tonemap.inv_gamma(tonemap.GAMMA) == np.float32(1 / 2.2)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cornell(cuda, size=600, spp=200, seed=7):
    world, camera, kw = presets.cornell_box(width=size, height=size)
    r = Renderer(spp, max_bounces=kw["max_bounces"],
                 background_color=kw["background"], seed=seed, device=cuda)
    return r, world, camera


@pytest.mark.cuda
def test_cornell_600_is_the_double_twin_bit_for_bit(cuda):
    """A Cornell 600x600 spp 200 render's Image.data is the twin of its
    linear framebuffer bit for bit, and within MAX_ULP of numpy's float32
    power (the histogram and the 8-bit values that differ are printed)."""
    r, world, camera = _cornell(cuda)
    fb = r.render_array(camera, world.build())
    lin = fb.cpu().numpy()
    before = profiling.counter("launches.gamma")
    img = r.render(camera, world)
    assert profiling.counter("launches.gamma") == before + 1
    assert img.data.dtype == np.float32 and img.data.shape == lin.shape
    assert _same_bits(img.data, tonemap.gamma_reference(lin))
    host = _numpy_power(lin)
    ulps = _ulps(img.data, host)
    hist = np.bincount(ulps.ravel())
    u8 = int((img.to_u8() != Image(host).to_u8()).sum())
    print(f"\n[gamma] Cornell 600x600 spp 200: ulp differences from numpy's "
          f"float32 power {dict(enumerate(hist.tolist()))} of {ulps.size}; "
          f"to_u8 bytes that differ: {u8}")
    assert ulps.max() <= MAX_ULP


@pytest.mark.cuda
@pytest.mark.parametrize("n, offset", [(3 * 4 * 5, 0), (3 * 3 * 3, 0),
                                       (3 * 1 * 1, 0), (3 * 7 * 5, 1),
                                       (3 * 600 * 600, 0), (3 * 37 * 29, 3)])
def test_kernel_is_the_twin_at_every_size_and_alignment(cuda, n, offset):
    """Random values and every edge value, in images whose element count
    leaves 0-3 values past the last float4 and whose start is 16-byte
    aligned or not (the kernel's float4 and scalar paths); the input is
    left as it was."""
    rng = np.random.default_rng(n + offset)
    x = (rng.standard_exponential(n) * 0.5 - 0.05).astype(np.float32)
    x[:min(n, EDGES.size)] = EDGES[:min(n, EDGES.size)]
    base = torch.zeros(n + offset, device=cuda)
    base[offset:] = torch.from_numpy(x).to(cuda)
    t = base[offset:].view(n // 3, 1, 3)
    keep = t.clone()
    got = tonemap.gamma_cuda(t).cpu().numpy().ravel()
    assert torch.equal(t.nan_to_num(7.0), keep.nan_to_num(7.0))
    assert _same_bits(got, tonemap.gamma_reference(x))


@pytest.mark.cuda
def test_batch_and_async_equal_render_and_count_launches(cuda):
    """render_batch's frames (one gamma launch over the stack) and
    render_async's result equal render's bit for bit; one gamma launch
    a render, a batch and a result; from_linear leaves its input as it
    was."""
    r, world, camera = _cornell(cuda, size=96, spp=8, seed=3)
    c = lambda: profiling.counter("launches.gamma")     # noqa: E731
    before = c()
    single = r.render(camera, world).data
    assert c() == before + 1
    frames = r.render_batch(camera, world, [11, 3])
    assert c() == before + 2
    np.testing.assert_array_equal(frames[1].data, single)
    assert not np.array_equal(frames[0].data, single)
    np.testing.assert_array_equal(r.render_async(camera, world).result().data,
                                  single)
    assert c() == before + 3
    fb = r.render_array(camera, world.build())
    keep = fb.clone()
    np.testing.assert_array_equal(Image.from_linear(fb).data, single)
    assert torch.equal(fb, keep) and c() == before + 4


@pytest.mark.cuda
def test_gamma_span_wraps_the_launch_on_the_card(cuda):
    """While tracing, a CUDA render's `tinyrt.render.gamma` span is the
    kernel's launch: one a render, before the readback, and the kernel
    runs inside the render's span."""
    from torch.profiler import ProfilerActivity, profile

    r, world, camera = _cornell(cuda, size=64, spp=4, seed=2)
    r.render(camera, world)                      # the library is loaded
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.render(camera, world)
        torch.cuda.synchronize()
    spans = profiling.snapshot()["spans"]
    assert spans["tinyrt.render.gamma"]["count"] == 1
    assert spans["tinyrt.render.readback"]["count"] == 1
    names = {e.key for e in prof.key_averages()}
    assert any("gamma_kernel" in n for n in names), sorted(names)
