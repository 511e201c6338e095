"""PyTorch port's RNG against the JAX package's.

Inputs are made with numpy and fed to both packages. The hash words must
be bitwise equal (int64 masked to 32 bits in the port, u32 in JAX); the
samplers agree to 2 ulp at unit scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.ops import megakernel as jmk
from tinyraytracer_tpu.ops import rng as jrng
from tinyraytracer_tpu_torch.ops import rng as trng

# Counters near 0, around 2^31 and up to 2^32 - 1, plus random ones.
_EDGE = np.array([0, 1, 2, 255, 256, 2**24 - 1, 2**31 - 1, 2**31, 2**31 + 1,
                  2**32 - 2, 2**32 - 1], np.uint64)


def _grid(seed: int):
    r = np.random.default_rng(seed)
    rand = r.integers(0, 2**32, size=(3, 400), dtype=np.uint64)
    pix = np.concatenate([_EDGE, rand[0]])
    samp = np.concatenate([_EDGE[::-1], rand[1]])
    stream = np.concatenate([_EDGE, rand[2]])
    return pix.astype(np.uint32), samp.astype(np.uint32), stream.astype(
        np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**32 - 1])
def test_pcg4d_and_uniform4_bitwise(seed):
    pix, samp, stream = _grid(seed % 1000)
    want = jrng.pcg4d(jnp.asarray(pix), jnp.asarray(samp),
                      jnp.asarray(stream), jnp.uint32(seed))
    got = trng.pcg4d(torch.from_numpy(pix.astype(np.int64)),
                     torch.from_numpy(samp.astype(np.int64)),
                     torch.from_numpy(stream.astype(np.int64)), seed)
    for w, g in zip(want, got):
        g = g.numpy()
        assert g.min() >= 0 and g.max() < 2**32
        np.testing.assert_array_equal(g.astype(np.uint32), np.asarray(w))

    tp = torch.from_numpy(pix.astype(np.int64))
    ts = torch.from_numpy(samp.astype(np.int64))
    tst = torch.from_numpy(stream.astype(np.int64))
    got_u = trng.uniform4(seed, tp, ts, tst)
    want_rng = jrng.uniform4(jnp.uint32(seed), jnp.asarray(pix),
                             jnp.asarray(samp), jnp.asarray(stream))
    want_mk = jmk._uniform4(jnp.asarray(pix), jnp.asarray(samp),
                            jnp.asarray(stream), jnp.uint32(seed))
    for g, a, b in zip(got_u, want_rng, want_mk):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(a))
        np.testing.assert_array_equal(g.numpy(), np.asarray(b))


def test_pcg4d_broadcasts_python_ints():
    """Scalar counters broadcast against tensors, as in the JAX package."""
    pix = np.arange(64, dtype=np.uint32)
    want = jrng.uniform4(jnp.uint32(9), jnp.asarray(pix), jnp.uint32(3),
                         jnp.uint32(2))
    got = trng.uniform4(9, torch.arange(64), 3, 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# Both sides evaluate the same formulas; sin, cos, exp and log differ by
# up to 1 ulp between the two frameworks' CPU libraries. Every output lies
# in [-1, 1], so the bound is 2 ulp at unit scale: |d| <= 2 * 2^-23.
# Measured on 200k draws: max |d| 1.8e-7 (ball), 1.2e-7 (unit vector and
# disk), 6.0e-8 (cbrt). Per value, cbrt's exp(log(x)/3) amplifies log's
# 1-ulp difference by |log x|/3 (up to 7 ulp of a small result).
_UNIT_ULP2 = 2 * 2.0**-23


@pytest.mark.parametrize("fn, nargs", [
    ("uniform_in_unit_sphere", 3),
    ("uniform_unit_vector", 2),
    ("uniform_in_unit_disk", 2),
    ("cbrt", 1),
])
def test_samplers_agree(fn, nargs):
    r = np.random.default_rng(11)
    # Each framework gets its own copy of each input. Sizes stay under
    # PyTorch's 32768-element parallel grain (outputs included), so every
    # torch op runs on the calling thread: with JAX initialised in the
    # same process, the first multi-threaded torch op of a process was
    # seen to compute one thread's chunk wrongly (1 process in 40,
    # relative error ~4e-5).
    u = [r.random(10_000, dtype=np.float32) for _ in range(nargs)]
    want = np.array(getattr(jrng, fn)(*[jnp.array(x) for x in u]))
    got = getattr(trng, fn)(*[torch.tensor(x) for x in u]).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=_UNIT_ULP2)
