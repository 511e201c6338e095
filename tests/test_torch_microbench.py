"""The measured-mix microbenchmark (utils/microbench.py, P5) and the share
it calibrates (utils/sol.py `pct_of_sol_measured`), on the CPU.

Each mix's twin against the probe's own op sequence
(scripts/probe_vpu_microbench.py:86-133, restated here and run eagerly in
jnp on the CPU, so that XLA fuses no a*b + c); the sphere and quad mixes,
the port's own sequences, against the twins of sphere_hit_t and
quad_hit_t (megakernel.sphere_ts, quad_ts), with a check that a wrong hit
distance changes their output. On the card, chip_smoke.py phase 22 and tests/test_torch_cuda.py hold the kernel
to the twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.utils import microbench as mb
from tinyraytracer_tpu_torch.utils import profiling, sol

THREADS = 4096          # under torch's 32768-element parallel grain
ITERS = 16
# fma: the twin fuses each multiply-add (one rounding), the probe's
# sequence rounds the product first: at most one ulp of drift a step,
# so ITERS ulps (measured: 4 at 16 iterations, 10 at 64).
FMA_VS_PROBE_ULP = ITERS
# transcendental: XLA's rsqrt is within 2 ulp of 1/sqrt (ROADMAP, parity
# notes), its exp and log against torch's; the chains contract, so the
# gap does not grow (measured: 2 ulps at 16 and at 64 iterations).
TRANSC_VS_PROBE_ULP = 4


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


# --- the probe's mixes (scripts/probe_vpu_microbench.py:86-133) -------------

def fma3(x, y, z):
    x = x * 1.0000001 + 0.1
    y = y * 0.9999999 + 0.1
    z = z * 1.0000002 + 0.1
    return x, y, z


def selmix(x, y, z):
    c = x < y
    x = jnp.where(c, x * 1.0000001 + 0.1, y)
    y = jnp.maximum(y * 0.9999999, z)
    z = z + 0.0000001
    return x, y, z


def transc(x, y, z):
    x = jax.lax.rsqrt(jnp.maximum(x * x + 0.1, 1e-6))
    y = (y + 1.2) / (x + 2.5)
    z = jnp.exp(jnp.log(jnp.maximum(z + 1.5, 1e-6)) * (1.0 / 3.0))
    return x, y, z


def _probe(body, x0: np.ndarray, iters: int) -> np.ndarray:
    """The probe's kernel body (run_mix, :43-55), eagerly."""
    x = jnp.asarray(x0)
    y = x * 1.0000001
    z = x * 0.9999999
    for _ in range(iters):
        x, y, z = body(x, y, z)
    return np.asarray(x + y + z)


@pytest.mark.parametrize("mix,body,ulp", [
    ("fma", fma3, FMA_VS_PROBE_ULP),
    ("select", selmix, 0),
    ("transcendental", transc, TRANSC_VS_PROBE_ULP)])
def test_twin_follows_the_probes_sequence(mix, body, ulp):
    x0 = mb.inputs(THREADS, seed=3)
    got = mb.microbench_reference(mix, x0, ITERS).numpy()
    want = _probe(body, x0.numpy(), ITERS)
    assert np.isfinite(got).all()
    assert _ulps(got, want) <= ulp


def test_sphere_mix_is_sphere_hit_t_and_the_fold():
    """Each chain v runs sphere_ts of the origin (v, v, v) and keeps the
    running minimum, bit for bit; every test hits (disc > 0, off IEEE
    sqrt's slow path) beyond the origin, so the chains stay put, and the
    output adds the last hit distances."""
    x0 = mb.inputs(THREADS, seed=4)
    k = torch.tensor(mb.constants("sphere"), dtype=torch.float32).unbind()
    sph = torch.stack(k[2:6])[None]
    x, y, z = x0, x0 * k[0], x0 * k[1]
    for _ in range(ITERS):
        chains, hits = [], []
        for v in (x, y, z):
            ts = mk.sphere_ts(sph, v, v, v, k[6], k[7], k[8])[0]
            assert bool((ts < mk.MISS).all()) and bool((ts > v).all())
            chains.append(torch.minimum(ts, v))
            hits.append(ts)
        x, y, z = chains
    got = mb.microbench_reference("sphere", x0, ITERS)
    assert torch.equal(got, x + y + z + hits[0] + hits[1] + hits[2])
    assert torch.equal(x + y + z, x0 + x0 * k[0] + x0 * k[1])


def test_quad_mix_is_quad_hit_t_and_the_fold():
    """Chain x tests quad row 0 from (x, x, x) along (y, y, y), y row 1
    along z, z row 2 along x (the updated one); each keeps the running
    minimum, bit for bit with quad_ts. Every test hits beyond the origin,
    with planar coordinates well inside [0, 1), and the output adds the
    last hit distances."""
    x0 = mb.inputs(THREADS, seed=6)
    k = torch.tensor(mb.constants("quad"), dtype=torch.float32).unbind()
    rows = [torch.stack(k[2 + 12 * r:14 + 12 * r])[None] for r in range(3)]
    x, y, z = x0, x0 * k[0], x0 * k[1]
    for _ in range(ITERS):
        tx = mk.quad_ts(rows[0], x, x, x, y, y, y)[0]
        x = torch.minimum(tx, x)
        ty = mk.quad_ts(rows[1], y, y, y, z, z, z)[0]
        y = torch.minimum(ty, y)
        tz = mk.quad_ts(rows[2], z, z, z, x, x, x)[0]
        z = torch.minimum(tz, z)
        for t, v in ((tx, x), (ty, y), (tz, z)):
            assert bool((t < mk.MISS).all()) and bool((t > v).all())
    got = mb.microbench_reference("quad", x0, ITERS)
    assert torch.equal(got, x + y + z + tx + ty + tz)
    assert torch.equal(x + y + z, x0 + x0 * k[0] + x0 * k[1])


def _far_root(sph, ox, oy, oz, dx, dy, dz):
    ocx, ocy, ocz = ox - sph[:, 0:1], oy - sph[:, 1:2], oz - sph[:, 2:3]
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - sph[:, 3:4]
    return -half_b + torch.sqrt(half_b * half_b - c)


def _scaled(f, s):
    return lambda *a: f(*a) * s


def _missing(f):
    return lambda *a: torch.full_like(f(*a), mk.MISS)


@pytest.mark.parametrize("mix,name,wrong", [
    ("sphere", "sphere_ts", _far_root),
    ("sphere", "sphere_ts", _scaled(mk.sphere_ts, 1.0000002)),
    ("sphere", "sphere_ts", _missing(mk.sphere_ts)),
    ("quad", "quad_ts", _scaled(mk.quad_ts, 1.0000002)),
    ("quad", "quad_ts", _missing(mk.quad_ts)),
    ("quad", "quad_ts", _scaled(mk.quad_ts, float("nan")))],
    ids=["sphere-far-root", "sphere-t-off-by-ulps", "sphere-miss",
         "quad-t-off-by-ulps", "quad-miss", "quad-nan"])
def test_a_wrong_hit_distance_changes_the_candidate_output(
        mix, name, wrong, monkeypatch):
    """The candidate mixes' output carries the row's result: a row that
    returns the far root, a t a few ulps off, MISS or NaN gives other
    bits in every thread, so holding the kernel to the twin catches it."""
    x0 = mb.inputs(256, seed=7)
    right = mb.microbench_reference(mix, x0, 8)
    monkeypatch.setattr(mb, name, wrong)
    got = mb.microbench_reference(mix, x0, 8)
    assert bool((got.view(torch.int32) != right.view(torch.int32)).all())


def test_chains_stay_finite_and_normal_over_a_long_run():
    x0 = mb.inputs(64, seed=5)
    for mix in mb.MIXES:
        out = mb.microbench_reference(mix, x0, 2000)
        assert bool(torch.isfinite(out).all()), mix
        assert float(out.abs().min()) > 1.0, mix


def test_wrapper_runs_the_twin_on_the_cpu_and_checks_its_input():
    x0 = mb.inputs(32)
    before = profiling.counter("launches.microbench")
    for mix in mb.MIXES:
        assert torch.equal(mb.microbench(mix, x0, 8),
                           mb.microbench_reference(mix, x0, 8))
    assert profiling.counter("launches.microbench") == before   # no kernel
    with pytest.raises(ValueError, match="multiple of 4"):
        mb.microbench("fma", x0, 6)
    with pytest.raises(ValueError, match="unknown mix"):
        mb.microbench("sqrt", x0, 4)
    with pytest.raises(ValueError, match="1-D float32"):
        mb.microbench("fma", x0.double(), 4)
    with pytest.raises(ValueError, match="CUDA device"):
        mb.measure("cpu")


def test_counts_are_sol_units():
    """fma: 3 fused multiply-adds at 2; select: compare, multiply, add,
    multiply, max, add (the select uncounted); sphere: 3 candidate rows;
    transcendental: (mul, add, max, sqrt, div) + (add, add, div) + (add,
    max, log, mul, exp); quad: 3 candidate rows."""
    assert mb.OPS_PER_ITER == {"fma": 6, "select": 6, "sphere": 72,
                               "transcendental": 13, "quad": 135}
    assert mb.OPS_PER_ITER["sphere"] == 3 * sol.OPS_SPHERE_ROW
    assert mb.OPS_PER_ITER["quad"] == 3 * sol.OPS_QUAD_ROW
    assert all(len(mb.constants(m)) == mb.N_CONSTS for m in mb.MIXES)
    # one wave of 132 SMs x 2048 threads at the probe's 2 000 iterations
    ms, by = sol.microbench_bound(270336, 2000, 72)
    assert by == "operations"
    assert ms == pytest.approx(270336 * 2000 * 72 / 67e12 * 1e3)


def test_pct_of_sol_measured_by_hand():
    """cornell_box (18 quads, no metal or dielectric) at 6.6 executed
    bounces: 6.6 x 18 x 45 candidate operations at the quad mix's rate,
    62 + 6.6 x 108 at the transcendental mix's."""
    rate = 1.5e9
    want = rate * (6.6 * 18 * 45 / sol.QUAD_COUNTED_OPS_PER_SEC
                   + (62 + 6.6 * 108) / sol.FIXED_COUNTED_OPS_PER_SEC)
    assert sol.pct_of_sol_measured(rate, 0, 18, 6.6) == pytest.approx(want,
                                                                      rel=1e-12)
    # every lobe, spheres and quads
    want = 2e8 * (2.0 * 3 * 24 / sol.CAND_COUNTED_OPS_PER_SEC
                  + 2.0 * 45 / sol.QUAD_COUNTED_OPS_PER_SEC
                  + (62 + 2.0 * 178) / sol.FIXED_COUNTED_OPS_PER_SEC)
    assert sol.pct_of_sol_measured(2e8, 3, 1, 2.0, has_met=True,
                                   has_die=True) == pytest.approx(want,
                                                                  rel=1e-12)
    # the measured ceiling sits below the data sheet's: a larger share
    assert sol.pct_of_sol_measured(rate, 0, 18, 6.6) > sol.pct_of_sol(
        rate, 0, 18, 6.6)


def test_pct_of_sol_measured_raises_outside_0_1():
    with pytest.raises(ValueError, match="outside"):
        sol.pct_of_sol_measured(1e11, 0, 18, 6.6)
    with pytest.raises(ValueError, match="outside"):
        sol.pct_of_sol_measured(0.0, 0, 18, 6.6)
    with pytest.raises(ValueError, match="outside"):
        sol.pct_of_sol_measured(-1.0, 0, 18, 6.6)
    # the largest rate with a share of at most 1
    top = 1.0 / (6.6 * 810 / sol.QUAD_COUNTED_OPS_PER_SEC
                 + (62 + 6.6 * 108) / sol.FIXED_COUNTED_OPS_PER_SEC)
    assert 0.999 < sol.pct_of_sol_measured(top * 0.9999, 0, 18, 6.6) <= 1.0


def test_probe_script_needs_a_card_and_imports_no_jax():
    """scripts/torch_probe_vpu_microbench.py: with no CUDA it exits 1 and
    prints no line; with jax unimportable its main still loads, and
    neither JAX nor the JAX package gets imported."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "scripts", "torch_probe_vpu_microbench.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, script], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "is_available() is false" in proc.stderr
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        f"spec = importlib.util.spec_from_file_location('p', {script!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "try:\n"
        "    m.main()\n"
        "except SystemExit as e:\n"
        "    print('exit', bool(e.code))\n"
        "bad = [k for k in sys.modules if k == 'tinyraytracer_tpu' or "
        "k.startswith(('tinyraytracer_tpu.', 'jax.', 'jaxlib'))]\n"
        "print('bad', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.split("\n")[:2] == ["exit True", "bad []"], (
        proc.stdout, proc.stderr)
