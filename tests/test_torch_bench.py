"""bench_torch.py, the port's bench.py, on the CPU at small sizes: its
line's keys against bench.py's (read from bench.py's syntax tree, with no
JAX import and no JAX run), every section's rates and routes, a failed
section, the north star's step limit; and the import rule (neither
bench_torch.py nor utils/sol.py imports JAX or the JAX package). On the
card, chip_smoke.py phase 21 runs the bench at full size."""

import ast
import contextlib
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import bench_torch as bt
from tinyraytracer_tpu_torch.ops import diffkernel as dk
from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp
from tinyraytracer_tpu_torch.ops import intersect_kernel as ik
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Each section at a small size: the same code as bench.py's sizes (an
# all-fields Cornell step at 16x16 is the full surrogate scope), small
# enough for the twins on the CPU.
CONFIGS = [(k, p, 8, 6, 2, 3) for k, p, *_ in bt.FWD_CONFIGS]
SIZES = dict(
    forward=dict(burst=2, estimate=(8, 8, 1)),
    large_n=dict(width=8, height=6, spp=1, spp_large=2, max_bounces=3, n=60),
    fwdbwd=dict(width=16, height=16, spp=2, max_bounces=2, steps=2),
    northstar=dict(width=12, height=12, spp=4, max_bounces=2, steps=1),
    diff_large=dict(width=12, height=10, spp=1, max_bounces=2, n=24, rows=2,
                    steps=1))
# The twins' runs of one small line: configs 1-3 a warm-up and 3 renders
# (K1 12) and config 1's 4 bursts of 2 (K1 8); config 4 (K2 4) and 4b's
# two renderers (K2 6); the Cornell estimate, 1 sample of 3 bounces (K3
# 3); the 16x16 step 1 + 2, the north star's warm-up and step 1 + 1,
# its config-5 shaped step 1 + 1 (K5 7); the cfg4-class step 1 + 1 (K4
# 2).
RUNS = {"K1": 20, "K2": 10, "K3": 3, "K4": 2, "K5": 7}


@contextlib.contextmanager
def counted_twins():
    """Counts each kernel's plain twin run through its wrapper on a CPU
    tensor, and hands the counts to bench_torch as its `runs`, so its
    route checks hold on the CPU as on the card. K1-K3's twins are
    wrapped where their wrappers look them up; K4 and K5 share a twin, so
    their wrappers are wrapped where the train step looks them up."""
    counts = dict.fromkeys(bt.KERNELS, 0)

    def counting(kid, fn):
        def run(*a, **k):
            tensor = next(x for x in a if isinstance(x, torch.Tensor))
            if tensor.device.type == "cpu":
                counts[kid] += 1
            return fn(*a, **k)
        return run

    with pytest.MonkeyPatch.context() as mp:
        for kid, mod, name in (
                ("K1", mkp, "render_packed_reference"),
                ("K2", mk, "render_flat_reference"),
                ("K3", ik, "closest_hit_reference"),
                ("K4", dk, "classic_diff"), ("K5", dkp, "packed_diff")):
            mp.setattr(mod, name, counting(kid, getattr(mod, name)))
        mp.setattr(bt, "runs", lambda device: dict(counts))
        yield counts


def _small(**over):
    return bt.collect("cpu", **{"configs": CONFIGS, **SIZES, **over})


@pytest.fixture(scope="module")
def line():
    with counted_twins() as counts:
        out = _small()
    return out, counts


def bench_py_keys() -> set:
    """Every key bench.py's line can hold but its `_error` keys, read off
    bench.py's syntax tree: `result[...] = ` with a constant, a config key
    or a config key plus a constant (under `if key.startswith(p)` only
    the configs it admits), `result.update(k=...)` and the dict literal
    that starts `result`."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    configs = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "FWD_CONFIGS")

    def config_keys(node):
        keys = [c[0] for c in configs]
        while node in parents:
            node, child = parents[node], node
            t = getattr(node, "test", None)
            if (isinstance(node, ast.If) and child in node.body
                    and isinstance(t, ast.Call)
                    and getattr(t.func, "attr", None) == "startswith"):
                keys = [k for k in keys if k.startswith(t.args[0].value)]
        return keys

    def in_handler(node):
        while node in parents:
            node = parents[node]
            if isinstance(node, ast.ExceptHandler):
                return True
        return False

    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and getattr(node.value, "id", None) == "result"
                and not in_handler(node)):
            s = node.slice
            if isinstance(s, ast.Constant):
                keys.add(s.value)
            elif isinstance(s, ast.Name):
                keys.update(config_keys(node))
            else:
                assert isinstance(s, ast.BinOp) and isinstance(s.op, ast.Add)
                keys.update(k + s.right.value for k in config_keys(node))
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "update"
              and getattr(node.func.value, "id", None) == "result"):
            keys.update(k.arg for k in node.keywords)
        elif (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
              and getattr(node.targets[0], "id", None) == "result"):
            keys.update(k.value for k in node.value.keys)
    return keys


def test_keys_are_bench_py_keys_with_the_stated_exceptions(line):
    jax_keys = bench_py_keys()
    assert len(jax_keys) == 36 and "cfg1_dispatch_overhead_ms" in jax_keys
    want = ({k.replace("_vpu_roofline", "_fp32_roofline") for k in jax_keys}
            | {"device_name", "power_limit_w"})
    assert "pct_sol_cornell_vs_measured_mix" in want
    assert bt.KEYS == want
    assert set(line[0]) == want


def test_every_section_runs_its_kernel_with_positive_rates(line):
    out, runs = line
    assert bt.problems(out) == []
    assert runs == RUNS
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    for k, v in out.items():
        if k.startswith("pct_sol_"):
            assert 0.0 < v <= 1.0, k
    assert math.isfinite(out["cfg1_dispatch_overhead_ms"])
    assert out["value"] == out["cfg3_cornell_600x600_spp200"]
    assert out["vs_baseline"] == out["value"] / bt.BASELINE_RAYS_PER_SEC
    assert 1.0 <= out["cornell_mean_executed_bounces"] <= 3.0


def test_measured_mix_share_is_cornells_rate_over_the_cards_ceiling(line):
    """pct_sol_cornell_vs_measured_mix: config 3's rate and executed
    bounces against utils/sol.py's measured-mix ceiling (cornell_box: 18
    real quads, no metal or dielectric), above the FP32 share, whose
    denominator is out of reach."""
    from tinyraytracer_tpu_torch.utils import sol

    out, _ = line
    key = "cfg3_cornell_600x600_spp200"
    assert out["pct_sol_cornell_vs_measured_mix"] == sol.pct_of_sol_measured(
        out[key], 0, 18, out["cornell_mean_executed_bounces"])
    assert (out["pct_sol_cornell_vs_measured_mix"]
            > out["pct_sol_cornell_fp32_roofline"])


def test_a_silent_reroute_fails_the_section(monkeypatch):
    """Config 4b's scene at 40 spheres renders on K1, and an all-fields
    step routed off K5 runs K4: each section raises, not times it."""
    cpu = bt.resolve_device("cpu")
    with counted_twins():
        with pytest.raises(RuntimeError, match="expected 6 runs of K2"):
            bt.bench_large_n({}, cpu, **dict(SIZES["large_n"], n=40))
        monkeypatch.setattr(dk, "routes_packed", lambda st, bg: False)
        with pytest.raises(RuntimeError, match="runs of K5 .* 'K4': 3"):
            bt.bench_fwdbwd({}, cpu, **SIZES["fwdbwd"])


def test_a_failed_section_is_recorded_and_fails_the_line(monkeypatch,
                                                         capsys):
    def broken(*a, **k):
        raise ValueError("no card")

    monkeypatch.setattr(bt, "bench_diff_large", broken)
    out = _small(configs=CONFIGS[:1])
    assert out["fwdbwd_cfg4class_error"] == "ValueError: no card"
    assert "fwdbwd_cfg4class_512sph_step_ms" not in out
    bad = bt.problems(out)
    assert "fwdbwd_cfg4class_error: ValueError: no card" in bad
    assert "missing fwdbwd_cfg4class_512sph_step_ms" in bad
    assert "missing pct_sol_cornell_fp32_roofline" in bad
    monkeypatch.setattr(bt, "collect", lambda device: out)
    assert bt.main(["--device", "cpu"]) is out
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out


def test_problems_flags_bad_numbers():
    good = {k: 1.0 for k in bt.KEYS}
    good.update(device="cuda", cfg1_dispatch_overhead_ms=-0.01)
    assert bt.problems(good) == []
    assert bt.problems({**good, "pct_sol_cornell_fp32_roofline": 1.2}) == [
        "pct_sol_cornell_fp32_roofline = 1.2 is outside (0, 1]"]
    assert bt.problems({**good, "fwdbwd_step_ms": 0.0}) == [
        "fwdbwd_step_ms = 0.0 is not positive"]
    assert bt.problems({**good, "power_limit_w": None}) == [
        "power_limit_w = None is not a finite number"]


def test_northstar_over_the_step_limit_fails(monkeypatch):
    """An all-fields north-star step over STEP_LIMIT_S (PERF.md section
    2) fails the section, which records no time."""
    monkeypatch.setattr(bt, "STEP_LIMIT_S", 1e-9)
    out = {}
    with pytest.raises(RuntimeError, match="over STEP_LIMIT_S"):
        bt.bench_northstar(out, bt.resolve_device("cpu"),
                           **SIZES["northstar"])
    assert out == {}


def test_bench_and_sol_import_no_jax():
    """With jax unimportable, bench_torch and utils/sol import and run a
    small section (config 3 with its executed-bounce estimate), and
    neither JAX nor the JAX package gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import bench_torch\n"
        "from tinyraytracer_tpu_torch.utils import sol\n"
        "out = {}\n"
        "bench_torch.bench_forward(out, bench_torch.resolve_device('cpu'),\n"
        "    ('cfg3', 'cornell_box', 6, 4, 1, 2), estimate=(4, 4, 1))\n"
        "assert 0 < out['pct_sol_cornell_fp32_roofline'] <= 1\n"
        "bad = [m for m in sys.modules if m == 'tinyraytracer_tpu' or "
        "m.startswith(('tinyraytracer_tpu.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
