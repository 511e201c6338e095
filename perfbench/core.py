"""The benchmark harness: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell is comes from data found by name:

- `BENCHMARK.json` (the checkout's root): the cell's configuration and
  traffic, and the metrics it reports;
- `perfbench/configs/<config>.json` (the manifest's `file`): the scene;
- `perfbench/workloads/<cell>.json`: the traffic's parameters (sizes,
  samples, bounces, trainable scope, the check's sample and limits);
- `perfbench/traffic/<traffic>.py`: the generator of the traffic kind,
  a `Cell` class (see traffic/render.py);
- `perfbench/layer_metrics/<metric>.py`: a `read(ctx)` per per-layer
  metric, None where it finds nothing to read.

A run: set-up (imports, the system's build, the scene, the cell's warm
requests), then a closed loop of requests, one client sending the next
when the last returns, until `--seconds` have passed (the window ends
when its last request returns, and every request started is counted),
then the correctness check against the plain reference. With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics from a profiler trace of the window.
The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyraytracer_tpu")
WINDOW_SPAN = "perfbench.window"     # tracing.WINDOW
REQUEST_SPAN = "perfbench.request"   # tracing.REQUEST


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    if not path.is_file():
        raise BenchError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """A cell as the manifest and its files give it."""

    name: str
    entry: dict
    config: dict
    params: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    return Cell(
        name=name, entry=entry, config=load_json(root / cfg_entry["file"]),
        params=load_json(root / HERE.name / "workloads" / f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def traffic_class(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py",
                       f"perfbench_traffic_{kind}").Cell


# --- the window --------------------------------------------------------------

@dataclasses.dataclass
class Window:
    seconds: float          # from the first request's start to the last's end
    latencies: list         # seconds of each request, in order
    work: float             # the work of every request (the cell's unit)
    failed: int = 0

    @property
    def attempted(self) -> int:
        return len(self.latencies)

    def rate(self) -> float:
        """All the work over all the window's time."""
        return self.work / self.seconds

    def percentile_ms(self, q: float) -> float:
        """The q-th percentile of every request's latency (nearest rank:
        the smallest latency that q percent of the requests do not
        exceed)."""
        lat = sorted(self.latencies)
        k = max(1, math.ceil(q / 100.0 * len(lat)))
        return 1e3 * lat[k - 1]


def run_window(request, work_per_request: float, seconds: float,
               clock=time.perf_counter, on_error=None) -> Window:
    """Closed loop, one client: request(i) for i = 0, 1, ... until
    `seconds` have passed since the first started. A request that raises
    counts as failed (its time is kept) and `on_error` sees the
    exception."""
    lat, failed = [], 0
    t_start = t1 = clock()
    i = 0
    while True:
        t0 = clock()
        try:
            request(i)
        except Exception as e:      # a failed request is counted, not fatal
            failed += 1
            if on_error is not None:
                on_error(e)
        t1 = clock()
        lat.append(t1 - t0)
        i += 1
        if t1 - t_start >= seconds:
            break
    return Window(seconds=t1 - t_start, latencies=lat,
                  work=work_per_request * (i - failed), failed=failed)


# --- end-to-end metrics -------------------------------------------------------

def end_to_end_value(name: str, win: Window, setup_s: float,
                     peak_bytes: int) -> float:
    """The value of an end-to-end metric named in BENCHMARK.json. Each
    rate is all the work of the window over all its time; a tail is
    that of every request."""
    if name == "setup_s":
        return setup_s
    if name.endswith("_mrays_s"):
        return win.rate() / 1e6
    if name.endswith("_ms_p95"):
        return win.percentile_ms(95.0)
    if name.endswith("_peak_gib"):
        return peak_bytes / 2.0 ** 30
    raise BenchError(f"no rule for the end-to-end metric {name!r}")


# --- device and environment ---------------------------------------------------

def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, the machine has "
                         f"{torch.cuda.device_count()}")


def power_limit_w() -> float | None:
    """The card's power limit (nvidia-smi), None where it is unreadable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split("\n")[0])
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def loaded_forbidden(modules=None) -> list:
    """Top-level module names (the part before the first dot, compared
    whole) of FORBIDDEN found in `modules` (default: sys.modules)."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None
                                      else modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = root / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


# --- one run -----------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What a per-layer reader gets: the cell, its traffic object, the
    trace's analysis and the window."""

    cell: Cell
    traffic: object
    trace: object
    window: Window


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: float | None = None) -> dict:
    """One run of `cell`; returns the result object. `device` "cpu" runs
    the system's plain twins (for the tests; the card is the benchmark's
    device)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    traffic = traffic_class(cell.entry["traffic"])(
        cell.config, cell.params, seed=seed, device=device)
    traffic.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _log(f"set-up {setup_s:.3f} s")

    errors = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    def request(i):
        with torch.profiler.record_function(REQUEST_SPAN):
            traffic.request(i)

    try:
        with torch.profiler.record_function(WINDOW_SPAN):
            win = run_window(request, traffic.work_per_request(), seconds,
                             on_error=errors.append)
    finally:
        if prof is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            prof.stop()
    if errors:
        _log(f"{len(errors)} requests failed; the first: {errors[0]!r}")
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)

    analysis = None
    if trace:
        from perfbench import tracing

        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            _log(f"trace of {os.path.getsize(path)} bytes")
            analysis = tracing.analyze(path)
        finally:
            os.unlink(path)
    traffic.release()
    checks = traffic.check()
    correct = (win.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": end_to_end_value(m["name"], win, setup_s, peak),
                "unit": m["unit"]}
    else:
        ctx = Context(cell=cell, traffic=traffic, trace=analysis, window=win)
        for m in cell.per_layer:
            reader = load_module(HERE / "layer_metrics" / f"{m['name']}.py",
                                 f"perfbench_layer_{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name() if device == "cuda"
                    else "cpu"),
           "count": cell.entry.get("chips", 1),
           "memory_peak_bytes": int(peak)}
    if device == "cuda":
        dev["power_limit_w"] = power_limit_w()
    if analysis is not None:
        dev["busy_s"] = analysis.busy_s
        dev["window_s"] = analysis.window_s
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if analysis is not None:
        result["breakdown"] = {"device_ops": analysis.device_ops,
                               "idle_gaps": analysis.idle_gaps}
    result["checks"] = checks
    return result


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    try:
        set_cache_dirs()
        cell = find_cell(args.workload)
        check_card(int(cell.entry.get("chips", 1)))
        result = run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), t0=t0)
        found = loaded_forbidden()
        if found:
            raise BenchError(f"the run loaded {found}")
    except BenchError as e:
        _log(f"perfbench: {e}")
        return 2
    for name, c in result["checks"].items():
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
