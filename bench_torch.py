#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (tinyraytracer_tpu_torch): bench.py's
configs on one NVIDIA GPU, one JSON line.

    python3 bench_torch.py                 # on the card, cuda:0
    python3 bench_torch.py --device cpu    # the kernels' plain twins

Section for section the port of bench.py, with its configs, warm-ups and
best-of counts: BASELINE configs 1-4 through `MegakernelRenderer` (best of
3; config 1 also as a burst of 8 seeds), config 4b (8 000 spheres) at
spp=16 and 64 through the public `Renderer` (best of 2), and the fused
train steps (`make_fused_train_step`): cornell_box 300x300 spp=16 mb=8
with every field trainable (5 timed steps), the north star, cornell_box
600x600 spp=200 mb=20 with every field trainable, and the config-5
shaped cornell_spheres step training sph_center + mat_albedo (2 timed
steps each), and the 512-sphere step with `trainable_rows` (3 timed
steps). The roofline shares come from tinyraytracer_tpu_torch/utils/sol.py.

The line has bench.py's keys, with these differences:
- `*_vpu_roofline` is `*_fp32_roofline`: a share of the H100's FP32 peak
  (utils/sol.py), not of a TPU's VPU.
- `pct_sol_cornell_vs_measured_mix` sets config 3's rate against the
  card's own measured mix (utils/sol.py `pct_of_sol_measured`, whose two
  rates scripts/torch_probe_vpu_microbench.py measures on the card), not
  the TPU's.
- Added: `device_name` and `power_limit_w` (nvidia-smi's name and
  power.limit).
- `device` is the torch device type, and no number is rounded.

Timed windows: a render ends with `torch.cuda.synchronize(device)`, a
train step with a host read of its loss (`float(loss)`, bench.py:210-215).
The first call of each section builds the kernels and is not timed. An
all-fields north-star step over STEP_LIMIT_S seconds fails its section
(PERF.md section 2's limit) rather than being timed at a smaller spp.

On a CUDA device each section checks with the kernels' launch counters
that it ran the kernel it measures and no other, as many times as it
called it (on the CPU the wrappers run their plain twins and launch
nothing, so there `runs` has nothing to check): K1 for configs 1-3 and the
burst, K2 for configs 4 and 4b, K5 for the three Cornell steps, K4 for
the 512-sphere step. A section that fails is recorded as `<key>_error`
and the run carries on, so the line still prints; the script then exits
with status 1, as it does when a rate is not positive or a share is
outside (0, 1].
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import torch

from tinyraytracer_tpu_torch.diff.inverse import make_fused_train_step
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.ops import diffkernel as dk
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.renderer import Renderer
from tinyraytracer_tpu_torch.utils import profiling, sol
from tinyraytracer_tpu_torch.utils.device import resolve_device

BASELINE_RAYS_PER_SEC = 1.0e7  # bench.py's estimate of the reference CPU

# (key, preset, width, height, spp, max_bounces): BASELINE.md configs 1-4.
FWD_CONFIGS = (
    ("cfg1_sphere_ground_400x225_spp16", "sphere_ground", 400, 225, 16, 8),
    ("cfg2_three_spheres_400x225_spp100", "three_spheres", 400, 225, 100, 50),
    ("cfg3_cornell_600x600_spp200", "cornell_box", 600, 600, 200, 20),
    ("cfg4_random_spheres_1200x675_spp500", "random_spheres",
     1200, 675, 500, 50),
)
# The kernel each forward preset renders on: at most 48 primitives take
# K1 (megakernel_packed.PACKED_MAX_PRIMS), more take K2.
FWD_KERNEL = {"sphere_ground": "K1", "three_spheres": "K1",
              "cornell_box": "K1", "random_spheres": "K2"}
# PERF.md section 2: the longest train step a section may time.
STEP_LIMIT_S = 60.0

# Every key of the line.
KEYS = frozenset(
    [k + s for k, *_ in FWD_CONFIGS for s in ("", "_wall_s")]
    + ["device", "device_name", "power_limit_w",
       "cfg1_sphere_ground_400x225_spp16_burst8_per_image",
       "cfg1_dispatch_overhead_ms", "cornell_mean_executed_bounces",
       "pct_sol_cornell_fp32_roofline", "pct_sol_cornell_vs_measured_mix",
       "cfg4b_random8000_400x225_spp16",
       "cfg4b_random8000_400x225_spp16_wall_s",
       "cfg4b_random8000_400x225_spp64",
       "fwdbwd_rays_per_sec", "fwdbwd_step_ms",
       "pct_sol_fwdbwd_fp32_roofline", "fwdbwd_config",
       "cfg5_inverse_render_fwdbwd_rays_per_sec",
       "fwdbwd_northstar_cornell600_spp200_mb20", "fwdbwd_northstar_step_s",
       "pct_sol_fwdbwd_northstar_fp32_roofline",
       "fwdbwd_northstar_cfg5_cornell600_spp200_mb20",
       "fwdbwd_northstar_cfg5_step_s", "fwdbwd_northstar_cfg5_config",
       "fwdbwd_cfg4class_512sph_rays_per_sec",
       "fwdbwd_cfg4class_512sph_step_ms", "fwdbwd_cfg4class_512sph_config",
       "metric", "value", "unit", "vs_baseline", "baseline_estimate"])
# Numbers that may be zero or negative (a difference).
SIGNED = frozenset(["cfg1_dispatch_overhead_ms"])

# The kernels' wrappers, by the ids the repository's documents use.
KERNELS = {"K1": "render_packed", "K2": "render_flat", "K3": "closest_hit",
           "K4": "classic_diff", "K5": "packed_diff"}


def runs(device) -> dict | None:
    """Each kernel's wrapper's launches on a CUDA device (the host
    counters `launches.<wrapper>`, utils/profiling.py); None on the CPU,
    where no kernel launches."""
    if device.type != "cuda":
        return None
    return {k: profiling.counter(f"launches.{name}")
            for k, name in KERNELS.items()}


@contextlib.contextmanager
def on_route(device, kernel: str, count: int):
    """Raises unless the enclosed code ran `kernel` exactly `count` times
    and no other kernel: a silent re-route is an error, not a time."""
    before = runs(device)
    yield
    if before is None:
        return
    got = {k: v - before[k] for k, v in runs(device).items()}
    want = {k: count if k == kernel else 0 for k in got}
    if got != want:
        raise RuntimeError(f"expected {count} runs of {kernel} and none of "
                           f"another kernel, counted {got}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(f, n=3):
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        f(i + 1)
        times.append(time.perf_counter() - t0)
    return min(times)


def _timed_steps(step, state, n):
    """`n` steps after the warm-up (step 0), each ended by a host read of
    its loss; returns the state and the fastest step's seconds."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        p, o, loss = step(*state, i + 1)
        float(loss)
        times.append(time.perf_counter() - t0)
        state = (p, o)
    return state, min(times)


def _warm(step, state, device):
    p, o, _ = step(*state, 0)
    _sync(device)
    return p, o


def card(device) -> dict:
    """The device's name and power limit (watts): nvidia-smi's
    `name,power.limit` for a CUDA device, None for the CPU's limit."""
    if device.type != "cuda":
        return {"device_name": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    name, limit = torch.cuda.get_device_name(index), None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        smi_name, smi_limit = out.stdout.strip().splitlines()[0].rsplit(",",
                                                                         1)
        name, limit = smi_name.strip(), float(smi_limit)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"device_name": name, "power_limit_w": limit}


# --- forward: the megakernels over configs 1-4 ------------------------------

def bench_forward(result, device, config, *, burst=8, estimate=(150, 150, 2)):
    """One of FWD_CONFIGS through `MegakernelRenderer.render`: the best of
    3 renders after a warm-up. Config 1 also renders bursts of `burst`
    seeds (`render_burst`); cornell_box also gets its mean executed
    bounces (sol.mean_executed_bounces at `estimate` = (width, height,
    spp)) and its share of the FP32 peak. Returns the rate."""
    key, preset, w, h, spp, mb = config
    world, camera, kw = presets.PRESETS[preset](width=w, height=h)
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"],
                              device)

    def render(s):
        r.render(spp=spp, max_bounces=mb, seed=s)
        _sync(device)

    def render_burst(_s=0):
        r.render_burst(spp=spp, max_bounces=mb, seeds=range(burst))
        _sync(device)

    is_cfg1 = key.startswith("cfg1")
    with on_route(device, FWD_KERNEL[preset],
                  4 + (4 * burst if is_cfg1 else 0)):
        render(0)
        dt = _best_of(render)
        if is_cfg1:
            # config 1 is host-bound: a burst shares one lowering and
            # syncs once; the difference per image is the dispatch floor
            render_burst()
            bdt = _best_of(render_burst) / burst
    rate = w * h * spp / dt
    result[key] = rate
    result[key + "_wall_s"] = dt
    if is_cfg1:
        result[key + "_burst8_per_image"] = w * h * spp / bdt
        result["cfg1_dispatch_overhead_ms"] = (dt - bdt) * 1e3
    if preset == "cornell_box":
        # Regeneration: lanes execute about the mean path length, not the
        # budget, so the share charges the measured mean (the survival
        # curve of a cheap low-spp modular trace).
        ew, eh, espp = estimate
        est_world, est_cam, est_kw = presets.cornell_box(width=ew, height=eh)
        mean_b = sol.mean_executed_bounces(
            est_world.build(), est_cam, max_bounces=mb,
            background=est_kw["background"], spp=espp, device=device)
        low = r.lowered
        result["cornell_mean_executed_bounces"] = mean_b
        result["pct_sol_cornell_fp32_roofline"] = sol.pct_of_sol(
            rate, r.n_sph, r.n_quad, mean_b, has_met=low.has_met,
            has_die=low.has_die)
        # the same rate against the card's measured op mix
        result["pct_sol_cornell_vs_measured_mix"] = sol.pct_of_sol_measured(
            rate, r.n_sph, r.n_quad, mean_b, has_met=low.has_met,
            has_die=low.has_die)
    return rate


# --- config 4b: 8 000 spheres through the public Renderer -------------------

def bench_large_n(result, device, *, width=400, height=225, spp=16,
                  spp_large=64, max_bounces=50, n=8000):
    """Config 4b (K2 with the block cull) through `Renderer.render_array`
    at spp and spp_large: the best of 2 renders after a warm-up each."""
    world, camera, kw = presets.random_spheres(width=width, height=height,
                                               n=n)
    scene = world.build()
    rates = {}
    with on_route(device, "K2", 6):
        for s in (spp, spp_large):
            r = Renderer(samples_per_pixel=s, max_bounces=max_bounces,
                         background_color=kw["background"],
                         progressbar=False, device=device)

            def once(seed, r=r):
                r.seed = seed
                r.render_array(camera, scene)
                _sync(device)

            once(0)
            rates[s] = _best_of(once, n=2)
    result["cfg4b_random8000_400x225_spp16"] = width * height * spp / rates[
        spp]
    result["cfg4b_random8000_400x225_spp16_wall_s"] = rates[spp]
    result["cfg4b_random8000_400x225_spp64"] = (width * height * spp_large
                                                / rates[spp_large])


# --- forward + backward: the fused train steps ------------------------------

def _scene_counts(scene):
    """(real spheres, real quads, has metal, has dielectric) of a scene as
    the fused kernels see it."""
    st = dk.build_diff_static(scene)
    return (len(st.sph_rows), len(st.quad_rows), *dk.static_kind_flags(st))


def bench_fwdbwd(result, device, *, width=300, height=300, spp=16,
                 max_bounces=8, steps=5):
    """cornell_box with every field trainable (the full surrogate scope,
    the 18 quads' boundary surrogates included) on K5: the fastest of
    `steps` steps after a warm-up."""
    world, camera, kw = presets.cornell_box(width=width, height=height)
    scene = world.build()
    target = torch.zeros((height, width, 3))
    step, state = make_fused_train_step(
        scene, camera, target, spp=spp, max_bounces=max_bounces,
        background=kw["background"], seed=0, device=device)
    with on_route(device, "K5", 1 + steps):
        state = _warm(step, state, device)
        _, dt = _timed_steps(step, state, steps)
    rate = width * height * spp / dt
    n_sph, n_quad, met, die = _scene_counts(scene)
    result["fwdbwd_rays_per_sec"] = rate
    result["fwdbwd_step_ms"] = dt * 1e3
    # bench.py's reckoning of this config's work: phase 1 at the budget
    # and a cached replay (bench.py:221-230); the port's K5 regenerates
    # and re-traces, so this is a share of that reckoning, not of the
    # port's own execution
    result["pct_sol_fwdbwd_fp32_roofline"] = sol.pct_of_sol_diff(
        rate, n_sph, n_quad, max_bounces, cached_replay=True, has_met=met,
        has_die=die)
    result["fwdbwd_config"] = (
        f"cornell {width}x{height} spp={spp} mb={max_bounces} fused-kernel "
        "train step (render+MSE+full backward+adam)")
    # BASELINE config 5 is the inverse-rendering task: its throughput is
    # this fwd+bwd rate (bench.py:232-236)
    result["cfg5_inverse_render_fwdbwd_rays_per_sec"] = rate


def bench_northstar(result, device, *, width=600, height=600, spp=200,
                    max_bounces=20, steps=2):
    """The fwd+bwd north star: cornell_box with every field trainable on
    K5, then the config-5 shaped cornell_spheres step training sph_center
    + mat_albedo (the class scope: no quad surrogate runs); the fastest of
    `steps` steps after a warm-up each. Raises if the all-fields step
    passes STEP_LIMIT_S."""
    world, camera, kw = presets.cornell_box(width=width, height=height)
    scene = world.build()
    target = torch.zeros((height, width, 3))
    step, state = make_fused_train_step(
        scene, camera, target, spp=spp, max_bounces=max_bounces,
        background=kw["background"], seed=0, device=device)
    with on_route(device, "K5", 1 + steps):
        state = _warm(step, state, device)
        _, dt = _timed_steps(step, state, steps)
    if dt > STEP_LIMIT_S:
        raise RuntimeError(f"the all-fields north-star step took {dt:.1f} s,"
                           f" over STEP_LIMIT_S = {STEP_LIMIT_S:g} s")
    rate = width * height * spp / dt
    n_sph, n_quad, met, die = _scene_counts(scene)
    result["fwdbwd_northstar_cornell600_spp200_mb20"] = rate
    result["fwdbwd_northstar_step_s"] = dt
    # phase 1 regenerates (the mean executed bounces); the replay and the
    # adjoint are charged the budget, as bench.py:272-281
    mean_b = result.get("cornell_mean_executed_bounces", float(max_bounces))
    result["pct_sol_fwdbwd_northstar_fp32_roofline"] = sol.pct_of_sol_diff(
        rate, n_sph, n_quad, max_bounces, fwd_bounces=mean_b, has_met=met,
        has_die=die)

    world5, camera5, kw5 = presets.cornell_spheres(width=width,
                                                   height=height)
    step5, state5 = make_fused_train_step(
        world5.build(), camera5, target, spp=spp, max_bounces=max_bounces,
        background=kw5["background"], seed=0,
        trainable=("sph_center", "mat_albedo"), device=device)
    with on_route(device, "K5", 1 + steps):
        state5 = _warm(step5, state5, device)
        _, dt5 = _timed_steps(step5, state5, steps)
    result["fwdbwd_northstar_cfg5_cornell600_spp200_mb20"] = (
        width * height * spp / dt5)
    result["fwdbwd_northstar_cfg5_step_s"] = dt5
    result["fwdbwd_northstar_cfg5_config"] = (
        f"cornell_spheres {width}x{height} spp={spp} mb={max_bounces}, "
        "trainable=sph_center+mat_albedo (quad surrogates class-scoped out)")


def bench_diff_large(result, device, *, width=200, height=200, spp=8,
                     max_bounces=8, n=512, rows=8, steps=3):
    """The cfg4-class fused step on K4: random_spheres with `n` spheres,
    sph_center + mat_albedo trainable on the first `rows` sphere rows
    (trainable_rows); the fastest of `steps` steps after a warm-up."""
    world, camera, kw = presets.random_spheres(width=width, height=height,
                                               n=n)
    scene = world.build()
    st = dk.build_diff_static(scene)
    step, state = make_fused_train_step(
        scene, camera, torch.zeros((height, width, 3)), spp=spp,
        max_bounces=max_bounces, background=kw["background"], seed=0,
        trainable=("sph_center", "mat_albedo"),
        trainable_rows={"sph": st.sph_rows[:rows]}, device=device)
    with on_route(device, "K4", 1 + steps):
        state = _warm(step, state, device)
        _, dt = _timed_steps(step, state, steps)
    result["fwdbwd_cfg4class_512sph_rays_per_sec"] = width * height * spp / dt
    result["fwdbwd_cfg4class_512sph_step_ms"] = dt * 1e3
    result["fwdbwd_cfg4class_512sph_config"] = (
        f"random_spheres n={n} {width}x{height} spp={spp} mb={max_bounces}, "
        f"trainable_rows sph[:{rows}] (classic-layout fused kernel K4)")


# --- the line --------------------------------------------------------------

def _guarded(result, key, fn, *args, **kw):
    """Runs a section; a failure becomes `<key>_error` (bench.py:113-133)."""
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the line must still print
        result[key + "_error"] = f"{type(e).__name__}: {e}"[:200]


def collect(device, *, configs=FWD_CONFIGS, forward=None, large_n=None,
            fwdbwd=None, northstar=None, diff_large=None) -> dict:
    """Runs every section on `device` and returns the line's dict.
    `configs` replaces FWD_CONFIGS; `forward`, `large_n`, `fwdbwd`,
    `northstar` and `diff_large` are keyword arguments of the sections
    (their sizes; bench.py's by default)."""
    device = resolve_device(device)
    result = {"device": device.type, **card(device)}
    for config in configs:
        _guarded(result, config[0], bench_forward, result, device, config,
                 **(forward or {}))
    _guarded(result, "cfg4b", bench_large_n, result, device,
             **(large_n or {}))
    _guarded(result, "fwdbwd", bench_fwdbwd, result, device,
             **(fwdbwd or {}))
    _guarded(result, "fwdbwd_northstar", bench_northstar, result, device,
             **(northstar or {}))
    _guarded(result, "fwdbwd_cfg4class", bench_diff_large, result, device,
             **(diff_large or {}))
    cornell = [c[0] for c in configs if c[1] == "cornell_box"]
    fwd_rays = result.get(cornell[0], 0.0) if cornell else 0.0
    result.update(
        metric="fwd_camera_rays_per_sec_per_chip_cornell600_spp200",
        value=fwd_rays,
        unit="rays/sec",
        vs_baseline=fwd_rays / BASELINE_RAYS_PER_SEC,
        baseline_estimate=BASELINE_RAYS_PER_SEC,
    )
    return result


def problems(result) -> list:
    """What makes a line a failure: a missing key, an `_error` key, a
    number that is not positive and finite (but SIGNED), a share outside
    (0, 1], a CUDA line without the card's power limit."""
    out = [f"missing {k}" for k in sorted(KEYS - set(result))]
    out += [f"{k}: {v}" for k, v in result.items() if k.endswith("_error")]
    for k, v in result.items():
        if k in SIGNED or isinstance(v, (str, bool)) or (
                v is None and k == "power_limit_w"
                and result.get("device") != "cuda"):
            continue
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            out.append(f"{k} = {v!r} is not a finite number")
        elif k.startswith("pct_sol_") and not 0.0 < v <= 1.0:
            out.append(f"{k} = {v!r} is outside (0, 1]")
        elif v <= 0:
            out.append(f"{k} = {v!r} is not positive")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the twins)")
    args = ap.parse_args(argv)
    result = collect(args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    bad = problems(main())
    for p in bad:
        print(f"bench_torch: {p}", file=sys.stderr)
    sys.exit(1 if bad else 0)
