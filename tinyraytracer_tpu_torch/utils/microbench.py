"""The card's measured-mix ceiling: the sustained FP32 rate of five op
mixes, in utils/sol.py's counting units (P5, the port of
scripts/probe_vpu_microbench.py).

`microbench(mix, x0, iters)` launches csrc/microbench.cu on a CUDA
tensor and raises if the library does not build or the launch fails; on
a CPU tensor it runs the kernel's plain twin, `microbench_reference`.
`measure(device)` times each mix on the card for about RUN_SECONDS at
one full wave of threads (the best of 3 after a warm-up, as the probe
does) and reads the SM clock while a timed launch runs. Its `sphere`,
`quad` and `transcendental` rates are what `sol.CAND_COUNTED_OPS_PER_SEC`,
`sol.QUAD_COUNTED_OPS_PER_SEC` and `sol.FIXED_COUNTED_OPS_PER_SEC` hold.
Each launch adds one to the host counter `launches.microbench`
(utils/profiling.py).

The twin runs the kernel's chains op by op on tensors: `select`,
`sphere` and `quad` (megakernel.sphere_ts and quad_ts, the twins of
common.cuh's sphere_hit_t and quad_hit_t) give its bits on the card; `fma` forms each product exactly in f64 and
rounds twice, within 1 ulp of the fused one; `transcendental` uses the
device's expf and logf, within TRANSC_ULP (0: bit for bit on the card).
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.ops.intersect import sqrt_rn
from tinyraytracer_tpu_torch.ops.megakernel import quad_ts, sphere_ts
from tinyraytracer_tpu_torch.utils import profiling, sol
from tinyraytracer_tpu_torch.utils.device import resolve_device

MIXES = ("fma", "select", "sphere", "transcendental", "quad")
# The mixes whose output adds each chain's last hit distance.
CANDIDATE_MIXES = ("sphere", "quad")
# Counted FP32 operations of one iteration of the three chains (sol.py's
# rule: a multiply, add, compare, min/max, sqrt, divide or libm call is
# one, a select none; a fused multiply-add two, as the probe counts it).
OPS_PER_ITER = {"fma": 6, "select": 6, "sphere": 3 * sol.OPS_SPHERE_ROW,
                "transcendental": 13, "quad": 3 * sol.OPS_QUAD_ROW}
UNROLL = 4                 # iterations a pass of the kernel's loop
N_CONSTS = 38
# y = x * INIT[0] and z = x * INIT[1] at the start (the probe's), then
# each mix's constants, f32-rounded where they are used.
INIT = (1.0000001, 0.9999999)
CONSTS = {
    # the three chains' multipliers, then their common addend
    "fma": (1.0000001, 0.9999999, 1.0000002, 0.1),
    # selmix: x's multiplier and addend, y's multiplier, z's step
    "select": (1.0000001, 0.1, 0.9999999, 1e-7),
    # the sphere's center and radius^2, then the ray direction: every
    # origin (v, v, v) with v in [0.5, 0.6] hits it at t near 5.4 > v
    "sphere": (3.0, 4.0, 5.0, 1.0, 0.4, 0.56, 0.72),
    # transc: x's addend and the floor, y's addends, z's addend, 1/3
    "transcendental": (0.1, 1e-6, 1.2, 2.5, 1.5, 0.33333334),
    # three quad rows (n, n.corner, av, ca, bv, cb), one a chain: a ray
    # from (a, a, a) along (b, b, b), a and b in [0.5, 0.6], meets each
    # row's plane at t in [4.0, 7.2] > a, with both planar coordinates in
    # [0.41, 0.52]
    "quad": (0.36, 0.48, 0.8, 6.0, 0.2, -0.15, 0.1, 0.05,
             -0.1, 0.25, 0.05, 0.3,
             0.48, 0.64, 0.6, 7.0, 0.1, 0.12, -0.08, 0.1,
             0.05, -0.2, 0.3, 0.2,
             0.8, 0.36, 0.48, 5.0, -0.05, 0.2, 0.1, 0.3,
             0.15, 0.05, 0.1, 0.4),
}
# `transcendental` kernel against twin on the card, ulps of x + y + z: as
# measured on an H100 (torch's CUDA expf and logf are the kernel's; IEEE
# sqrt and divide on both sides). On the CPU the twin's libm differs.
TRANSC_ULP = 0
# The probe's iterations, at which chip_smoke.py times the twin beside the
# kernel.
PROBE_ITERS = 2000
# The length of each timed run of measure(), in seconds.
RUN_SECONDS = 0.5
# measure()'s first launch, which sets the iterations of the timed ones:
# long enough (2-60 ms a mix on an H100) that the launch's own cost does
# not skew the estimate.
CALIB_ITERS = 1 << 16


def constants(mix: str) -> tuple:
    """The kernel's N_CONSTS constants of `mix`: INIT, the mix's, zeros."""
    k = INIT + CONSTS[mix]
    return k + (0.0,) * (N_CONSTS - len(k))


def inputs(n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """Each thread's start value, uniform in [0.5, 0.6) from `seed`."""
    rng = np.random.default_rng(seed)
    x = (0.5 + 0.1 * rng.random(n)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _check(mix, x0, iters):
    if mix not in MIXES:
        raise ValueError(f"unknown mix {mix!r}: one of {MIXES}")
    if x0.dtype != torch.float32 or x0.dim() != 1 or not x0.is_contiguous():
        raise ValueError(f"x0 must be a contiguous 1-D float32 tensor, got "
                         f"{x0.dtype} {tuple(x0.shape)}")
    if x0.numel() >= 2**31:
        raise ValueError(f"{x0.numel()} threads: at most 2^31 - 1")
    if iters < 0 or iters % UNROLL:
        raise ValueError(f"iters={iters} must be a non-negative multiple of "
                         f"{UNROLL}")


# --- the plain twin -----------------------------------------------------------

def _fma_step(x, y, z, t, k):
    def fma(v, a):
        return (v.double() * a.double() + k[5].double()).float()
    return fma(x, k[2]), fma(y, k[3]), fma(z, k[4]), t


def _select_step(x, y, z, t, k):
    xa = x * k[2] + k[3]
    return (torch.where(x < y, xa, y), torch.maximum(y * k[4], z),
            z + k[5], t)


def _sphere_step(x, y, z, t, k):
    sph = torch.stack(k[2:6])[None]

    def test(v):
        return sphere_ts(sph, v, v, v, k[6], k[7], k[8])[0]
    tx = test(x)
    x = torch.where(tx < x, tx, x)
    ty = test(y)
    y = torch.where(ty < y, ty, y)
    tz = test(z)
    z = torch.where(tz < z, tz, z)
    return x, y, z, (tx, ty, tz)


def _quad_step(x, y, z, t, k):
    def test(row, o, d):
        q = torch.stack(k[2 + 12 * row:14 + 12 * row])[None]
        return quad_ts(q, o, o, o, d, d, d)[0]
    tx = test(0, x, y)
    x = torch.where(tx < x, tx, x)
    ty = test(1, y, z)
    y = torch.where(ty < y, ty, y)
    tz = test(2, z, x)
    z = torch.where(tz < z, tz, z)
    return x, y, z, (tx, ty, tz)


def _transc_step(x, y, z, t, k):
    x = 1.0 / sqrt_rn(torch.clamp_min(x * x + k[2], k[3]))
    y = (y + k[4]) / (x + k[5])
    z = torch.exp(torch.log(torch.clamp_min(z + k[6], k[3])) * k[7])
    return x, y, z, t


_STEPS = {"fma": _fma_step, "select": _select_step, "sphere": _sphere_step,
          "transcendental": _transc_step, "quad": _quad_step}


def microbench_reference(mix: str, x0: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """The kernel's chains op by op on the device of `x0`: x + y + z after
    `iters` iterations of `mix`, each thread from its x0, plus for a
    candidate mix the last iteration's three hit distances."""
    _check(mix, x0, iters)
    k = torch.tensor(constants(mix), dtype=torch.float32,
                     device=x0.device).unbind()
    x, step = x0, _STEPS[mix]
    y, z = x * k[0], x * k[1]
    t = (torch.zeros_like(x0),) * 3
    for _ in range(iters):
        x, y, z, t = step(x, y, z, t, k)
    out = x + y + z
    if mix in CANDIDATE_MIXES:
        out = out + t[0] + t[1] + t[2]
    return out


# --- the kernel -------------------------------------------------------------

def microbench(mix: str, x0: torch.Tensor, iters: int) -> torch.Tensor:
    """The chains' sum after `iters` iterations of `mix` (MIXES; see
    microbench_reference), a thread per
    element of `x0` (float32, 1-D): csrc/microbench.cu on a CUDA tensor,
    the twin on a CPU tensor. Does not synchronise."""
    _check(mix, x0, iters)
    if x0.device.type == "cpu":
        return microbench_reference(mix, x0, iters)
    if x0.device.type != "cuda":
        raise ValueError(f"no microbench kernel for device {x0.device}")
    out = torch.empty_like(x0)
    lib = _build.load()
    k = (ctypes.c_float * N_CONSTS)(*constants(mix))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = lib.tinyrt_microbench(x0.data_ptr(), out.data_ptr(),
                                    x0.numel(), MIXES.index(mix), iters, k,
                                    stream)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"microbench launch failed: CUDA error {err} "
                           f"({msg})")
    profiling.count("launches.microbench")
    return out



def wave(mix: str, device="cuda") -> int:
    """Threads of one full wave of `mix`'s kernel on a CUDA device: SMs x
    resident blocks x block size."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("wave() asks the card for its occupancy")
    lib = _build.load()
    with torch.cuda.device(dev):
        n = lib.tinyrt_microbench_wave(MIXES.index(mix))
    if n <= 0:
        msg = lib.tinyrt_error_string(-n).decode() if n < 0 else "no SMs"
        raise RuntimeError(f"microbench occupancy query failed: {msg}")
    return n


def sm_clock_mhz(device) -> float:
    """The card's current SM clock (nvidia-smi clocks.sm), in MHz."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0])


def _launch_s(mix, x0, iters, clock=None) -> tuple:
    """(result, seconds by CUDA events) of one launch; with `clock`, the
    SM clock is read into clock[0] while the launch runs."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = microbench(mix, x0, iters)
    end.record()
    if clock is not None:
        clock[0] = sm_clock_mhz(x0.device)
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def measure(device="cuda") -> dict:
    """Times each mix on the card at one full wave of threads from
    `inputs(n, 0)`: a launch of CALIB_ITERS iterations sets the iterations
    for a run of about RUN_SECONDS; then a warm-up and the best of 3
    launches, the SM clock read while the last one runs. Returns {mix:
    {"tops": counted T ops/s, "s", "iters", "threads", "ops_per_iter",
    "sm_clock_mhz"}}. Raises off a CUDA device: the twin's time is no
    rate of the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure() times the kernel on a CUDA device")
    out = {}
    for mix in MIXES:
        n = wave(mix, dev)
        x0 = inputs(n, 0, dev)
        _, t = _launch_s(mix, x0, CALIB_ITERS)
        iters = max(UNROLL, round(CALIB_ITERS * RUN_SECONDS / t / UNROLL)
                    * UNROLL)
        microbench(mix, x0, iters)
        clock = [None]
        runs = [_launch_s(mix, x0, iters, clock if r == 2 else None)
                for r in range(3)]
        if not all(bool(torch.isfinite(y).all()) for y, _ in runs):
            raise RuntimeError(f"microbench {mix}: a chain left the finite "
                               "range")
        s = min(t for _, t in runs)
        out[mix] = dict(tops=n * iters * OPS_PER_ITER[mix] / s / 1e12, s=s,
                        iters=iters, threads=n,
                        ops_per_iter=OPS_PER_ITER[mix],
                        sm_clock_mhz=clock[0])
    return out
