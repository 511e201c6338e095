#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed on its own lines:

1. Environment: torch and CUDA versions, the device, and the card's name
   and power limit from nvidia-smi. Fails without CUDA.
2. Build: compiles csrc/*.cu with nvcc (sm_90a), as shipped
   (--fmad=false) and, for the numerics comparison, with FMA contraction.
3. Parity: the CUDA packed megakernel against its plain PyTorch twin on
   the card, at 64x48 spp=4, on five scenes (spheres, metal+dielectric,
   Cornell quads with the light/ceiling z-fight, quads, gradient sky).
4. Main path: `Renderer(...).render(camera, world)` for BASELINE configs
   1-3 at full size, one warm-up then one timed render each; the PNG goes
   to output/. Checks finite, non-negative radiance and the Cornell
   box's orientation (green wall left, red right). The kernel's launch
   counter is zeroed before this phase and must be positive after it.
5. Kernel vs twin at the configs' shapes: kernel time (CUDA events) next
   to the twin's; the shipped kernel (FMA contraction off) held to the
   twin with phase 3's tolerance, and the fraction of pixels that differ
   with FMA contraction off and on.

Prints, before the last line, one JSON object describing each kernel, and
as the last line {"ok": true, "device": {...}}. Any failure raises and
exits non-zero without that line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel vs twin on one card (phase 3): see tests/test_torch_cuda.py.
PARITY_ATOL = 1e-5
PARITY_MAX_FRAC = 0.01
PARITY_MEAN_RTOL = 1e-3
PARITY_SCENES = ["sphere_ground", "three_spheres", "cornell_box",
                 "five_quads", "rtiow_sky"]

# BASELINE.md configs 1-3: (label, preset, width, height, spp, bounces)
CONFIGS = [
    ("cfg1", "sphere_ground", 400, 225, 16, 8),
    ("cfg2", "three_spheres", 400, 225, 100, 50),
    ("cfg3", "cornell_box", 600, 600, 200, 20),
]


def log(*a):
    print(*a, flush=True)


def env_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {card}")
    return card


def build_phase(build):
    for fmad in (False, True):
        t0 = time.perf_counter()
        path = build.build(fmad=fmad)
        build.load(fmad=fmad)
        dt = time.perf_counter() - t0
        log(f"[build] fmad={fmad}: {path.name} in {dt:.1f}s")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def _kernel_args(renderer, width, height, spp, max_bounces, seed=0):
    low = renderer.lowered
    return dict(n_sph=low.n_sph, n_quad=low.n_quad, width=width,
                height=height, spp=spp, max_bounces=max_bounces, seed=seed,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky)


def check_parity(np, label, got, want):
    """Max |d| of kernel vs twin; raises beyond the stated tolerance."""
    diff = np.abs(got - want).max(-1)
    frac = float((diff > PARITY_ATOL).mean())
    mean_rel = abs(got.mean() - want.mean()) / max(want.mean(), 1e-30)
    log(f"[parity] {label}: max|d| {diff.max():.3g}, pixels > "
        f"{PARITY_ATOL:g}: {frac:.4%}, exact: {(diff == 0).mean():.4%}, "
        f"mean rel {mean_rel:.3g}")
    if frac > PARITY_MAX_FRAC or mean_rel > PARITY_MEAN_RTOL:
        raise RuntimeError(f"{label}: kernel disagrees with the twin "
                           f"(tolerance atol {PARITY_ATOL} on all but "
                           f"{PARITY_MAX_FRAC:.0%} of pixels, mean rtol "
                           f"{PARITY_MEAN_RTOL})")
    return float(diff.max())


def parity_phase(torch, np, presets, mk, mkp):
    worst = 0.0
    for name in PARITY_SCENES:
        world, camera, kw = presets.PRESETS[name](width=64, height=48)
        r = mk.MegakernelRenderer(world.build(), camera, kw["background"],
                                  "cuda")
        args = _kernel_args(r, 64, 48, 4, min(kw["max_bounces"], 8), seed=3)
        before = mkp.render_packed.launches
        got = mkp.render_packed(r.table, r.cam, **args)
        torch.cuda.synchronize()
        if mkp.render_packed.launches != before + 1:
            raise RuntimeError("launch counter did not rise")
        want = mkp.render_packed_reference(r.table, r.cam, **args)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if got.shape != (48, 64, 3) or not np.isfinite(got).all():
            raise RuntimeError(f"{name}: bad kernel output {got.shape}")
        worst = max(worst, check_parity(np, name, got, want))
    return worst


def main_path_phase(torch, np, presets, mkp, Renderer, card):
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    results = {}
    mkp.render_packed.launches = 0
    for label, name, w, h, spp, mb in CONFIGS:
        world, camera, kw = presets.PRESETS[name](width=w, height=h)
        renderer = Renderer(spp, max_bounces=mb,
                            background_color=kw["background"], seed=0,
                            device="cuda")
        fb = renderer.render_array(camera, world.build())   # warm-up
        torch.cuda.synchronize()
        if tuple(fb.shape) != (h, w, 3) or not bool(torch.isfinite(fb).all()):
            raise RuntimeError(f"{label}: framebuffer not finite / shape "
                               f"{tuple(fb.shape)}")
        if bool((fb < 0).any()):
            raise RuntimeError(f"{label}: negative radiance")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = renderer.render(camera, world)   # ends in a host copy
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        data = image.data
        if not np.isfinite(data).all() or data.min() < 0:
            raise RuntimeError(f"{label}: image not finite / negative")
        path = os.path.join(ROOT, "output", f"chip_smoke_{label}_{name}.png")
        image.save(path)
        mrays = w * h * spp / dt / 1e6
        results[label] = dict(preset=name, width=w, height=h, spp=spp,
                              max_bounces=mb, render_s=dt, mrays_s=mrays,
                              mean=float(fb.mean()))
        log(f"[main] {label} {name} {w}x{h} spp={spp} mb={mb}: "
            f"Renderer.render {dt * 1e3:.1f} ms, {mrays:.1f} camera Mrays/s "
            f"on {card}; wrote {os.path.relpath(path, ROOT)}")
        if name == "cornell_box":
            third = w // 3
            left, right = data[:, :third], data[:, -third:]
            g_ok = left[..., 1].mean() > right[..., 1].mean()
            r_ok = right[..., 0].mean() > left[..., 0].mean()
            log(f"[main] cornell orientation: green left {g_ok}, "
                f"red right {r_ok}")
            if not (g_ok and r_ok):
                raise RuntimeError("Cornell box orientation is wrong")
    launches = mkp.render_packed.launches
    log(f"[main] megakernel_packed launches in the main path: {launches}")
    if launches < 1:
        raise RuntimeError("the main path never launched the CUDA kernel")
    return launches, results


def time_kernel(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_twin_phase(torch, np, presets, mk, mkp, card, results):
    worst = 0.0
    for label, name, w, h, spp, mb in CONFIGS:
        world, camera, kw = presets.PRESETS[name](width=w, height=h)
        r = mk.MegakernelRenderer(world.build(), camera, kw["background"],
                                  "cuda")
        args = _kernel_args(r, w, h, spp, mb)
        ms = time_kernel(
            torch, lambda: mkp.render_packed(r.table, r.cam, **args), 3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        twin = mkp.render_packed_reference(r.table, r.cam, **args)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        twin = twin.cpu().numpy()
        fracs = {}
        for fmad in (False, True):
            got = mkp.render_packed(r.table, r.cam, fmad=fmad, **args)
            got = got.cpu().numpy()
            if not fmad:
                worst = max(worst, check_parity(np, f"{label} {name}", got,
                                                twin))
            d = np.abs(got - twin).max(-1)
            fracs[fmad] = (float((d > 0).mean()),
                           float((d > PARITY_ATOL).mean()),
                           float(got.mean()))
        results[label].update(kernel_ms=ms, twin_ms=plain_ms,
                              fma_off_differ=fracs[False][0],
                              fma_off_beyond_atol=fracs[False][1],
                              fma_on_differ=fracs[True][0],
                              fma_on_beyond_atol=fracs[True][1],
                              fma_off_mean=fracs[False][2],
                              fma_on_mean=fracs[True][2],
                              twin_mean=float(twin.mean()))
        log(f"[kernel] {label} {name} {w}x{h} spp={spp} mb={mb}: kernel "
            f"{ms:.2f} ms, twin {plain_ms:.1f} ms ({plain_ms / ms:.1f}x) "
            f"on {card}")
        log(f"[kernel] {label} pixels differing from the twin: FMA off "
            f"{fracs[False][0]:.4%} (> {PARITY_ATOL:g}: "
            f"{fracs[False][1]:.4%}), FMA on {fracs[True][0]:.4%} "
            f"(> {PARITY_ATOL:g}: {fracs[True][1]:.4%}); image mean twin "
            f"{twin.mean():.6f}, FMA off {fracs[False][2]:.6f}, FMA on "
            f"{fracs[True][2]:.6f}")
    return worst


def main() -> int:
    import numpy as np
    import torch

    card = env_phase(torch)
    sys.path.insert(0, ROOT)
    from tinyraytracer_tpu_torch import Renderer, _build
    from tinyraytracer_tpu_torch.models import presets
    from tinyraytracer_tpu_torch.ops import megakernel as mk
    from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp

    build_phase(_build)
    max_err = parity_phase(torch, np, presets, mk, mkp)
    launches, results = main_path_phase(torch, np, presets, mkp, Renderer,
                                        card)
    max_err = max(max_err, kernel_vs_twin_phase(torch, np, presets, mk, mkp,
                                                card, results))
    with open(os.path.join(ROOT, "output", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, results=results), f, indent=1)
    north = results["cfg3"]
    print(json.dumps({"kernels": [{
        "name": "megakernel_packed",
        "route": "cuda",
        "source": "tinyraytracer_tpu_torch/csrc/megakernel_packed.cu",
        "replaces": "tinyraytracer_tpu/ops/megakernel_packed.py:125",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": north["kernel_ms"],
        "plain_ms": north["twin_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
