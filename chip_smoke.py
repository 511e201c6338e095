#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed on its own lines:

1. Environment: torch and CUDA versions, the device, and the card's name
   and power limit from nvidia-smi. Fails without CUDA.
2. Build: compiles csrc/*.cu with nvcc (sm_90a, one nvcc per source, all
   started together), as shipped (--fmad=false) and, for the numerics
   comparison, with FMA contraction; prints ptxas registers and spills.
3. Parity at 64x48 spp=4: the packed kernel (K1) against its plain
   PyTorch twin on five scenes; the classic-layout kernel (K2) against
   its twin on random_spheres with 500 spheres (dense) and with 8000
   (culled), and on three_spheres and cornell_box forced onto K2, where
   K2 must also equal K1 bit for bit.
4. Main path: `Renderer(...).render(camera, world)` for BASELINE configs
   1-4 and 4b at full size, one warm-up then one timed render each; the
   PNG goes to output/. Checks finite, non-negative radiance and the
   Cornell box's orientation. Both launch counters are zeroed before this
   phase; K1's must rise on configs 1-3 only, K2's on 4 and 4b only.
5. Where the time goes: the steps of one render (lowering, copies,
   kernel, readback, gamma) timed one by one beside whole renders.
6. Kernel vs twin at the configs' shapes: kernel time (CUDA events) next
   to the twin's. K1's twin runs at full size; K2's at full resolution
   with fewer samples (printed beside its time), the kernel held to it at
   that shape. At 4b the culled kernel must equal the unculled one bit
   for bit. Segments per camera ray (and, at 4b, sphere rows tested under
   the cull) are counted with the twin; with per-segment operation counts
   read off csrc/common.cuh they give each kernel's bound.
7. `render_batch` / `render_async` on the card: frames bitwise equal to
   single renders.
8. The closest-hit kernel (K3) against its twin, bit for bit on t and j:
   primary rays (64x48 spp=4) and the scattered and NEE shadow rays of a
   traced bounce on four scenes, then config 5's full wavefront of
   720 000 primary rays, where both are also timed.
9. The modular train step (`make_train_step`, 64x64 spp=4 mb=8) with K3
   and with the twin's selection: loss, gradients and updated params bit
   for bit, the step deterministic, K3 launched 2 x bounces x rounds
   times; `fit(engine="modular")` refreshes its compaction on schedule.
10. Config 5 at full size (cornell_spheres 600x600 mb=20, spp=200 unless
   a step would pass STEP_LIMIT_S, then the largest divisor of 200 that
   keeps it under): 1 warm-up and 2 timed steps, each ended by a host
   read of the loss; fwd+bwd camera Mrays/s, peak memory, K3 launches and
   share of the step. K3's counter is zeroed before and read after.
11. `Renderer(accelerator="none")` (the modular tracer) against K1.

Prints, before the last line, one JSON object describing each kernel, and
as the last line {"ok": true, "device": {...}}. Any failure raises and
exits non-zero without that line.
"""

import json
import math
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
# K2 parity scenes: (label, preset, preset kwargs, force K2)
FLAT_PARITY = [
    ("random_spheres_500", "random_spheres", dict(n=500), False),
    ("random_spheres_8000", "random_spheres", dict(n=8000), False),
    ("three_spheres_k2", "three_spheres", {}, True),
    ("cornell_box_k2", "cornell_box", {}, True),
]

# BASELINE.md configs 1-4 and bench.py's 4b: (label, preset, preset
# kwargs, width, height, spp, bounces, twin spp)
CONFIGS = [
    ("cfg1", "sphere_ground", {}, 400, 225, 16, 8, 16),
    ("cfg2", "three_spheres", {}, 400, 225, 100, 50, 100),
    ("cfg3", "cornell_box", {}, 600, 600, 200, 20, 200),
    ("cfg4", "random_spheres", {}, 1200, 675, 500, 50, 1),
    ("cfg4b", "random_spheres", dict(n=8000), 400, 225, 16, 50, 2),
]
# Elements of one twin candidate matrix on the card (rows x pixels).
TWIN_CANDIDATES = 1 << 26

# FP32 operations per unit of work, read off csrc/common.cuh and
# csrc/megakernel.cu: each add, subtract, multiply, divide, compare,
# min/max, sqrt and libm call counts one (--fmad=false fuses none; an IEEE
# divide, sqrt or libm call takes several instructions, so the bound is
# optimistic).
OPS_SPHERE_ROW = 24      # sphere_hit_t + the running-minimum compare
OPS_QUAD_ROW = 45        # quad_hit_t + the running-minimum compare
OPS_AABB = 25            # one block's slab test (megakernel.cu)
OPS_CULL_SEGMENT = 6     # the slab test's three guarded reciprocals
OPS_SHADE_BASE = 108     # shade_bounce without metal or dielectric lobes
OPS_REFLECT = 14         # the shared reflection (metal or dielectric)
OPS_METAL = 7            # fuzz and the kind select
OPS_DIELECTRIC = 49      # Schlick, refraction and the kind select
OPS_CAMERA = 62          # camera_ray and the per-sample fold
FP32_PEAK = 67e12        # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_S = 3.35e12


# K3 (csrc/closest_hit.cu): FP32 operations per real row, counted as
# above (sphere_t / quad_t plus the running-minimum compare), and bytes
# per ray (origin and direction in, t and j out).
OPS_K3_SPHERE_ROW = 29
OPS_K3_QUAD_ROW = 49
K3_BYTES_PER_RAY = 32
K3_SCENES = [("cornell_spheres", {}), ("cornell_box", {}),
             ("three_spheres", {}), ("random_spheres", dict(n=500))]
# Config 5 (BASELINE.md:36, bench.py:289-310): the sphere fit.
CFG5 = dict(width=600, height=600, spp=200, max_bounces=20)
TRAINABLE = ("sph_center", "mat_albedo")
STEP_LIMIT_S = 60.0
# Renderer(accelerator="none") against K1 (phase 11): cornell_box's
# light is coplanar with its ceiling, and ulp differences between the two
# paths' hit points and camera rays decide that tie differently: the JAX
# package's own modular render differs from its K1 there on 2.3 % of
# pixels, image mean 8.1 % (64x48 spp=4 mb=8, CPU). The other two scenes
# are held to the PARITY_* tolerances.
ZFIGHT_MAX_FRAC = 0.05
ZFIGHT_MEAN_RTOL = 0.15


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
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")


def _packed_args(renderer, width, height, spp, max_bounces, seed=0):
    low = renderer.lowered
    return dict(n_sph=low.n_sph, n_quad=low.n_quad, width=width,
                height=height, spp=spp, max_bounces=max_bounces, seed=seed,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky)


def _scene(presets, mk, name, kw, w, h, **rkw):
    world, camera, pkw = presets.PRESETS[name](width=w, height=h, **kw)
    return mk.MegakernelRenderer(world.build(), camera, pkw["background"],
                                 "cuda", **rkw), pkw


def check_parity(np, label, got, want):
    """Max |d| of kernel vs twin; raises beyond the stated tolerance."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError(f"{label}: bad kernel output {got.shape}")
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
    worst = {"K1": 0.0, "K2": 0.0}
    for name in PARITY_SCENES:
        r, kw = _scene(presets, mk, name, {}, 64, 48)
        args = _packed_args(r, 64, 48, 4, min(kw["max_bounces"], 8), seed=3)
        before = mkp.render_packed.launches
        got = mkp.render_packed(r.table, r.cam, **args)
        torch.cuda.synchronize()
        if mkp.render_packed.launches != before + 1:
            raise RuntimeError("K1 launch counter did not rise")
        want = mkp.render_packed_reference(r.table, r.cam, **args)
        worst["K1"] = max(worst["K1"], check_parity(
            np, f"K1 {name}", got.cpu().numpy(), want.cpu().numpy()))
    for label, name, pkw, force in FLAT_PARITY:
        r, kw = _scene(presets, mk, name, pkw, 64, 48)
        args = r.flat_args(spp=4, max_bounces=min(kw["max_bounces"], 8),
                           seed=3)
        before = mk.render_flat.launches
        got = mk.render_flat(**args)
        torch.cuda.synchronize()
        if mk.render_flat.launches != before + 1:
            raise RuntimeError("K2 launch counter did not rise")
        args.pop("aabbs")
        want = mk.render_flat_reference(**args)
        worst["K2"] = max(worst["K2"], check_parity(
            np, f"K2 {label} (cull {r.chunk_cull})", got.cpu().numpy(),
            want.cpu().numpy()))
        if force:
            k1 = r.render(spp=4, max_bounces=args["max_bounces"], seed=3,
                          packed=True)
            same = bool(torch.equal(got, k1))
            log(f"[parity] K2 == K1 bitwise on {name}: {same}")
            if not same:
                raise RuntimeError(f"{name}: K2 differs from K1")
    return worst


def main_path_phase(torch, np, presets, mk, mkp, Renderer, card):
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    results = {}
    mkp.render_packed.launches = 0
    mk.render_flat.launches = 0
    for label, name, pkw, w, h, spp, mb, _ in CONFIGS:
        world, camera, kw = presets.PRESETS[name](width=w, height=h, **pkw)
        renderer = Renderer(spp, max_bounces=mb,
                            background_color=kw["background"], seed=0,
                            device="cuda")
        before = (mkp.render_packed.launches, mk.render_flat.launches)
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
        rose = (mkp.render_packed.launches - before[0],
                mk.render_flat.launches - before[1])
        want = (2, 0) if label in ("cfg1", "cfg2", "cfg3") else (0, 2)
        if rose != want:
            raise RuntimeError(f"{label}: launches (K1, K2) rose by {rose}, "
                               f"expected {want}")
        data = image.data
        if not np.isfinite(data).all() or data.min() < 0:
            raise RuntimeError(f"{label}: image not finite / negative")
        path = os.path.join(ROOT, "output", f"chip_smoke_{label}_{name}.png")
        image.save(path)
        mrays = w * h * spp / dt / 1e6
        results[label] = dict(preset=name, width=w, height=h, spp=spp,
                              max_bounces=mb, render_s=dt, mrays_s=mrays,
                              mean=float(fb.mean()), kernel="K1" if want[0]
                              else "K2")
        log(f"[main] {label} {name} {w}x{h} spp={spp} mb={mb}: "
            f"Renderer.render {dt * 1e3:.1f} ms, {mrays:.1f} camera Mrays/s "
            f"on {card}; launches (K1, K2) +{rose}; wrote "
            f"{os.path.relpath(path, ROOT)}")
        if name == "cornell_box":
            third = w // 3
            left, right = data[:, :third], data[:, -third:]
            g_ok = left[..., 1].mean() > right[..., 1].mean()
            r_ok = right[..., 0].mean() > left[..., 0].mean()
            log(f"[main] cornell orientation: green left {g_ok}, "
                f"red right {r_ok}")
            if not (g_ok and r_ok):
                raise RuntimeError("Cornell box orientation is wrong")
    launches = {"K1": mkp.render_packed.launches,
                "K2": mk.render_flat.launches}
    log(f"[main] launches in the main path: {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError("the main path did not launch every kernel")
    return launches, results


def breakdown_phase(torch, np, presets, mk, Image, Renderer, card,
                    results):
    """Where one `Renderer.render` call's time goes: the steps it takes
    called one by one, each ended by a synchronize. Median of 3 (1 at
    cfg4), beside the median of as many whole `Renderer.render` calls on
    a world already built, as in the main path."""
    for label, name, pkw, w, h, spp, mb, _ in CONFIGS:
        res = results[label]
        reps = 1 if label == "cfg4" else 3
        steps = []
        for _ in range(reps):
            world, camera, kw = presets.PRESETS[name](width=w, height=h,
                                                      **pkw)
            t = {}
            clock = time.perf_counter
            t0 = clock()
            scene = world.build()
            t["build"] = clock() - t0
            t0 = clock()
            r = mk.MegakernelRenderer(scene, camera, kw["background"],
                                      "cuda")
            k1 = res["kernel"] == "K1"
            _ = r.lowered if k1 else r.flat
            t["lower"] = clock() - t0
            t0 = clock()
            _ = (r.table, r.cam) if k1 else r.flat_tensors
            torch.cuda.synchronize()
            t["h2d"] = clock() - t0
            fb, kernel_ms = time_once(
                torch, lambda: r.render(spp=spp, max_bounces=mb))
            t["kernel"] = kernel_ms / 1e3
            t0 = clock()
            host = fb.cpu().numpy()
            t["d2h"] = clock() - t0
            t0 = clock()
            Image.from_linear(host)
            t["gamma"] = clock() - t0
            renderer = Renderer(spp, max_bounces=mb,
                                background_color=kw["background"], seed=0,
                                device="cuda")
            torch.cuda.synchronize()
            t0 = clock()
            renderer.render(camera, world)
            torch.cuda.synchronize()
            t["e2e"] = clock() - t0
            steps.append(t)
        med = {k: float(np.median([s[k] for s in steps])) * 1e3
               for k in steps[0]}
        med["device_busy"] = med["kernel"] / med["e2e"]
        res["breakdown_ms"] = med
        log(f"[time] {label}: Renderer.render {med['e2e']:.2f} ms (median "
            f"of {reps}); steps: lower {med['lower']:.2f}, H2D "
            f"{med['h2d']:.2f}, kernel {med['kernel']:.2f}, D2H "
            f"{med['d2h']:.2f}, gamma {med['gamma']:.2f} ms (World.build "
            f"uncached {med['build']:.2f} ms); device busy "
            f"{med['device_busy']:.1%}; on {card}")


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


def time_once(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def count_work(torch, mk, fn, width, blocks=None):
    """Runs a twin `fn()` with shading wrapped to count, per bounce, the
    pixels still on a path (bounce segments) and the kernel's warps with
    at least one such pixel (warp steps: a warp of 16x2 pixels runs each
    sample until its longest path ends). The twin's pixel chunks must
    hold whole pairs of image rows.

    With `blocks`, a (sph, n_sph, aabbs, chunk) tuple, it also counts the
    sphere rows the culled kernel walks: a thread tests a block when its
    ray enters the block's AABB before the best hit of the blocks before
    it (the cull is exact, so that best is the running best of the
    kernel's walk), and a warp walks the union of its threads' blocks.
    Returns a dict of the four sums: seg, warp_steps, rows, warp_rows."""
    tot = dict(seg=0, warp_steps=0, rows=0, warp_rows=0)
    last = {}
    shade, dense = mk.shade_bounce, mk.dense_closest_hit
    nwx = -(-width // 16)

    def counting_shade(*a, **k):
        alive = a[12]
        pid = torch.arange(alive.shape[0], device=alive.device)
        wid = (pid // width // 2) * nwx + (pid % width) // 16
        nw = int(wid[-1]) + 1
        per_warp = lambda x: torch.zeros(  # noqa: E731
            x.shape[:-1] + (nw,), device=x.device).index_add_(
                -1, wid, x.float()) > 0
        tot["seg"] += int(alive.sum())
        tot["warp_steps"] += int(per_warp(alive).sum())
        if "enter" in last:
            enter = last.pop("enter") & alive         # (blocks, pixels)
            lens = last.pop("lens")[:, None]
            tot["rows"] += int((enter * lens).sum())
            tot["warp_rows"] += int((per_warp(enter) * lens).sum())
        return shade(*a, **k)

    def counting_dense(sph, quad, pay):
        inner = dense(sph, quad, pay)

        def hit(ox, oy, oz, dx, dy, dz):
            if blocks is not None:
                last["enter"], last["lens"] = culled_blocks(
                    ox, oy, oz, dx, dy, dz)
            return inner(ox, oy, oz, dx, dy, dz)
        return hit

    def culled_blocks(ox, oy, oz, dx, dy, dz):
        bsph, n_sph, aabbs, c = blocks
        ns = bsph.shape[0]
        inv = [1.0 / torch.where(d.abs() < 1e-24, 1e-24, d)
               for d in (dx, dy, dz)]
        best = torch.full_like(ox, mk.MISS)
        enters, lens = [], []
        for i in range(aabbs.shape[0]):
            base = min(i * c, ns - c)
            end = min(base + c, n_sph)
            mn, mx = aabbs[i, 0:3], aabbs[i, 4:7]
            t0 = [(mn[k] - o) * inv[k] for k, o in enumerate((ox, oy, oz))]
            t1 = [(mx[k] - o) * inv[k] for k, o in enumerate((ox, oy, oz))]
            near = torch.maximum(torch.minimum(t0[0], t1[0]), torch.maximum(
                torch.minimum(t0[1], t1[1]), torch.minimum(t0[2], t1[2])))
            far = torch.minimum(torch.maximum(t0[0], t1[0]), torch.minimum(
                torch.maximum(t0[1], t1[1]), torch.maximum(t0[2], t1[2])))
            lo = torch.clamp_min(near, mk.T_MIN)
            enter = (lo <= far) & (lo < best)
            enters.append(enter)
            lens.append(max(end - base, 0))
            if end > base:
                t = mk.sphere_ts(bsph[base:end], ox, oy, oz, dx, dy, dz)
                best = torch.where(enter, torch.minimum(best, t.min(0)[0]),
                                   best)
        return torch.stack(enters), torch.tensor(lens, device=ox.device)

    mk.shade_bounce, mk.dense_closest_hit = counting_shade, counting_dense
    try:
        fn()
    finally:
        mk.shade_bounce, mk.dense_closest_hit = shade, dense
    return tot


def shade_ops(has_met, has_die):
    ops = OPS_SHADE_BASE
    if has_met or has_die:
        ops += OPS_REFLECT
    if has_met:
        ops += OPS_METAL
    if has_die:
        ops += OPS_DIELECTRIC
    return ops


def bound(camera_rays, segments, per_segment, out_bytes, in_bytes):
    """Least time (ms) for the work: the larger of operations over the
    FP32 peak and bytes (inputs once, output once) over HBM's rate."""
    ops = camera_rays * OPS_CAMERA + segments * per_segment
    t_ops, t_bytes = ops / FP32_PEAK, (out_bytes + in_bytes) / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops)


def kernel_vs_twin_phase(torch, np, presets, mk, mkp, card, results):
    worst = {"K1": 0.0, "K2": 0.0}
    for label, name, pkw, w, h, spp, mb, twin_spp in CONFIGS:
        res = results[label]
        r, _ = _scene(presets, mk, name, pkw, w, h)
        if res["kernel"] == "K1":
            args = _packed_args(r, w, h, spp, mb)
            kernel = lambda fmad=False, **o: mkp.render_packed(  # noqa: E731
                r.table, r.cam, fmad=fmad, **{**args, **o})
            twin = lambda **o: mkp.render_packed_reference(  # noqa: E731
                r.table, r.cam, **{**args, **o})
            low = r.lowered
            rows = low.n_sph * OPS_SPHERE_ROW + low.n_quad * OPS_QUAD_ROW
            in_bytes = 4 * (low.table.size + low.cam.size)
            flags = (low.has_met, low.has_die)
        else:
            args = r.flat_args(spp=spp, max_bounces=mb)
            kernel = lambda fmad=False, **o: mk.render_flat(  # noqa: E731
                fmad=fmad, **{**args, **o})
            pixel_chunk = max(1, TWIN_CANDIDATES // (r.n_sph + r.n_quad))
            twin_args = dict(args, pixel_chunk=pixel_chunk)
            del twin_args["aabbs"]
            twin = lambda **o: mk.render_flat_reference(  # noqa: E731
                **{**twin_args, **o})
            f = r.flat
            rows = f.n_sph * OPS_SPHERE_ROW + f.n_quad * OPS_QUAD_ROW
            in_bytes = sum(4 * a.size for a in (f.sph, f.quad, f.pay, f.cam))
            flags = (f.has_met, f.has_die)
        reps = 2 if label == "cfg4" else 3
        ms = time_kernel(torch, kernel, reps)
        torch.cuda.reset_peak_memory_stats()
        want, plain_ms = time_once(torch, lambda: twin(spp=twin_spp))
        twin_mem = torch.cuda.max_memory_allocated()
        want = want.cpu().numpy()
        got, ms_twin_shape = time_once(torch, lambda: kernel(spp=twin_spp))
        got = got.cpu().numpy()
        worst[res["kernel"]] = max(worst[res["kernel"]], check_parity(
            np, f"{label} {name} spp={twin_spp}", got, want))
        fracs = {}
        for fmad in (False, True):
            d = np.abs(kernel(fmad=fmad, spp=twin_spp).cpu().numpy()
                       - want).max(-1)
            fracs[fmad] = (float((d > 0).mean()),
                           float((d > PARITY_ATOL).mean()))
        twin_shape = f"{w}x{h} spp={twin_spp} mb={mb}"
        res.update(kernel_ms=ms, twin_ms=plain_ms, twin_shape=twin_shape,
                   kernel_ms_at_twin_shape=ms_twin_shape,
                   twin_peak_bytes=twin_mem,
                   fma_off_differ=fracs[False][0],
                   fma_off_beyond_atol=fracs[False][1],
                   fma_on_differ=fracs[True][0],
                   fma_on_beyond_atol=fracs[True][1])
        log(f"[kernel] {label} {name} {w}x{h} spp={spp} mb={mb}: kernel "
            f"{ms:.2f} ms; twin {plain_ms:.1f} ms at {twin_shape} (kernel "
            f"at that shape {ms_twin_shape:.2f} ms, "
            f"{plain_ms / ms_twin_shape:.1f}x); twin peak device memory "
            f"{twin_mem / 2**30:.2f} GiB; on {card}")
        log(f"[kernel] {label} pixels differing from the twin: FMA off "
            f"{fracs[False][0]:.4%} (> {PARITY_ATOL:g}: "
            f"{fracs[False][1]:.4%}), FMA on {fracs[True][0]:.4%} "
            f"(> {PARITY_ATOL:g}: {fracs[True][1]:.4%})")

        # work counts with the twin at the twin's shape, scaled to spp
        count_spp = min(twin_spp, 2)
        count_kw = {}
        blocks = None
        if res["kernel"] == "K2":
            count_kw["pixel_chunk"] = max(1, pixel_chunk // (2 * w)) * 2 * w
            if r.chunk_cull:
                t = r.flat_tensors
                blocks = (t["sph"], r.flat.n_sph, t["aabbs"],
                          min(mk.scene_table.ROW_CHUNK, t["sph"].shape[0]))
        n = count_work(torch, mk, lambda: twin(spp=count_spp, **count_kw),
                       w, blocks)
        seg_per_ray = n["seg"] / (w * h * count_spp)
        simt = n["seg"] / (32 * n["warp_steps"])
        segments = seg_per_ray * w * h * spp
        per_seg = rows + shade_ops(*flags)
        b_ms, b_by, ops = bound(w * h * spp, segments, per_seg, 12 * w * h,
                                in_bytes)
        res.update(segments_per_ray=seg_per_ray, simt_efficiency=simt,
                   bound_ms=b_ms, bound_by=b_by, bound_ops=ops)
        log(f"[count] {label}: {seg_per_ray:.4f} segments per camera ray "
            f"(twin, {w}x{h} spp={count_spp}); warp lanes on a path in the "
            f"bounce loop {simt:.1%}; {per_seg} ops per segment; bound "
            f"{b_ms:.3f} ms ({b_by}, {ops:.4g} ops at "
            f"{FP32_PEAK / 1e12:g} TFLOP/s)")
        if blocks is not None:
            rows_per_seg = n["rows"] / n["seg"]
            warp_rows = n["warp_rows"] / n["warp_steps"]
            res.update(warp_rows_per_step=warp_rows)
            log(f"[count] {label}: a warp walks {warp_rows:.1f} sphere rows "
                f"per bounce step under the per-thread cull")
            c_seg = (OPS_CULL_SEGMENT + args["aabbs"].shape[0] * OPS_AABB
                     + rows_per_seg * OPS_SPHERE_ROW + shade_ops(*flags))
            cb_ms, cb_by, c_ops = bound(w * h * spp, segments, c_seg,
                                        12 * w * h, in_bytes)
            res.update(culled_rows_per_segment=rows_per_seg,
                       bound_ms_dense=b_ms, bound_ms=cb_ms, bound_by=cb_by,
                       bound_ops=c_ops)
            log(f"[count] {label}: the cull tests {rows_per_seg:.1f} of "
                f"{r.flat.n_sph} sphere rows per segment; bound with the "
                f"cull {cb_ms:.3f} ms ({cb_by}, {c_ops:.4g} ops)")
            plain = dict(args, aabbs=None)
            ms_nc = time_kernel(torch, lambda: mk.render_flat(**plain), 3)
            culled_img = mk.render_flat(**args)
            dense_img = mk.render_flat(**plain)
            differ = float((culled_img != dense_img).any(-1).float().mean())
            res.update(unculled_kernel_ms=ms_nc, culled_vs_unculled=differ)
            log(f"[cull] {label}: culled {ms:.2f} ms, unculled "
                f"{ms_nc:.2f} ms; pixels where culled != unculled: "
                f"{differ:.6%}")
            if differ > 0:
                raise RuntimeError(f"{label}: the cull changed the image")
    return worst


def api_phase(np, presets, Renderer):
    """render_batch and render_async on the card, one K1 and one K2
    scene: every frame bitwise equal to a single render."""
    for name, pkw in (("sphere_ground", {}), ("random_spheres", dict(n=500))):
        world, camera, kw = presets.PRESETS[name](width=64, height=48, **pkw)
        r = Renderer(4, max_bounces=6, background_color=kw["background"],
                     seed=0, device="cuda")
        seeds = [0, 5, 11]
        frames = r.render_batch(camera, world, seeds)
        for s, img in zip(seeds, frames):
            r.seed = s
            if not np.array_equal(img.data, r.render(camera, world).data):
                raise RuntimeError(f"{name}: render_batch seed {s} differs")
        r.seed = 5
        handle = r.render_async(camera, world)
        polled = handle.done()
        img = handle.result()
        if not handle.done():
            raise RuntimeError("render_async: done() false after result()")
        if not np.array_equal(img.data, frames[1].data):
            raise RuntimeError(f"{name}: render_async differs from render")
        log(f"[api] {name}: render_batch {len(seeds)} frames == render; "
            f"render_async == render (done() before result(): {polled})")


class RayCapture:
    """A selection tape for `trace` that keeps a copy of every ray batch
    it is asked to select for (primary, shadow, scattered, ...)."""

    def __init__(self):
        self.rays = []

    def __call__(self, select, o, d, need_j=True):
        self.rays.append((o.detach().clone(), d.detach().clone()))
        return select(o, d)


def _device_ms(torch, fn, name, reps):
    """Mean device time (ms) of the kernels whose name holds `name` over
    `reps` calls of fn, from torch.profiler: a launch back to back with
    the next costs more host time than K3 takes on the card, so CUDA
    events around a loop would time the host."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if name in e.key
          and e.self_device_time_total > 0]
    if not ev:
        raise RuntimeError(f"the profiler saw no {name} kernel")
    return (sum(e.self_device_time_total for e in ev) / 1e3
            / sum(e.count for e in ev))


def _cfg5_wavefront(torch, presets, trace_ops, generate_rays):
    world, camera, kw = presets.cornell_spheres(width=CFG5["width"],
                                                height=CFG5["height"])
    scene = world.build().to("cuda")
    npix = CFG5["width"] * CFG5["height"]
    chunk, _ = trace_ops.sample_rounds(npix, CFG5["spp"], True)
    pid, sid = trace_ops.round_ids(torch.arange(npix, device="cuda"), chunk,
                                   0)
    o, d = generate_rays(camera.to("cuda"), pid, sid, 0)
    return scene, o, d


def k3_phase(torch, presets, ik, trace_ops, generate_rays, card):
    """K3 against its twin on the card, bit for bit; times both at
    config 5's wavefront. Returns the K3 record for the kernels line."""
    worst_t, worst_j = 0.0, 0

    def compare(label, cs, o, d):
        nonlocal worst_t, worst_j
        before = ik.closest_hit.launches
        t_k, j_k = ik.closest_hit(cs, o, d)
        torch.cuda.synchronize()
        if ik.closest_hit.launches != before + 1:
            raise RuntimeError("K3 launch counter did not rise")
        t_r, j_r = ik.closest_hit_reference(cs, o, d)
        dt = float((t_k - t_r).abs().max())
        dj = int((j_k != j_r).sum())
        hits = float((j_k >= 0).float().mean())
        worst_t, worst_j = max(worst_t, dt), max(worst_j, dj)
        log(f"[k3] {label}: {o.shape[0]} rays, hit {hits:.1%}; max |dt| "
            f"{dt:g}, j differing {dj}, t bitwise {torch.equal(t_k, t_r)}")
        if not torch.equal(t_k, t_r) or dj:
            raise RuntimeError(f"{label}: K3 differs from its twin")

    for name, pkw in K3_SCENES:
        world, camera, kw = presets.PRESETS[name](width=64, height=48,
                                                  **pkw)
        scene = world.build().to("cuda")
        cs = ik.compact_rows(scene, "cuda")
        cap = RayCapture()
        pix = torch.arange(64 * 48, device="cuda")
        pid, sid = trace_ops.round_ids(pix, 4, 0)
        o, d = generate_rays(camera.to("cuda"), pid, sid, 3)
        plain = ik.compact_rows(scene, "cuda", plain=True)
        with torch.no_grad():
            trace_ops.trace(scene, o, d, pid, sid, 3, 2, kw["background"],
                            compact=plain, nee=True, tape=cap)
        labels = ["primary", "shadow (bounce 0)", "scattered (bounce 1)",
                  "shadow (bounce 1)"]
        for label, (ro, rd) in zip(labels, cap.rays):
            compare(f"{name} {label}", cs, ro, rd)

    scene, o, d = _cfg5_wavefront(torch, presets, trace_ops, generate_rays)
    cs = ik.compact_rows(scene, "cuda")
    compare("cfg5 wavefront (600x600, 2 samples)", cs, o, d)
    ms = _device_ms(torch, lambda: ik.closest_hit(cs, o, d), "closest_hit",
                    50)
    plain_ms = time_kernel(torch, lambda: ik.closest_hit_reference(cs, o, d),
                           3)
    r = o.shape[0]
    ops = r * (cs.n_sph * OPS_K3_SPHERE_ROW + cs.n_quad * OPS_K3_QUAD_ROW)
    t_ops, t_bytes = ops / FP32_PEAK, r * K3_BYTES_PER_RAY / HBM_BYTES_S
    rec = dict(rays=r, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               max_abs_err=worst_t, j_differing=worst_j)
    host_ms = time_kernel(torch, lambda: ik.closest_hit(cs, o, d), 50)
    rec["host_loop_ms"] = host_ms
    log(f"[k3] cfg5 wavefront ({r} rays, {cs.n_sph} spheres + {cs.n_quad} "
        f"quads): K3 {ms:.4f} ms per call on the device (profiler; a loop "
        f"of calls timed with events: {host_ms:.4f} ms each), twin "
        f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}); on {card}")
    return rec


def _perturbed(torch, scene):
    """The config-5 start: the spheres moved and their albedos dimmed (the
    fit recovers them)."""
    from dataclasses import replace
    c = scene.sph_center.clone()
    n = int(scene.sph_valid.sum())
    c[:n] += torch.tensor([3.0, 1.0, -2.0])
    alb = scene.mat_albedo.clone()
    alb[4:6] *= 0.75
    return replace(scene, sph_center=c, mat_albedo=alb)


def _train_setup(torch, presets, Renderer, width, height, spp_target):
    world, camera, kw = presets.cornell_spheres(width=width, height=height)
    truth = world.build()
    target = Renderer(spp_target, max_bounces=kw["max_bounces"],
                      background_color=kw["background"],
                      device="cuda").render_array(camera, truth)
    return _perturbed(torch, truth), camera, target, kw


def train_phase(torch, presets, ik, inverse, Renderer, card):
    """K3 vs twin through the train step, determinism, launch count, and
    fit's compaction refresh (64x64 spp=4 mb=8)."""
    spp, mb = 4, 8
    template, camera, target, kw = _train_setup(torch, presets, Renderer, 64,
                                                64, 16)
    step, (p0, o0) = inverse.make_train_step(
        template, camera, target, spp=spp, max_bounces=mb,
        background=kw["background"], seed=0, trainable=TRAINABLE,
        use_kernel=True, device="cuda")
    scene = template.to("cuda")
    plain = ik.compact_rows(scene, "cuda", plain=True)

    def run(compact=None):
        before = ik.closest_hit.launches
        out = step(p0, o0, 0) if compact is None else step(p0, o0, 0,
                                                           compact)
        torch.cuda.synchronize()
        return out, ik.closest_hit.launches - before

    (pk, ok_, lk), nk = run()
    (pk2, ok2, lk2), _ = run()
    (pt, ot, lt), nt = run(plain)
    rounds = spp // min(spp, (1 << 20) // (64 * 64))
    want = 2 * mb * rounds
    def same(a, b):
        """Bitwise equality of two dicts of f32 tensors (NaN == NaN)."""
        return all(torch.equal(a[k].view(torch.int32),
                               b[k].view(torch.int32)) for k in a)

    det = bool(torch.equal(lk, lk2) and same(pk, pk2)
               and same(ok_[0].mu, ok2[0].mu))
    eq_params = bool(torch.equal(lk, lt) and same(pk, pt)
                     and same(ok_[0].mu, ot[0].mu)
                     and same(ok_[0].nu, ot[0].nu))

    def grads(compact):
        return inverse.value_and_grad(
            lambda p: inverse.render_loss(
                p, scene, camera, target, spp=spp, max_bounces=mb,
                background=kw["background"], seed=0, compact=compact), p0)

    (gl_k, g_k), (gl_t, g_t) = grads(ik.compact_rows(scene, "cuda")), \
        grads(plain)
    eq_grads = bool(torch.equal(gl_k, gl_t) and same(g_k, g_t))
    nonfinite = sum(int((~torch.isfinite(g)).sum()) for g in g_k.values())
    log(f"[train] 64x64 spp={spp} mb={mb} nee+silhouette, trainable "
        f"{'+'.join(TRAINABLE)}: loss K3 {float(lk):.9g} twin "
        f"{float(lt):.9g}; K3 == twin bitwise: loss+params+adam state "
        f"{eq_params}, gradients (every field) {eq_grads} ({nonfinite} "
        f"non-finite entries, zeroed by the step); step "
        f"deterministic {det}; K3 launches per step {nk} (expected {want}), "
        f"with the twin {nt}")
    if not (eq_params and eq_grads and det) or nk != want or nt != 0:
        raise RuntimeError("train step: K3 and twin disagree, the step is "
                           "not deterministic, or K3 launched "
                           f"{nk}/{nt} times (expected {want}/0)")
    calls = []
    real = inverse.refresh_compact

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    inverse.refresh_compact = counting
    try:
        _, losses = inverse.fit(
            template, camera, target, steps=3, spp=spp, max_bounces=mb,
            background=kw["background"], trainable=TRAINABLE,
            engine="modular", refresh_compact_every=2, device="cuda")
    finally:
        inverse.refresh_compact = real
    log(f"[train] fit(engine='modular', steps=3, refresh_compact_every=2): "
        f"losses {[round(x, 6) for x in losses]}, compactions {len(calls)} "
        "(expected 2: at the start and before step 2)")
    if len(calls) != 2 or not all(math.isfinite(x) for x in losses):
        raise RuntimeError("fit: wrong refresh schedule or non-finite loss")


def cfg5_phase(torch, presets, ik, inverse, trace_ops, Renderer, card):
    """Config 5 at full size: the port's training main path."""
    w, h, mb = CFG5["width"], CFG5["height"], CFG5["max_bounces"]
    template, camera, target, kw = _train_setup(torch, presets, Renderer, w,
                                                h, CFG5["spp"])
    finite, nonfinite = [], {}
    real_vg = inverse.value_and_grad

    def checking_vg(*a, **k):
        loss, g = real_vg(*a, **k)
        bad = {n: int((~torch.isfinite(x)).sum()) for n, x in g.items()}
        for n, c in bad.items():
            nonfinite[n] = nonfinite.get(n, 0) + c
        finite.append(bool(torch.isfinite(loss)) and not any(bad.values()))
        return loss, g

    def make(spp):
        return inverse.make_train_step(
            template, camera, target, spp=spp, max_bounces=mb,
            background=kw["background"], seed=0, trainable=TRAINABLE,
            device="cuda")

    def timed(step, state, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, loss = step(*state, i)
        value = float(loss)         # host read, as bench.py:210-215
        return (p, o), value, time.perf_counter() - t0

    # a 2-round probe prices a round; spp is the largest divisor of 200
    # whose predicted step stays under 90 % of STEP_LIMIT_S
    npix = w * h
    probe_step, state = make(4)
    timed(probe_step, state, 0)
    _, _, probe_s = timed(probe_step, state, 1)
    per_round = probe_s / trace_ops.sample_rounds(npix, 4, True)[1]

    def predicted(c):
        return trace_ops.sample_rounds(npix, c, True)[1] * per_round

    split = _probe_breakdown(torch, inverse,
                             lambda: timed(probe_step, state, 2)[2])
    log(f"[cfg5] where a 2-round step (spp=4) goes, passes timed with a "
        f"synchronize each: forward pass (render, record selections) "
        f"{split['forward_s']:.3f} s, backward pass (rebuild the graph, "
        f"backprop) {split['backward_s']:.3f} s, the rest (optimizer, "
        f"setup) {split['rest_s']:.3f} s of {split['step_s']:.3f} s; "
        f"profiled: device busy {split['device_busy']:.1%} of the step, "
        f"{split['kernels']} kernels; top by device time: "
        + "; ".join(f"{n} {ms:.1f} ms" for n, ms in split["top"]))
    spp = max([c for c in range(1, CFG5["spp"] + 1) if CFG5["spp"] % c == 0
               and predicted(c) <= 0.9 * STEP_LIMIT_S] or [1])
    cut = spp != CFG5["spp"]
    chunk = trace_ops.sample_rounds(npix, spp, True)[0]
    log(f"[cfg5] probe step at spp=4: {probe_s:.2f} s ({per_round:.3f} s "
        f"per round of {chunk * npix} rays); running spp={spp}"
        + (f" (cut from {CFG5['spp']}: one step there is predicted "
           f"{predicted(CFG5['spp']):.0f} s > {STEP_LIMIT_S:g} s)"
           if cut else ""))
    step, state = make(spp)
    counters = {"K1": 0, "K2": 0, "K3": 0}
    from tinyraytracer_tpu_torch.ops import megakernel as mk
    from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
    mkp.render_packed.launches = mk.render_flat.launches = 0
    ik.closest_hit.launches = 0
    inverse.value_and_grad = checking_vg
    try:
        state, loss0, warm_s = timed(step, state, 0)
        torch.cuda.reset_peak_memory_stats()
        times, per_step = [], []
        for i in (1, 2):
            before = ik.closest_hit.launches
            state, loss, dt = timed(step, state, i)
            times.append(dt)
            per_step.append(ik.closest_hit.launches - before)
    finally:
        inverse.value_and_grad = real_vg
    counters.update(K1=mkp.render_packed.launches,
                    K2=mk.render_flat.launches, K3=ik.closest_hit.launches)
    peak = torch.cuda.max_memory_allocated()
    step_s = min(times)
    rounds = spp // chunk
    k3_call_ms = split["k3_ms"] / max(split["k3_launches"], 1)
    ok = all(finite) and math.isfinite(loss) and all(
        bool(torch.isfinite(v).all()) for v in state[0].values())
    res = dict(probe_breakdown=split, probe_step_s=probe_s,
               width=w, height=h, spp=spp, spp_cut=cut, max_bounces=mb,
               warmup_s=warm_s, step_s=times, mrays_s=w * h * spp / step_s
               / 1e6, peak_bytes=peak, k3_launches_per_step=per_step,
               k3_ms_in_step=k3_call_ms,
               k3_share=per_step[-1] * k3_call_ms / 1e3 / times[-1],
               loss=[loss0, loss], finite=ok,
               nonfinite_gradient_entries=nonfinite, launches=counters,
               rounds=rounds)
    log(f"[cfg5] cornell_spheres {w}x{h} spp={spp} mb={mb} nee+silhouette, "
        f"trainable {'+'.join(TRAINABLE)}, K3 selection: warm-up "
        f"{warm_s:.2f} s, steps {', '.join(f'{t:.2f}' for t in times)} s; "
        f"{res['mrays_s']:.4f} fwd+bwd camera Mrays/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; K3 launches per step {per_step} "
        f"(expected {2 * mb * rounds}), {k3_call_ms:.4f} ms of device "
        f"time per launch in a step (profiled probe), so K3 is "
        f"{res['k3_share']:.3%} of the step; loss {loss0:.6g} -> "
        f"{loss:.6g}; loss and gradients finite {ok} (non-finite gradient "
        f"entries {sum(nonfinite.values())}); on {card}")
    log(f"[cfg5] launches in this main path: {counters}")
    if not ok or counters["K3"] < 1 or any(
            n != 2 * mb * rounds for n in per_step):
        raise RuntimeError("config 5: non-finite values or wrong K3 "
                           "launch count")
    return res


def _probe_breakdown(torch, inverse, run_step):
    """One probe step with its two passes timed (synchronize at each end)
    and, in a second run, the device kernels under torch.profiler."""
    spans = {"forward_s": 0.0, "backward_s": 0.0}
    real = (inverse._LossRun.render, inverse._LossRun.backprop)

    def timing(fn, key):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[key] += time.perf_counter() - t0
            return out
        return wrapped

    inverse._LossRun.render = timing(real[0], "forward_s")
    inverse._LossRun.backprop = timing(real[1], "backward_s")
    try:
        step_s = run_step()
    finally:
        inverse._LossRun.render, inverse._LossRun.backprop = real
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()]
    busy = sum(ms for _, ms, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:6]
    k3 = [(ms, c) for n, ms, c in rows if "closest_hit" in n and ms > 0]
    return dict(spans, step_s=step_s, k3_ms=sum(m for m, _ in k3),
                k3_launches=sum(c for _, c in k3),
                rest_s=step_s - spans["forward_s"] - spans["backward_s"],
                device_busy=busy / wall, profiled_wall_s=wall,
                kernels=sum(c for _, ms, c in rows if ms > 0),
                top=[(n[:60], ms) for n, ms, _ in top])


def modular_render_phase(torch, np, presets, Renderer, card):
    """Renderer(accelerator="none") on the card against the K1 render."""
    for name in ("three_spheres", "cornell_spheres", "cornell_box"):
        world, camera, kw = presets.PRESETS[name](width=64, height=48)
        mb = min(kw["max_bounces"], 8)
        imgs = [Renderer(4, max_bounces=mb, background_color=kw["background"],
                         accelerator=acc, device="cuda").render_array(
                             camera, world.build()).cpu().numpy()
                for acc in ("none", "auto")]
        got, want = imgs
        if name != "cornell_box":
            check_parity(np, f"modular vs K1 {name}", got, want)
            continue
        d = np.abs(got - want).max(-1)
        frac = float((d > PARITY_ATOL).mean())
        mean_rel = abs(got.mean() - want.mean()) / want.mean()
        log(f"[modular] modular vs K1 {name} (light/ceiling z-fight): "
            f"pixels > {PARITY_ATOL:g}: {frac:.4%}, mean rel {mean_rel:.3g} "
            f"(allowed {ZFIGHT_MAX_FRAC:.0%}, {ZFIGHT_MEAN_RTOL:g}); on {card}")
        if not np.isfinite(got).all() or frac > ZFIGHT_MAX_FRAC \
                or mean_rel > ZFIGHT_MEAN_RTOL:
            raise RuntimeError(f"{name}: modular render disagrees with K1")


PHASES = ("forward", "k3", "train", "cfg5", "modular")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phase groups to run: forward "
                    "(phases 3-7), k3 (8), train (9), cfg5 (10), modular "
                    "(11); the result lines need all of them")
    only = ap.parse_args(argv).only.split(",")
    import numpy as np
    import torch

    card = env_phase(torch)
    sys.path.insert(0, ROOT)
    from tinyraytracer_tpu_torch import Image, Renderer, _build
    from tinyraytracer_tpu_torch.diff import inverse
    from tinyraytracer_tpu_torch.models import presets
    from tinyraytracer_tpu_torch.models.camera import generate_rays
    from tinyraytracer_tpu_torch.ops import intersect_kernel as ik
    from tinyraytracer_tpu_torch.ops import megakernel as mk
    from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
    from tinyraytracer_tpu_torch.ops import trace as trace_ops

    t_start = time.perf_counter()
    build_phase(_build)
    results = {}
    if "forward" in only:
        worst = parity_phase(torch, np, presets, mk, mkp)
        launches, results = main_path_phase(torch, np, presets, mk, mkp,
                                            Renderer, card)
        breakdown_phase(torch, np, presets, mk, Image, Renderer, card,
                        results)
        for k, v in kernel_vs_twin_phase(torch, np, presets, mk, mkp, card,
                                         results).items():
            worst[k] = max(worst[k], v)
        api_phase(np, presets, Renderer)
    if "k3" in only:
        results["k3"] = k3_phase(torch, presets, ik, trace_ops,
                                 generate_rays, card)
    if "train" in only:
        train_phase(torch, presets, ik, inverse, Renderer, card)
    if "cfg5" in only:
        results["cfg5"] = cfg5_phase(torch, presets, ik, inverse, trace_ops,
                                     Renderer, card)
    if "modular" in only:
        modular_render_phase(torch, np, presets, Renderer, card)
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    with open(os.path.join(ROOT, "output", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, results=results), f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the "
        "environment check")
    if set(only) != set(PHASES):
        return 0

    def entry(kid, name, source, replaces, cfg):
        res = results[cfg]
        return {
            "name": name, "route": "cuda",
            "source": f"tinyraytracer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[kid],
            "max_abs_err": worst[kid], "ms": res["kernel_ms"],
            "plain_ms": res["twin_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            "config": cfg, "plain_shape": res["twin_shape"],
            "ms_at_plain_shape": res["kernel_ms_at_twin_shape"],
        }

    k3 = results["k3"]
    print(json.dumps({"kernels": [
        entry("K1", "megakernel_packed", "megakernel_packed.cu",
              "tinyraytracer_tpu/ops/megakernel_packed.py:125", "cfg3"),
        entry("K2", "megakernel_flat", "megakernel.cu",
              "tinyraytracer_tpu/ops/megakernel.py:489", "cfg4"),
        {"name": "closest_hit", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/closest_hit.cu",
         "replaces": "tinyraytracer_tpu/ops/intersect_pallas.py:166",
         "launches": results["cfg5"]["launches"]["K3"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None, "config": "cfg5",
         "plain_shape": f"{k3['rays']} rays",
         "ms_at_plain_shape": k3["ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
