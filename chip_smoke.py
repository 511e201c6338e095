#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed on its own lines:

1. Environment: torch and CUDA versions, the device, and the card's name
   and power limit from nvidia-smi. Fails without CUDA.
2. Build: compiles csrc/*.cu with nvcc (sm_90a, one nvcc per source, all
   started together), as shipped (--fmad=false) and, for the numerics
   comparison, with FMA contraction; prints ptxas registers and spills.
   Disassembles the library (cuobjdump) and checks that each forward
   kernel's sampler loop, the phase-1 loop of K5's and K4's image
   kernels, and the fused kernels' three loops (the replay and adjoint
   stages, the chunk loop) end on a warp vote.
3. Parity, every image bit for bit and every launch repeated bit for
   bit, at 64x48 spp=4: the packed kernel (K1) against its plain PyTorch
   twin on five scenes; the classic-layout kernel (K2) against its twin
   on random_spheres with 500 spheres (dense) and with 8000 (culled), and
   on three_spheres and cornell_box forced onto K2, where K2 must also
   equal K1 bit for bit. Then the sampler's edges (max_bounces=1, spp=7
   at spp_offset=3, a 61x37 image) and an image on each side of the
   sample split's threshold (one wave of the card), for both kernels.
4. Main path: `Renderer(...).render(camera, world)` for BASELINE configs
   1-4 and 4b at full size, one warm-up then one timed render each; the
   PNG goes to output/. Checks finite, non-negative radiance and the
   Cornell box's orientation. Both launch counters are zeroed before this
   phase; K1's must rise on configs 1-3 only, K2's on 4 and 4b only.
5. Where the time goes: the steps of one render (lowering, copies,
   kernel, readback, gamma) timed one by one beside whole renders.
6. Kernel vs twin at the configs' shapes: kernel time (CUDA events) next
   to the twin's, and the sample split the kernel took. K1's twin runs at
   full size; K2's at full resolution with fewer samples (printed beside
   its time), the kernel held to it bit for bit at that shape. At 4b the
   culled kernel must equal the unculled one bit for bit. Segments per
   camera ray (and, at 4b, sphere rows tested under the cull) are counted
   with the twin; with per-segment operation counts read off
   csrc/common.cuh they give each kernel's bound. From the same counts,
   the share of warp lanes on a path under the kernels' per-lane
   regeneration loop and under a lockstep sample loop.
7. `render_batch_array`, `render_batch` and `render_async` on the card:
   frames bitwise equal to single renders.
8. The closest-hit kernel (K3) against its twin, bit for bit on t and on
   j where it is returned, through both routes (the rows in the kernel's
   parameter bank, when the scene has at most 48 real rows, and the rows
   in device memory) and the t-only launch of shadow rays, each launch
   repeated bit for bit: primary rays (64x48 spp=4) and the scattered
   and NEE shadow rays of a traced bounce on four scenes (K3_SCENES); the
   edges (K3_EDGES: no spheres, no quads, 48 and 49 rows, two coincident
   spheres; 0, 1, 31, 33 rays and counts around a block; strided rays);
   the global route timed on the scattered and shadow rays of a scene
   that takes it (K3_GLOBAL: 501 rows, 320 000 rays); then config 5's
   own K3 inputs, captured from one round of its training render
   (720 000 rays: the primary rays and the scattered and shadow rays of
   K3_BOUNCES). There K3 is timed on every wavefront and as the
   launch-weighted mean of a round (1 primary, 19 scattered, 20 shadow
   launches), beside the twin. K3's SASS instructions per sphere and quad
   row, read off the cuobjdump listing, give the issue time of the rows.
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
12. The fused differentiable kernel (K5) against its twin: a mixed-material
   scene (32x24 spp=2 mb=5) and cornell_spheres (64x64 spp=4 mb=4), each
   with the full surrogate scope, the class scope of config 5 and that
   scope without the silhouette: the image bit for bit, the loss and every
   gradient table within TABLE_RTOL of the table's largest entry, two
   launches bit for bit; then the same checks and K5 and its twin timed
   at config 5's shape (600x600 mb=20, class scope; the twin at spp=2,
   where each thread takes several pixels), and at the edges of K5's
   loops (FUSED_EDGES: spp=1, spp=k+1 at offset 3, chunks of k=1 and 2,
   max_bounces=1, 61x37). Prints the registers, blocks per SM, grid, k
   and save slots of the cfg5f launch, and the lane model: the share of
   warp lanes on a live bounce under lockstep loops and under the
   kernel's loops, from the twin's live bounces per (pixel, sample).
13. The fused step against the modular one (cornell_spheres 64x64 spp=4
   mb=8, dense surrogates): the loss and every gradient field within
   `tests/test_diffkernel.py:_compare`'s tolerances; `fit(engine="fused")`
   and `fit(engine="auto")` run on K5 (launches counted, K3 unused).
14. Config 5 through `make_fused_train_step` at full size (600x600
   spp=200 mb=20, unless a step passes STEP_LIMIT_S): 1 warm-up and 2 timed
   steps ended by a host read of the loss; fwd+bwd camera Mrays/s, peak
   memory, K5's device time (its image and fused kernels) and the
   device's busy share under torch.profiler, finite loss and gradients. Every kernel counter is
   zeroed before these steps and read after; K5 must have run.
15. The classic-layout fused kernel (K4) against its twin: the image bit
   for bit, the loss and every table within TABLE_RTOL, two launches bit
   for bit; on the mixed-material scene forced onto K4 (full and class
   scope, where K4 must also equal K5), on random_spheres n=40 under a
   lamp (32x24 spp=2 mb=4: dense, explicit-subset and sphere-class-off
   scopes), and at bench.py's cfg4-class shape (200x200 mb=8, subset and
   dense: the twin at spp=1); the edges of phase 12 on the lamp scene's
   subset scope; K4 timed at spp=8 and 1, the twin at 1, K4's bound from
   the twin's live-bounce count, its launch and the lane model per cell.
16. bench.py's cfg4-class step through `make_fused_train_step`
   (random_spheres n=512 200x200 spp=8 mb=8, trainable sph_center +
   mat_albedo), cell cfg4class (trainable_rows = the first 8 sphere rows)
   and cfg4class-dense (none): 1 warm-up and 3 timed steps ended by a host
   read of the loss; fwd+bwd camera Mrays/s, peak memory, K4's device time
   (its image, fold and fused kernels) and the device's busy share under
   torch.profiler. Every counter is
   zeroed before and read after: K4 must run, K1-K3 and K5 must not;
   untrained rows exactly unmoved, trained ones moved, all finite.
17. Routing on the card: fit(engine="auto") on a 17-sphere scene, with and
   without trainable_rows, runs on K4; the many-sphere recipe of
   examples/manysphere_fit.py (n=128 + lamp, 128x128 spp=16 mb=4, the big
   diffuse sphere's row, Adam 0.08, 20 steps): loss and position error
   every 5 steps, the untrained rows' drift exactly 0.

18. The mesh routes (parallel/sharded.py) on meshes of the one card
   repeated (cells on one device run one after another). First, outside
   the counted window: K1 and K2 over every mesh shape against the
   twins' sharded renders bit for bit (64x48 spp=4; K2 dense and culled),
   and K1 at the sample split's threshold, where the whole image fills a
   wave and a (2, 1) shard does not. Then, with every counter zeroed:
   config 3 (K1) over (2, 1), (1, 2) and (2, 2), configs 4b and 4 (K2; 4
   at MESH_CFG4_SPP) over (2, 1): tile-only meshes bit for bit with one
   launch, sample splits within MESH_SPLIT_RTOL, each counter rising by
   the cells; config 5's fused step (K5, cfg5f's full shape) and the
   cfg4-class step (K4, trainable_rows) over 2 cells: the loss, image and
   gradient tables against one device, two steps deterministic; the
   modular step with K3 (phase 9's shape) over (1, 2); config 3's meshes
   and cfg5f's objective over a one-rank NCCL process group, bit for bit
   with the one-process mesh. Wall times of each sharded run beside the
   one-device run, in alternating pairs (median and range); with more
   than one card, a mesh of all of them.

19. The BVH accelerator (ops/bvh.py: a host build, a plain PyTorch walk
   launched op by op): build_bvh at config 4b's 8 000
   spheres on the host (time, threaded layout); traverse on the card
   against the CPU, bit for bit on (t, j), on config 4b's primary rays
   and one bounce's scattered rays (64x48 spp=4) and on Cornell's
   primary rays (the light/ceiling tie), and against K3's global route
   on the same rays (hit masks equal, winners within BVH_K3_MAX_FLIP);
   one walk of config 4b's full-size primary rays timed (median and
   range of BVH_TIME_REPS); config 4b through Renderer(accelerator="bvh") at
   400x225 spp=16 mb=50 (cut below STEP_LIMIT_S if need be): a warm-up
   with three walks profiled for the device's busy share, then
   BVH_TIME_REPS renders alternating with K2's (median and range, camera
   Mrays/s, walk iterations per bounce), every kernel counter zeroed
   before each BVH render and read after it (all must stay 0), the image
   against K2's; cornell_box at 600x600 spp=16 mb=20 against K1 and the
   dense modular route; config 4b over a (2, 1) mesh of the card, bit
   for bit with one device; the CLI's --accelerator bvh --profile DIR on
   the card (a PNG and a Chrome trace with CUDA kernel events).

`--only` runs some phase groups: forward (3-7), k3 (8), train (9), cfg5
(10), modular (11), k5 (12), fused (13), cfg5f (14), k4 (15), cfg4f
(16-17), mesh (18), bvh (19).

Prints, before the last line, one JSON object describing each kernel, and
as the last line {"ok": true, "device": {...}}. Any failure raises and
exits non-zero without that line.
"""

import glob
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

# The forward kernels' block (csrc/common.cuh, kBlockX x kBlockY): a warp
# is 32 consecutive threads of it, a 16x2 pixel tile.
FORWARD_BLOCK = (16, 8)
# Edge shapes of the sampler (phase 3): the budget kill alone, an odd
# sample count at an offset, and partial blocks; K1 on EDGE_K1, K2 on the
# FLAT_PARITY labels in EDGE_K2.
EDGE_SHAPES = [(64, 48, dict(max_bounces=1)),
               (64, 48, dict(spp=7, spp_offset=3)),
               (61, 37, {})]
EDGE_K1 = ["three_spheres", "cornell_box"]
EDGE_K2 = ["random_spheres_500", "random_spheres_8000", "three_spheres_k2"]

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
# K3's edge scenes (label, preset, random_spheres' n, extra spheres in the
# Cornell box, a coincident copy of the last sphere): no spheres; no quads
# at the bank's limit of 48 rows and one row over; spheres and quads at
# the limit and one over; two coincident spheres.
K3_EDGES = [("no spheres", "cornell_box", None, 0, False),
            ("48 spheres, no quads", "random_spheres", 48, 0, False),
            ("49 spheres, no quads", "random_spheres", 49, 0, False),
            ("18 quads + 30 spheres", "cornell_box", None, 30, False),
            ("18 quads + 31 spheres", "cornell_box", None, 31, False),
            ("two coincident spheres", "sphere_ground", None, 0, True)]
# Config 5's captured wavefronts: the scattered and shadow rays of these
# bounces (and the primary rays) are checked and timed.
K3_BOUNCES = (1, 5, 10, 19)
# K3's global route timed on a scene that takes it: examples/
# manysphere_fit.py's lit scene (lit_spheres) with config 4's 500 spheres,
# 501 real rows, at bench.py's cfg4-class image and samples (CFG4C:
# 200x200 spp=8, 320 000 rays); its scattered and shadow rays are timed.
K3_GLOBAL = dict(n=500, width=200, height=200, spp=8)
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


# K5 (csrc/diffkernel_packed.cu) against its twin on one card: the image
# bit for bit; the loss and each gradient table, which sum the same terms
# in another order, within ops/diffkernel_packed.TABLE_RTOL of the table's
# largest entry (measured on the H100: at most 2e-7 at 64x64).
# The fused step against the modular one (_compare, tests/test_diffkernel
# .py:59): the loss within 1e-4, each field within 0.1 of its largest
# entry on cornell_spheres (ulps of the hit point decide a few winner ties
# differently in the two tracers' formulas), 5e-3 elsewhere.
FUSED_LOSS_RTOL = 1e-4
FUSED_GRAD_RTOL = 0.1
# FP32 operations per live bounce of K5, read off csrc/diffkernel_packed.cu
# and counted as above (closest-hit rows as K1's: the same common.cuh
# tests): `shade` 235 without metal or dielectric (the intersection math,
# 113; the light sample, 67; the scatter, 55), color 40, state update 29,
# the shadow test 2 besides its closest hit; the adjoint besides its own
# `shade` 262; per surrogate sphere 155 (soft shadow both passes and the
# silhouette), per surrogate quad 350. Phase 1 and the replay each trace
# the bounce and its shadow ray; the adjoint re-shades it.
OPS_K5_SHADE = 235
OPS_K5_COLOR = 40
OPS_K5_ADVANCE = 29
OPS_K5_SHADOW = 2
OPS_K5_ADJ = 262
OPS_K5_SPH_SURR = 155
OPS_K5_QUAD_SURR = 350
K5_BYTES_PER_PIXEL = 24          # target in, image out
# Edge shapes of the fused kernels' loops (phases 12 and 15): label,
# image size (a window of the cell's camera), launch arguments (spp = the
# shipped k + 1 where left out), and the chunk's k for the launch (None:
# the shipped one; 1 and 2 make many chunks of a few samples).
FUSED_EDGES = [
    ("spp=1", (64, 48), dict(spp=1, max_bounces=4), None),
    ("spp=k+1 at offset 3", (64, 48), dict(max_bounces=4, spp_offset=3),
     None),
    ("spp=5 at offset 3, k=1", (64, 48), dict(spp=5, max_bounces=4,
                                              spp_offset=3), 1),
    ("spp=5 at offset 3, k=2", (64, 48), dict(spp=5, max_bounces=4,
                                              spp_offset=3), 2),
    ("max_bounces=1", (64, 48), dict(spp=2, max_bounces=1), None),
    ("61x37", (61, 37), dict(spp=2, max_bounces=4), None),
]
# The image kernel's sample split with parts of several samples (phases
# 12 and 15): SPLIT_EDGE_SPP samples over an image just under one wave of
# the image kernel, sized from its occupancy to split into at most
# SPLIT_EDGE_PARTS parts (csrc/diff_common.cuh image_thread, s0..s1).
SPLIT_EDGE_SPP = 12
SPLIT_EDGE_PARTS = 5
SPLIT_EDGE_WIDTH = 320
# Vote-latched loops of each fused-kernel variant (csrc/diff_common.cuh
# diff_thread): stage R, stage A and the chunk loop around them. Each
# image kernel (image_thread, phase 1) has one.
DIFF_VOTE_LOOPS = 3
# Back edges of each kernel that are not its vote-latched loops: walks
# over sphere, quad, light and surrogate rows, the table loads and the
# fixed-order sums, read off the SASS of the shipped build. NEE adds the
# shadow ray's and the light's walks, the silhouette its row walks. A
# sample or bounce loop rebuilt on a thread's own counters would add one.
PLAIN_BACK_EDGES = {"flat_kernel": 8, "packed_kernel": 7, "K5": 24,
                    "K4": 22, "K5 image": 8, "K4 image": 8}
PLAIN_BACK_EDGES_NEE = {"K5": 6, "K4": 6, "K5 image": 2, "K4 image": 2}
PLAIN_BACK_EDGES_SIL = {"K5": 2, "K4": 2}
# The K5 lane model at cfg5f reads every K5_LANE_EVERY-th warp of the
# image (the twin's phase 1 at spp=200).
K5_LANE_EVERY = 16
# K4 (csrc/diffkernel.cu) runs K5's estimator (csrc/diff_common.cuh), so
# the same counts hold, with two more read off the source: the light
# sample inside OPS_K5_SHADE (skipped in a scene without lights, as is
# the shadow ray), and a surrogate sphere's silhouette alone (bounce_adj's
# A1 loop: all a sphere costs when no light makes soft shadows).
OPS_K5_LIGHT = 67
OPS_K4_SPH_SIL = 88
# bench.py's cfg4-class fused step (bench.py:313-348): random_spheres
# n=512 at 200x200, spp=8, mb=8, trainable sph_center + mat_albedo, the
# first 8 sphere rows listed in trainable_rows (cell cfg4class) or none
# (cfg4class-dense: the whole sphere class runs dense surrogates).
CFG4C = dict(width=200, height=200, n=512, spp=8, max_bounces=8)
CFG4C_ROWS = 8
# examples/manysphere_fit.py's lit scene: random_spheres under a lamp.
LIT_BG = (0.01, 0.01, 0.015)


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
        text = path.with_suffix(".log").read_text()
        name = ""
        for line in text.splitlines():
            if "Compiling" in line:
                name = line
            if _diff_kernel_kind(name):
                continue
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")
        for (kernel, flags), (regs, st, ld) in sorted(ptxas_diff(
                text).items()):
            log(f"[build]   {kernel} nee/sil/met/die {flags}: {regs} "
                f"registers, spills {st} B stored, {ld} B loaded")


def vote_loops(ins):
    """Loops of a kernel's SASS (`ins`: (address, instruction) pairs) that
    end on a warp vote: a backward branch taken on the predicate a
    VOTE.ANY set a few instructions before it, directly or through an
    ISETP of the vote's register (the loop's test at its bottom), or an
    unconditional backward branch to a header that votes before any
    other branch (the test at the top; BRA.DIV, the divergent fallback of
    the vote, does not count as a branch). Returns their count and the
    count of all backward branches."""
    import re
    addrs = [int(a, 16) for a, _ in ins]
    at = {a: i for i, a in enumerate(addrs)}
    branch = re.compile(r"^(@!?P\d\s+)?BRA(?!\.DIV)\b|\bEXIT\b|\bRET\b")
    votes = back = 0
    for i, (_, x) in enumerate(ins):
        m = re.search(r"^(?:@(!?)(P\d)\s+)?BRA (?:\S+, )?0x([0-9a-f]+)",
                      x.strip())
        if not m or int(m.group(3), 16) >= addrs[i]:
            continue
        back += 1
        if m.group(2):      # conditional: set by a vote just before?
            preds = {m.group(2)}
            for j in range(i - 1, max(i - 13, -1), -1):
                y = ins[j][1].strip()
                if branch.search(y):
                    break
                v = re.search(r"VOTE\.ANY (\w+),", y)
                if v:
                    votes += v.group(1) in preds
                    break
                d = re.search(r"ISETP\S* (P\d), \w+, (R\d+)", y)
                if d and d.group(1) in preds:
                    preds.add(d.group(2))
            continue
        j = at.get(int(m.group(3), 16))
        for k in range(j, min(j + 16, len(ins))) if j is not None else ():
            if "VOTE.ANY" in ins[k][1]:
                votes += 1
                break
            if branch.search(ins[k][1].strip()):
                break
    return votes, back


def sass_phase(build):
    """Disassembles the shipped library (cuobjdump -sass, written to
    output/forward_sass.txt; a kernel that fails the check also to
    output/sass_unvoted_<n>.txt) and checks the per-lane regeneration
    loops:
    each must end on a warp vote (VOTE.ANY, vote_loops), the loops
    csrc/common.cuh and csrc/diff_common.cuh write; a compiler that
    rebuilt a bounce loop inside a sample loop would branch back on a
    thread's own counters. Each forward kernel (K1, K2) and each image
    kernel of K5 and K4 (phase 1) has one such loop; each variant of the
    fused kernels has DIFF_VOTE_LOOPS: the replay and the adjoint stages,
    and the chunk loop around them. Every other back edge is one of the
    kernel's row walks, as many as PLAIN_BACK_EDGES counts: one more is a
    loop rebuilt on a thread's own counters beside the vote-latched ones.
    Prints each kernel's instructions and 128-bit loads (read-only
    global, shared): a sphere-row walk copied into each branch of the
    sampler would show as twice the loads."""
    import re
    lib = build.library_path(fmad=False)
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    with open(os.path.join(ROOT, "output", "forward_sass.txt"), "w") as f:
        f.write(sass)
    out, bad = {}, []
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        kind = _diff_kernel_kind(name)
        if not kind:
            kind = next((k for k in ("flat_kernel", "packed_kernel")
                         if k in name), None)
        if not kind:
            continue
        want = DIFF_VOTE_LOOPS if kind in ("K5", "K4") else 1
        plain = PLAIN_BACK_EDGES[kind]
        if kind in PLAIN_BACK_EDGES_NEE:
            nee, sil = (x == "1" for x in re.search(
                r"FlagsILb(\d)ELb(\d)E", name).groups())
            plain += (nee * PLAIN_BACK_EDGES_NEE[kind]
                      + sil * PLAIN_BACK_EDGES_SIL.get(kind, 0))
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
        ldg = sum("LDG.E.128.CONSTANT" in x for _, x in ins)
        lds = sum("LDS.128" in x for _, x in ins)
        votes, back = vote_loops(ins)
        out[name] = dict(instructions=len(ins), ldg128=ldg, lds128=lds,
                         vote_loops=votes, back_edges=back)
        log(f"[sass] {name}: {len(ins)} instructions, 128-bit loads: "
            f"{ldg} read-only global, {lds} shared; loops ending on a warp "
            f"vote: {votes} (want {want}) of {back} back edges (want "
            f"{want + plain})")
        if votes != want or back - votes != plain:
            bad.append(name)
            with open(os.path.join(ROOT, "output",
                                   f"sass_unvoted_{len(bad)}.txt"), "w") as f:
                f.write(part)
    if bad:
        raise RuntimeError(f"{bad}: a regeneration loop does not end on a "
                           "warp vote, or another loop was added")
    return out


def _packed_args(renderer, width, height, spp, max_bounces, seed=0):
    low = renderer.lowered
    return dict(n_sph=low.n_sph, n_quad=low.n_quad, width=width,
                height=height, spp=spp, max_bounces=max_bounces, seed=seed,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky)


def _scene(presets, mk, name, kw, w, h, **rkw):
    world, camera, pkw = presets.PRESETS[name](width=w, height=h, **kw)
    return mk.MegakernelRenderer(world.build(), camera, pkw["background"],
                                 "cuda", **rkw), pkw


def check_parity(np, label, got, want, bitwise=False):
    """Max |d| of kernel vs twin; raises beyond the stated tolerance, or
    with `bitwise` unless every value is equal."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError(f"{label}: bad kernel output {got.shape}")
    diff = np.abs(got - want).max(-1)
    frac = float((diff > PARITY_ATOL).mean())
    mean_rel = abs(got.mean() - want.mean()) / max(want.mean(), 1e-30)
    log(f"[parity] {label}: max|d| {diff.max():.3g}, pixels > "
        f"{PARITY_ATOL:g}: {frac:.4%}, exact: {(diff == 0).mean():.4%}, "
        f"mean rel {mean_rel:.3g}")
    if bitwise and not np.array_equal(got, want):
        raise RuntimeError(f"{label}: kernel differs from the twin")
    if frac > PARITY_MAX_FRAC or mean_rel > PARITY_MEAN_RTOL:
        raise RuntimeError(f"{label}: kernel disagrees with the twin "
                           f"(tolerance atol {PARITY_ATOL} on all but "
                           f"{PARITY_MAX_FRAC:.0%} of pixels, mean rtol "
                           f"{PARITY_MEAN_RTOL})")
    return float(diff.max())


def _repeat_check(torch, label, launch, first):
    """A second launch must give the first launch's bits."""
    if not torch.equal(launch(), first):
        raise RuntimeError(f"{label}: two launches differ")


def split_threshold(query):
    """Image sizes on each side of the sample split's threshold, for a
    kernel's split query(width, height): 32 block columns and the most
    block rows that stay under one wave (split > 1), then one row more
    (split 1)."""
    bx, by = FORWARD_BLOCK
    w, h = 32 * bx, by
    while query(w, h) > 1:
        h += by
    if h == by:
        raise RuntimeError("one block row already fills a wave")
    return (w, h - by), (w, h)


def parity_phase(torch, np, presets, mk, mkp, lib):
    """K1 and K2 against their twins bit for bit at 64x48 spp=4, at the
    edge shapes and on each side of the sample split's threshold; every
    launch repeated bit for bit."""
    worst = {"K1": 0.0, "K2": 0.0}

    def k1(name, w, h, **o):
        r, kw = _scene(presets, mk, name, {}, w, h)
        args = _packed_args(r, w, h, 4, min(kw["max_bounces"], 8), seed=3)
        args.update(o)
        before = mkp.render_packed.launches
        launch = lambda: mkp.render_packed(r.table, r.cam, **args)  # noqa
        got = launch()
        torch.cuda.synchronize()
        if mkp.render_packed.launches != before + 1:
            raise RuntimeError("K1 launch counter did not rise")
        _repeat_check(torch, f"K1 {name}", launch, got)
        want = mkp.render_packed_reference(r.table, r.cam, **args)
        label = f"K1 {name} {w}x{h} " + " ".join(
            f"{k}={args[k]}" for k in ("spp", "spp_offset", "max_bounces")
            if k in args)
        worst["K1"] = max(worst["K1"], check_parity(
            np, label, got.cpu().numpy(), want.cpu().numpy(), bitwise=True))

    def k2(label, name, pkw, force, w, h, **o):
        r, kw = _scene(presets, mk, name, pkw, w, h)
        args = r.flat_args(spp=4, max_bounces=min(kw["max_bounces"], 8),
                           seed=3)
        args.update(o)
        before = mk.render_flat.launches
        got = mk.render_flat(**args)
        torch.cuda.synchronize()
        if mk.render_flat.launches != before + 1:
            raise RuntimeError("K2 launch counter did not rise")
        _repeat_check(torch, f"K2 {label}", lambda: mk.render_flat(**args),
                      got)
        twin_args = dict(args)
        twin_args.pop("aabbs")
        want = mk.render_flat_reference(**twin_args)
        worst["K2"] = max(worst["K2"], check_parity(
            np, f"K2 {label} {w}x{h} (cull {r.chunk_cull}) " + " ".join(
                f"{k}={args[k]}" for k in ("spp", "spp_offset",
                                           "max_bounces")),
            got.cpu().numpy(), want.cpu().numpy(), bitwise=True))
        if force:
            k1_img = r.render(spp=args["spp"],
                              max_bounces=args["max_bounces"], seed=3,
                              spp_offset=args["spp_offset"], packed=True)
            same = bool(torch.equal(got, k1_img))
            log(f"[parity] K2 == K1 bitwise on {name}: {same}")
            if not same:
                raise RuntimeError(f"{name}: K2 differs from K1")

    for name in PARITY_SCENES:
        k1(name, 64, 48)
    for label, name, pkw, force in FLAT_PARITY:
        k2(label, name, pkw, force, 64, 48)
    for w, h, o in EDGE_SHAPES:
        for name in EDGE_K1:
            k1(name, w, h, **o)
        for label, name, pkw, force in FLAT_PARITY:
            if label in EDGE_K2:
                k2(label, name, pkw, force, w, h, **o)

    # the sample split's threshold: K1 on cornell_box, K2 on 500 spheres
    r, _ = _scene(presets, mk, "cornell_box", {}, 64, 48)
    low = r.lowered
    k1_flags = (int(low.has_met), int(low.has_die), int(low.sky))
    r, _ = _scene(presets, mk, "random_spheres", dict(n=500), 64, 48)
    k2_flags = (int(r.flat.has_met), int(r.flat.has_die), int(r.flat.sky))
    spp = 4
    queries = {
        "K1": lambda w, h: lib.tinyrt_megakernel_packed_split(
            low.table.size, w, h, spp, *k1_flags),
        "K2": lambda w, h: lib.tinyrt_megakernel_flat_split(
            w, h, spp, *k2_flags)}
    for kid, query in queries.items():
        shapes = split_threshold(query)
        splits = [query(*wh) for wh in shapes]
        log(f"[parity] {kid} sample split threshold: {shapes[0][0]}x"
            f"{shapes[0][1]} splits {splits[0]}, {shapes[1][0]}x"
            f"{shapes[1][1]} splits {splits[1]} (spp={spp})")
        if not (splits[0] > 1 and splits[1] == 1):
            raise RuntimeError(f"{kid}: the split threshold is not where "
                               "the query says")
        for w, h in shapes:
            if kid == "K1":
                k1("cornell_box", w, h, spp=spp)
            else:
                k2("random_spheres_500", "random_spheres", dict(n=500),
                   False, w, h, spp=spp)
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


def count_work(torch, mk, fn, width, height, blocks=None, device="cuda"):
    """Runs a twin `fn()` with its shading and RNG wrapped to count the
    kernel's work, with warps of 32 consecutive threads of a block of
    FORWARD_BLOCK threads over the image.

    Per bounce it counts the pixels still on a path (bounce segments) and
    the warps with at least one (lockstep warp steps: what a warp would
    run if it ran each sample until its longest path ends). Per
    pixel it sums the segments over all the run's samples: the sampler of
    csrc/common.cuh runs one bounce per pass and starts a lane's next
    sample at once, so a warp runs as many passes as its busiest lane's
    total (regen warp passes: an estimate at the twin's spp, which leaves
    out the scheduling of the warps).

    With `blocks`, a (sph, n_sph, aabbs, chunk) tuple, it also counts the
    sphere rows the culled kernel walks: a thread tests a block when its
    ray enters the block's AABB before the best hit of the blocks before
    it (the cull is exact, so that best is the running best of the
    kernel's walk), and a lockstep warp walks the union of its threads'
    blocks. Returns a dict of sums: seg, warp_steps, regen_passes, rows,
    warp_rows."""
    tot = dict(seg=0, warp_steps=0, rows=0, warp_rows=0)
    last = {}
    shade, dense, uniform4 = mk.shade_bounce, mk.dense_closest_hit, \
        mk.rng.uniform4
    bx, by = FORWARD_BLOCK
    per_block = -(-bx * by // 32)
    pix = torch.arange(width * height, device=device)
    px, py = pix % width, pix // width
    warp_of = (((py // by) * -(-width // bx) + px // bx) * per_block
               + ((py % by) * bx + px % bx) // 32)
    nw = int(warp_of.max()) + 1
    lane_total = torch.zeros(width * height, dtype=torch.int64,
                             device=device)

    def counting_uniform4(seed, pixel_id, sample_id, stream):
        last["pid"] = pixel_id
        return uniform4(seed, pixel_id, sample_id, stream)

    def counting_shade(*a, **k):
        alive = a[12]
        pid = last["pid"]
        wid = warp_of[pid]
        per_warp = lambda x: torch.zeros(  # noqa: E731
            x.shape[:-1] + (nw,), device=x.device).index_add_(
                -1, wid, x.float()) > 0
        tot["seg"] += int(alive.sum())
        tot["warp_steps"] += int(per_warp(alive).sum())
        lane_total.index_add_(0, pid, alive.long())
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
    mk.rng.uniform4 = counting_uniform4
    try:
        out = fn()
    finally:
        mk.shade_bounce, mk.dense_closest_hit = shade, dense
        mk.rng.uniform4 = uniform4
    busiest = torch.zeros(nw, dtype=torch.int64,
                          device=device).scatter_reduce_(
        0, warp_of, lane_total, "amax")
    tot["regen_passes"] = int(busiest.sum())
    return out, tot


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


def kernel_vs_twin_phase(torch, np, presets, mk, mkp, card, results, lib):
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
            split = lib.tinyrt_megakernel_packed_split(
                low.table.size, w, h, spp, int(low.has_met),
                int(low.has_die), int(low.sky))
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
            split = lib.tinyrt_megakernel_flat_split(
                w, h, spp, int(f.has_met), int(f.has_die), int(f.sky))
        reps = 2 if label == "cfg4" else 3
        ms = time_kernel(torch, kernel, reps)
        torch.cuda.reset_peak_memory_stats()
        want, plain_ms = time_once(torch, lambda: twin(spp=twin_spp))
        twin_mem = torch.cuda.max_memory_allocated()
        want = want.cpu().numpy()
        got, ms_twin_shape = time_once(torch, lambda: kernel(spp=twin_spp))
        got = got.cpu().numpy()
        worst[res["kernel"]] = max(worst[res["kernel"]], check_parity(
            np, f"{label} {name} spp={twin_spp}", got, want, bitwise=True))
        fracs = {}
        for fmad in (False, True):
            d = np.abs(kernel(fmad=fmad, spp=twin_spp).cpu().numpy()
                       - want).max(-1)
            fracs[fmad] = (float((d > 0).mean()),
                           float((d > PARITY_ATOL).mean()))
        twin_shape = f"{w}x{h} spp={twin_spp} mb={mb}"
        res.update(kernel_ms=ms, sample_split=split, twin_ms=plain_ms,
                   twin_shape=twin_shape,
                   kernel_ms_at_twin_shape=ms_twin_shape,
                   twin_peak_bytes=twin_mem,
                   fma_off_differ=fracs[False][0],
                   fma_off_beyond_atol=fracs[False][1],
                   fma_on_differ=fracs[True][0],
                   fma_on_beyond_atol=fracs[True][1])
        log(f"[kernel] {label} {name} {w}x{h} spp={spp} mb={mb}: kernel "
            f"{ms:.2f} ms (samples split over {split} threads a pixel); twin {plain_ms:.1f} ms at {twin_shape} (kernel "
            f"at that shape {ms_twin_shape:.2f} ms, "
            f"{plain_ms / ms_twin_shape:.1f}x); twin peak device memory "
            f"{twin_mem / 2**30:.2f} GiB; on {card}")
        log(f"[kernel] {label} pixels differing from the twin: FMA off "
            f"{fracs[False][0]:.4%} (> {PARITY_ATOL:g}: "
            f"{fracs[False][1]:.4%}), FMA on {fracs[True][0]:.4%} "
            f"(> {PARITY_ATOL:g}: {fracs[True][1]:.4%})")

        # work counts with the twin at the twin's shape, scaled to spp
        blocks = None
        if res["kernel"] == "K2" and r.chunk_cull:
            t = r.flat_tensors
            blocks = (t["sph"], r.flat.n_sph, t["aabbs"],
                      min(mk.scene_table.ROW_CHUNK, t["sph"].shape[0]))
        counted, n = count_work(torch, mk, lambda: twin(spp=twin_spp), w, h,
                                blocks)
        if not np.array_equal(counted.cpu().numpy(), want):
            raise RuntimeError(f"{label}: the counted twin run differs")
        seg_per_ray = n["seg"] / (w * h * twin_spp)
        simt = n["seg"] / (32 * n["warp_steps"])
        regen = n["seg"] / (32 * n["regen_passes"])
        segments = seg_per_ray * w * h * spp
        per_seg = rows + shade_ops(*flags)
        b_ms, b_by, ops = bound(w * h * spp, segments, per_seg, 12 * w * h,
                                in_bytes)
        res.update(segments_per_ray=seg_per_ray, simt_efficiency=simt,
                   regen_lane_use=regen, bound_ms=b_ms, bound_by=b_by,
                   bound_ops=ops)
        log(f"[count] {label}: {seg_per_ray:.4f} segments per camera ray "
            f"(twin, {w}x{h} spp={twin_spp}); warp lanes on a path, "
            f"estimated from the twin's counts at spp={twin_spp} with "
            f"{FORWARD_BLOCK[0]}x{FORWARD_BLOCK[1]} blocks: {regen:.1%} "
            f"under the "
            f"per-lane regeneration loop, {simt:.1%} under a lockstep "
            f"sample loop; {per_seg} ops per segment; bound {b_ms:.3f} ms "
            f"({b_by}, {ops:.4g} ops at {FP32_PEAK / 1e12:g} TFLOP/s)")
        if blocks is not None:
            rows_per_seg = n["rows"] / n["seg"]
            warp_rows = n["warp_rows"] / n["warp_steps"]
            res.update(warp_rows_per_step=warp_rows)
            log(f"[count] {label}: a lockstep warp walks {warp_rows:.1f} "
                f"sphere rows per bounce step under the per-thread cull")
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


def api_phase(torch, np, presets, Renderer):
    """render_batch_array, render_batch and render_async on the card, one
    K1 and one K2 scene: every frame bitwise equal to a single render."""
    for name, pkw in (("sphere_ground", {}), ("random_spheres", dict(n=500))):
        world, camera, kw = presets.PRESETS[name](width=64, height=48, **pkw)
        r = Renderer(4, max_bounces=6, background_color=kw["background"],
                     seed=0, device="cuda")
        seeds = [0, 5, 11]
        frames = r.render_batch(camera, world, seeds)
        arrays = r.render_batch_array(camera, world.build(), seeds)
        for s, img, arr in zip(seeds, frames, arrays):
            r.seed = s
            if not np.array_equal(img.data, r.render(camera, world).data):
                raise RuntimeError(f"{name}: render_batch seed {s} differs")
            if not torch.equal(arr, r.render_array(camera, world.build())):
                raise RuntimeError(f"{name}: render_batch_array seed {s} "
                                   "differs")
        r.seed = 5
        handle = r.render_async(camera, world)
        polled = handle.done()
        img = handle.result()
        if not handle.done():
            raise RuntimeError("render_async: done() false after result()")
        if not np.array_equal(img.data, frames[1].data):
            raise RuntimeError(f"{name}: render_async differs from render")
        log(f"[api] {name}: render_batch_array and render_batch "
            f"{len(seeds)} frames == render_array, render; "
            f"render_async == render (done() before result(): {polled})")


class RayCapture:
    """A selection tape for `trace` that keeps a copy of the ray batches
    it is asked to select for (primary, shadow, scattered, ...): every
    call's, or those whose index is in `keep`, by call index. `kinds`
    records each call's need_j (False: an NEE shadow ray's t-only test)."""

    def __init__(self, keep=None):
        self.keep, self.rays, self.kinds = keep, {}, []

    def __call__(self, select, o, d, need_j=True):
        i = len(self.kinds)
        self.kinds.append(need_j)
        if self.keep is None or i in self.keep:
            self.rays[i] = (o.detach().clone(), d.detach().clone())
        return select(o, d, need_j)


def _device_ms(torch, fn, name, reps):
    """Mean device time (ms) of the kernels whose name holds `name` over
    `reps` calls of fn, from torch.profiler: a launch back to back with
    the next costs more host time than K3 takes on the card, so CUDA
    events around a loop would time the host."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if name in e.key
              and e.self_device_time_total > 0]
        if ev:
            return (sum(e.self_device_time_total for e in ev) / 1e3
                    / sum(e.count for e in ev))
    raise RuntimeError(f"the profiler saw no {name} kernel")


def _cfg5_wavefront(torch, presets, trace_ops, generate_rays):
    """Config 5's scene at the fit's start (`_perturbed`) and the primary
    rays of its first round (600x600, chunk 2: 720 000 rays), with their
    pixel and sample ids and the preset's settings."""
    world, camera, kw = presets.cornell_spheres(width=CFG5["width"],
                                                height=CFG5["height"])
    scene = _perturbed(torch, world.build()).to("cuda")
    npix = CFG5["width"] * CFG5["height"]
    chunk, _ = trace_ops.sample_rounds(npix, CFG5["spp"], True)
    pid, sid = trace_ops.round_ids(torch.arange(npix, device="cuda"), chunk,
                                   0)
    o, d = generate_rays(camera.to("cuda"), pid, sid, 0)
    return scene, o, d, pid, sid, kw


def cfg5_wavefronts(torch, presets, ik, trace_ops, generate_rays):
    """K3's inputs in config 5's training render (one round of
    `render_loss`'s forward pass: NEE and silhouette, seed 0), captured
    through a tape: (kind, bounce, need_j, o, d) for the primary rays and
    the scattered and shadow rays of K3_BOUNCES. Bounce b's selection is
    the round's call 2b, its NEE shadow ray's 2b + 1."""
    scene, o, d, pid, sid, kw = _cfg5_wavefront(torch, presets, trace_ops,
                                                generate_rays)
    keep = {0} | {2 * b + k for b in K3_BOUNCES for k in (0, 1)}
    cap = RayCapture(keep)
    with torch.no_grad():
        trace_ops.trace(scene, o, d, pid, sid, 0, CFG5["max_bounces"],
                        kw["background"],
                        compact=ik.compact_rows(scene, "cuda"), nee=True,
                        silhouette=True, tape=cap)
    if len(cap.kinds) != 2 * CFG5["max_bounces"] or any(
            cap.kinds[i] != (i % 2 == 0) for i in range(len(cap.kinds))):
        raise RuntimeError(f"cfg5 trace made selections {cap.kinds}")
    waves = [("primary", 0, True, *cap.rays[0])]
    for kind, k, need_j in (("scattered", 0, True), ("shadow", 1, False)):
        waves += [(kind, b, need_j, *cap.rays[2 * b + k])
                  for b in K3_BOUNCES]
    return scene, waves


def launch_weighted(times):
    """The mean K3 time per launch of one config-5 round from `times`
    {(kind, bounce): ms}: 1 primary, scattered at bounces 1..mb-1 and
    shadow at 0..mb-1, each bounce's time interpolated linearly between
    the measured bounces (held flat beyond them)."""
    import numpy as np
    mb = CFG5["max_bounces"]
    total, n = times[("primary", 0)], 1
    for kind, bounces in (("scattered", range(1, mb)),
                          ("shadow", range(mb))):
        xs = sorted(b for k, b in times if k == kind)
        ys = [times[(kind, b)] for b in xs]
        total += float(np.interp(list(bounces), xs, ys).sum())
        n += len(bounces)
    return total / n


def _k3_world(presets, base, extra_spheres=0, coincident=False):
    """An edge scene of K3 (64x48): a preset's world with `extra_spheres`
    small spheres in a grid inside the Cornell box, or with a copy of its
    last sphere under another material after it (the first must win)."""
    from tinyraytracer_tpu_torch.models.geometry import Sphere
    from tinyraytracer_tpu_torch.models.materials import Lambertian
    world, camera, kw = presets.PRESETS[base](width=64, height=48)
    if extra_spheres or coincident:
        world.add_material("k3_extra", Lambertian((0.3, 0.5, 0.7)))
    for k in range(extra_spheres):
        world.add_geometry(Sphere((10.0 + 12.0 * (k % 7),
                                   8.0 + 12.0 * (k // 7), 70.0), 4.0,
                                  "k3_extra"))
    if coincident:
        last = [g for g in world.geometries if isinstance(g, Sphere)][-1]
        world.add_geometry(Sphere(last.center, last.radius, "k3_extra"))
    return world, camera, kw


def _k3_sass_rows(ins):
    """SASS instructions per row and ray of a K3 kernel (`ins`: its
    (address, instruction) pairs): a row loop whose body holds only the
    sphere test's sqrt (MUFU.RSQ) or only the quad test's divide
    (MUFU.RCP) gives its length over their count; an unrolled walk, the
    median distance between two of them in a row.
    Only the kernel's main body counts, up to its closing self-branch
    (the slow paths of sqrt and divide follow it)."""
    import re
    addrs = [int(a, 16) for a, _ in ins]
    end = next((i for i, (a, x) in enumerate(ins)
                if re.fullmatch(rf"BRA 0x0*{int(a, 16):x}", x.strip())),
               len(ins))
    main = [x for _, x in ins[:end]]
    per = {}
    for i, x in enumerate(main):
        m = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)$", x.strip())
        if not m or int(m.group(1), 16) >= addrs[i]:
            continue
        top = addrs.index(int(m.group(1), 16))
        body = main[top:i + 1]
        n_rsq = sum("MUFU.RSQ" in y for y in body)
        n_rcp = sum("MUFU.RCP" in y for y in body)
        if n_rsq and not n_rcp:
            per.setdefault("sphere", len(body) / n_rsq)
        if n_rcp and not n_rsq:
            per.setdefault("quad", len(body) / n_rcp)
    for key, op in (("sphere", "MUFU.RSQ"), ("quad", "MUFU.RCP")):
        at = [i for i, y in enumerate(main) if op in y]
        if key not in per and len(at) > 1:
            gaps = sorted(b - a for a, b in zip(at, at[1:]))
            per[key] = float(gaps[len(gaps) // 2])
    per["main"] = len(main)
    return per


def k3_sass(sass_text):
    """_k3_sass_rows of every K3 kernel in a cuobjdump listing, keyed by
    the kernel's template arguments."""
    import re
    out = {}
    for part in sass_text.split("Function : ")[1:]:
        name = part.split()[0]
        if "closest_hit" not in name:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
        m = re.search(r"closest_hit_kernelI(.*)EEv", name)
        out[m.group(1) if m else name] = _k3_sass_rows(ins)
    return out


def _sm_clock_hz():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(smi.stdout.split()[0]) * 1e6


def issue_ms(rays, n_sph, n_quad, per, sms, clock_hz):
    """The issue time of the row tests alone: warps x (spheres x sphere +
    quads x quad instructions) over 4 warp instructions per SM per
    clock."""
    warps = -(-rays // 32)
    ins = warps * (n_sph * per.get("sphere", 0) + n_quad * per.get("quad", 0))
    return ins / (4 * sms * clock_hz) * 1e3


def k3_phase(torch, presets, ik, trace_ops, generate_rays, card):
    """K3 against its twin on the card, bit for bit on t and on j where it
    is returned, through both routes (the parameter bank, when the scene
    fits it, and the global rows) and the t-only launch, each launch
    repeated bit for bit: the wavefronts of K3_SCENES, the edges (K3_EDGES,
    ray counts and strides), K3_GLOBAL's and config 5's captured
    wavefronts. Times K3 on the last two and counts its SASS instructions
    per row. Returns the K3 record for the kernels line."""
    import dataclasses
    worst_t, worst_j = 0.0, 0

    def routes(cs):
        return ([cs, dataclasses.replace(cs, bank=None)]
                if cs.bank is not None else [cs])

    def compare(label, cs, o, d, quiet=False):
        nonlocal worst_t, worst_j
        t_r, j_r = ik.closest_hit_reference(cs, o, d)
        bad = []
        for c in routes(cs):
            for need_j in (True, False):
                outs = []
                for _ in range(2):
                    before = ik.closest_hit.launches
                    outs.append(ik.closest_hit(c, o, d, need_j))
                    torch.cuda.synchronize()
                    if ik.closest_hit.launches != before + (o.shape[0] > 0):
                        raise RuntimeError("K3 launch counter did not rise")
                (t_k, j_k), (t_2, j_2) = outs
                tag = f"{c.route}{'' if need_j else ' t-only'}"
                if need_j:
                    worst_j = max(worst_j, int((j_k != j_r).sum()))
                    if not torch.equal(j_k, j_r):
                        bad.append(f"{tag}: j")
                    if not torch.equal(j_k, j_2):
                        bad.append(f"{tag}: j repeat")
                elif j_k is not None:
                    bad.append(f"{tag}: returned j")
                if o.shape[0]:
                    worst_t = max(worst_t, float((t_k - t_r).abs().max()))
                if not torch.equal(t_k, t_r):
                    bad.append(f"{tag}: t")
                if not torch.equal(t_k, t_2):
                    bad.append(f"{tag}: t repeat")
        if not quiet or bad:
            hits = float((j_r >= 0).float().mean()) if o.shape[0] else 0.0
            log(f"[k3] {label}: {o.shape[0]} rays, hit {hits:.1%}; "
                f"{'+'.join(c.route for c in routes(cs))}, (t, j) and "
                "t-only, each launched twice: "
                + ("bit for bit with the twin" if not bad else
                   f"DIFFER {bad}"))
        if bad:
            raise RuntimeError(f"{label}: K3 differs from its twin")
        return j_r

    def traced(scene, camera, kw, spp=4):
        """Primary rays and the shadow, scattered and shadow rays of one
        traced bounce."""
        cap = RayCapture()
        pix = torch.arange(camera.width * camera.height, device="cuda")
        pid, sid = trace_ops.round_ids(pix, spp, 0)
        o, d = generate_rays(camera.to("cuda"), pid, sid, 3)
        plain = ik.compact_rows(scene, "cuda", plain=True)
        with torch.no_grad():
            trace_ops.trace(scene, o, d, pid, sid, 3, 2, kw["background"],
                            compact=plain, nee=True, tape=cap)
        labels = ["primary", "shadow (bounce 0)", "scattered (bounce 1)",
                  "shadow (bounce 1)"]
        return [(lab, *cap.rays[i]) for i, lab in enumerate(labels)]

    for name, pkw in K3_SCENES:
        world, camera, kw = presets.PRESETS[name](width=64, height=48,
                                                  **pkw)
        scene = world.build().to("cuda")
        cs = ik.compact_rows(scene, "cuda")
        for label, ro, rd in traced(scene, camera, kw):
            compare(f"{name} {label}", cs, ro, rd)

    for label, base, n, extra, coincident in K3_EDGES:
        if n is None:
            world, camera, kw = _k3_world(presets, base, extra, coincident)
        else:
            world, camera, kw = presets.PRESETS[base](width=64, height=48,
                                                      n=n)
        scene = world.build().to("cuda")
        cs = ik.compact_rows(scene, "cuda")
        want = ("bank" if cs.n_sph + cs.n_quad <= ik.BANK_MAX_ROWS
                else "global")
        if cs.route != want:
            raise RuntimeError(f"{label}: {cs.n_sph} + {cs.n_quad} rows took "
                               f"the {cs.route} route")
        for wl, ro, rd in traced(scene, camera, kw):
            j = compare(f"edge {label} {wl}", cs, ro, rd, quiet=True)
            if coincident:
                sph, im = cs.sph[:cs.n_sph].cpu(), cs.index_map.cpu()
                a, b = next((a, b) for a in range(cs.n_sph)
                            for b in range(a + 1, cs.n_sph)
                            if torch.equal(sph[a], sph[b]))
                first, second = int(im[a]), int(im[b])
                if (j == second).any() or (wl == "primary"
                                           and not (j == first).any()):
                    raise RuntimeError("coincident spheres: the second won")
        log(f"[k3] edge {label}: {cs.n_sph} spheres + {cs.n_quad} quads, "
            f"{cs.route} route; 4 wavefronts bit for bit, both routes and "
            "t-only" + ("; the first of the two rows wins every tie"
                        if coincident else ""))
    # ray counts around a warp and a block of 128, and strides
    world, camera, kw = presets.cornell_spheres(width=64, height=48)
    scene = world.build().to("cuda")
    cs = ik.compact_rows(scene, "cuda")
    _, ro, rd = traced(scene, camera, kw, spp=8)[2]
    counts = (0, 1, 31, 33, 127, 129, 389)
    for r in counts:
        compare(f"edge R={r}", cs, ro[:r], rd[:r], quiet=True)
    wide = torch.cat([ro, rd], 1)
    compare("edge (R, 3) views of an (R, 6) array", cs, wide[:, :3],
            wide[:, 3:], quiet=True)
    compare("edge (3, R).T views", cs, ro.t().contiguous().t(),
            rd.t().contiguous().t(), quiet=True)
    log(f"[k3] edges: R in {counts}, (R, 3) views of an (R, 6) array and "
        "(3, R).T views bit for bit, both routes and t-only")

    def dev_ms(fn):
        return _device_ms(torch, fn, "closest_hit", 50)

    # the global route on a scene that takes it
    g = K3_GLOBAL
    world, camera = lit_spheres(presets, g["n"], g["width"], g["height"])
    scene = world.build().to("cuda")
    cs = ik.compact_rows(scene, "cuda")
    if cs.route != "global":
        raise RuntimeError(f"{cs.n_sph + cs.n_quad} rows took the {cs.route} "
                           "route")
    glob_times = {}
    for label, o, d in traced(scene, camera, dict(background=LIT_BG),
                              g["spp"]):
        compare(f"lit random_spheres n={g['n']} {label}", cs, o, d)
        if label == "primary":
            continue
        need_j = not label.startswith("shadow")
        glob_times[label] = dev_ms(lambda o=o, d=d, need_j=need_j:
                                   ik.closest_hit(cs, o, d, need_j))
        log(f"[k3] global route, lit random_spheres n={g['n']} "
            f"{g['width']}x{g['height']} spp={g['spp']} {label} "
            f"({o.shape[0]} rays, {cs.n_sph} spheres + {cs.n_quad} quads, "
            f"{'(t, j)' if need_j else 't-only'}): K3 "
            f"{glob_times[label]:.4f} ms")
    glob_rays, glob_rows = o.shape[0], (cs.n_sph, cs.n_quad)
    t_ops = glob_rays * (cs.n_sph * OPS_K3_SPHERE_ROW
                         + cs.n_quad * OPS_K3_QUAD_ROW) / FP32_PEAK
    t_bytes = glob_rays * K3_BYTES_PER_RAY / HBM_BYTES_S
    glob_bound = max(t_ops, t_bytes) * 1e3
    log(f"[k3] global route bound: {glob_bound:.4f} ms a wavefront "
        f"({'operations' if t_ops >= t_bytes else 'bytes'})")

    scene, waves = cfg5_wavefronts(torch, presets, ik, trace_ops,
                                   generate_rays)
    cs = ik.compact_rows(scene, "cuda")
    for kind, b, _, o, d in waves:
        compare(f"cfg5 {kind} (bounce {b})", cs, o, d)

    times = {}
    r = waves[0][3].shape[0]
    for kind, b, need_j, o, d in waves:
        times[(kind, b)] = dev_ms(lambda o=o, d=d, need_j=need_j:
                                  ik.closest_hit(cs, o, d, need_j))
        log(f"[k3] cfg5 {kind} bounce {b} "
            f"({'(t, j)' if need_j else 't-only'}): K3 "
            f"{times[(kind, b)]:.4f} ms")
    mean = launch_weighted(times)
    o, d = waves[0][3], waves[0][4]
    plain_ms = time_kernel(torch, lambda: ik.closest_hit_reference(cs, o, d),
                           3)
    ops = r * (cs.n_sph * OPS_K3_SPHERE_ROW + cs.n_quad * OPS_K3_QUAD_ROW)
    t_ops, t_bytes = ops / FP32_PEAK, r * K3_BYTES_PER_RAY / HBM_BYTES_S

    def named(t):
        return {f"{k} {b}": v for (k, b), v in t.items()}

    rec = dict(rays=r, ms=times[("primary", 0)], plain_ms=plain_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               max_abs_err=worst_t, j_differing=worst_j,
               ms_launch_weighted=mean, wavefront_ms=named(times),
               global_rays=glob_rays, global_wavefront_ms=glob_times,
               global_bound_ms=glob_bound)
    log(f"[k3] cfg5 wavefronts ({r} rays, {cs.n_sph} spheres + {cs.n_quad} "
        f"quads): K3 primary {rec['ms']:.4f} ms, launch-weighted mean "
        f"{mean:.4f} ms a launch (1 primary, {CFG5['max_bounces'] - 1} "
        f"scattered, {CFG5['max_bounces']} shadow); twin "
        f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}); on {card}")

    with open(os.path.join(ROOT, "output", "forward_sass.txt")) as f:
        counts = k3_sass(f.read())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _sm_clock_hz()
    for tag, per in sorted(counts.items()):
        est = issue_ms(r, cs.n_sph, cs.n_quad, per, sms, clock)
        est_g = issue_ms(glob_rays, *glob_rows, per, sms, clock)
        log(f"[k3] sass {tag}: {per.get('sphere', 0):.1f} instructions per "
            f"sphere row and ray, {per.get('quad', 0):.1f} per quad row "
            f"({per['main']} in the main body); the rows alone issue in "
            f"{est:.4f} ms at cfg5, {est_g:.4f} ms on the global-route "
            f"scene, at {clock / 1e6:.0f} MHz on {sms} SMs")
    rec["sass_per_row"] = counts
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
    real_vg = inverse.mesh_value_and_grad

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
    inverse.mesh_value_and_grad = checking_vg
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
        inverse.mesh_value_and_grad = real_vg
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


def twin_segments(dkp, fn):
    """Runs a K5/K4 twin call `fn()` counting its phase-1 live bounces
    (the kernels' bounces: they skip the dead ones in every phase).
    Returns (fn's result, the count)."""
    n = [0]
    real = dkp._Twin.color_adds

    def counting(self, g, st, vis):
        n[0] += int((st[9] > 0.5).sum())
        return real(self, g, st, vis)

    dkp._Twin.color_adds = counting
    try:
        out = fn()
    finally:
        dkp._Twin.color_adds = real
    return out, n[0]


# The lane model of the fused kernels K5 and K4: the share of warp lanes
# their loops keep busy, from the twin's live bounces of every (pixel,
# sample), for the lockstep loops they had and the regeneration loops and
# chunked stages they run (csrc/diff_common.cuh).
WARP = 32


def lane_use(lens, max_bounces, ks=(8, 16, 32), stage_ops=None):
    """Share of warp-lane passes on a live bounce, from the live-bounce
    count of every (pixel, sample) (`lens`, (pixels, spp), pixels in id
    order; a warp is 32 consecutive pixels, as in the kernels' rounds).

    - "lockstep": a warp runs each sample until its longest path ends
      (phase 1 and, per stage, phase 3 of the kernels before per-lane
      regeneration);
    - "phase1": per-lane regeneration, a warp runs as many passes as its
      busiest lane's bounces over all samples;
    - "phase3_k<k>": chunks of k x max_bounces slots, each chunk a stage R
      and a stage A of as many passes as the warp's fullest lane holds;
    - with `stage_ops` = (replay, adjoint) operations per live bounce,
      "phase3_mixed": replay and adjoint in one regeneration loop, each
      lane replaying a sample and then walking it back; a pass costs the
      replay's operations if any lane replays and the adjoint's if any
      lane walks back, both when the lanes are split.
    Returns those shares and the sums they come from."""
    import torch
    lens = lens.to(torch.int64)
    npix, spp = lens.shape
    pad = (-npix) % WARP
    if pad:
        lens = torch.cat([lens, lens.new_zeros((pad, spp))])
    w = lens.view(-1, WARP, spp)
    live = int(lens.sum())
    lock = int(w.amax(1).sum())
    regen = int(w.sum(2).amax(1).sum())
    out = {"live": live, "lockstep_passes": lock, "phase1_passes": regen,
           "lockstep": live / max(WARP * lock, 1),
           "phase1": live / max(WARP * regen, 1)}
    for k in ks:
        passes = int(chunk_fill(lens, max_bounces, k * max_bounces).view(
            -1, WARP, spp).amax(1).sum())
        out[f"phase3_k{k}_passes"] = passes
        out[f"phase3_k{k}"] = live / max(WARP * passes, 1)
    if stage_ops is not None:
        r_ops, a_ops = stage_ops
        busy_r, busy_a = mixed_stage_passes(w)
        cost = r_ops * busy_r + a_ops * busy_a
        out["phase3_mixed"] = live * (r_ops + a_ops) / max(WARP * cost, 1)
    return out


def mixed_stage_passes(w):
    """Warp passes with a lane in the replay and with a lane in the
    adjoint, for warps `w` ((warps, 32, spp) live bounces) whose lanes
    each run, sample by sample, len passes of replay then len of adjoint
    in one loop."""
    import torch
    nw, _, spp = w.shape
    runs = w.repeat_interleave(2, dim=2)             # R, A, R, A, ...
    end = runs.cumsum(2)
    start = end - runs
    horizon = int(end.max()) + 1
    warp = torch.arange(nw)[:, None, None].expand_as(runs)
    busy = []
    for stage in (0, 1):
        sl = slice(stage, None, 2)
        diff = torch.zeros((nw, horizon + 1), dtype=torch.int64)
        diff.index_put_((warp[..., sl].flatten(), start[..., sl].flatten()),
                        torch.ones(1, dtype=torch.int64).expand(
                            start[..., sl].numel()), accumulate=True)
        diff.index_put_((warp[..., sl].flatten(), end[..., sl].flatten()),
                        -torch.ones(1, dtype=torch.int64).expand(
                            end[..., sl].numel()), accumulate=True)
        busy.append(int((diff.cumsum(1) > 0).sum()))
    return busy[0], busy[1]


def chunk_fill(lens, max_bounces, slots):
    """Slots each lane fills in each of its chunks ((pixels, spp): chunk c
    in column c, zero past the last), by the kernels' rule: a chunk starts
    empty and takes the next sample while max_bounces more slots fit."""
    import torch
    npix, spp = lens.shape
    fill = torch.zeros_like(lens)
    off = torch.zeros(npix, dtype=lens.dtype, device=lens.device)
    ch = torch.zeros(npix, dtype=torch.int64, device=lens.device)
    for s in range(spp):
        new = (off + max_bounces > slots) & (off > 0)
        ch = ch + new.long()
        off = torch.where(new, torch.zeros_like(off), off) + lens[:, s]
        fill.scatter_(1, ch[:, None], off[:, None])
    return fill


def live_bounces(dkp, tab, cam, spec, *, width, pid, spp, max_bounces,
                 seed=0, spp_offset=0):
    """Live bounces of each (pixel, sample) of the pixels `pid` (ids in a
    row-major image `width` wide): (len(pid), spp) int64, the twin's phase
    1 without its colour. These are the bounces the kernels trace, replay
    and walk back per sample (lane_use models their warps from them)."""
    import torch
    tw = dkp._Twin(tab, cam, spec, seed)
    tw.set_pixels(pid, width)
    one = torch.ones(pid.shape[0], dtype=torch.float32, device=tab.device)
    zero = torch.zeros_like(one)
    lens = torch.zeros((pid.shape[0], spp), dtype=torch.int64,
                       device=tab.device)
    for s in range(spp):
        samp = (spp_offset + s) & dkp._MASK
        st = (*tw.camera_ray(samp), one, one, one, one, zero)
        for b in range(max_bounces):
            live = st[9] > 0.5
            if not bool(live.any()):
                break
            lens[:, s] += live.long()
            best, hit, wf = tw.closest_hit(*st[:6])
            g = tw.shade(samp, b, st, best, hit, wf)
            st = tuple(torch.where(live, a2, a)
                       for a2, a in zip(tw.advance(g, st), st))
    return lens


def _diff_kernel_kind(name):
    """"K5", "K4", "K5 image", "K4 image" for a fused kernel's (mangled)
    name, else None."""
    if "image_kernel" in name:
        return "K4 image" if "classic_image_kernel" in name else "K5 image"
    if "diff_kernel" in name:
        return "K5"
    return "K4" if "classic_kernel" in name else None


def ptxas_diff(log_text):
    """Registers and spills of each fused-kernel variant from a build's
    `nvcc -Xptxas -v` log: {(kernel "K5"/"K4"/"K5 image"/"K4 image",
    (nee, sil, met, die)): (registers, spill store bytes, spill load
    bytes)}."""
    import re
    out, name, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        kind = name and _diff_kernel_kind(name)
        if m and kind:
            f = re.search(r"ILb(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
            out[(kind, tuple(bool(int(x)) for x in f.groups()))] = (
                int(m.group(1)), *spills)
            name = None
    return out


def diff_lane_model(torch, dkp, ds, tab, cvec, spec, width, height, spp, mb,
                    per_seg_fwd, per_seg_bwd, every=1, seed=0):
    """The lane model of K5/K4 (lane_use) from the twin's
    live bounces of every (pixel, sample) of every `every`-th warp:
    lockstep sample and bounce loops against phase 1's regeneration,
    phase 3's chunks at k = 8, 16, 32 and phase 3 as one loop of mixed
    replay and adjoint passes; and the ratio of warp passes, weighting
    each pass by its operations (phase 1: per_seg_fwd, phase 3:
    per_seg_bwd per live bounce, of which the replay is phase 1's without
    the colour), lockstep over the shipped k."""
    npix = width * height
    warps = torch.arange(0, -(-npix // 32), every, device=tab.device)
    pid = (warps[:, None] * 32 + torch.arange(32, device=tab.device)).flatten()
    pid = pid[pid < npix]
    lens = live_bounces(dkp, tab, cvec, spec, width=width, pid=pid, spp=spp,
                        max_bounces=mb, seed=seed)
    replay = per_seg_fwd - OPS_K5_COLOR
    u = lane_use(lens.cpu(), mb, stage_ops=(replay, per_seg_bwd - replay))
    k = ds.CHUNK_SAMPLES
    lock = per_seg_fwd / u["lockstep"] + per_seg_bwd / u["lockstep"]
    new = per_seg_fwd / u["phase1"] + per_seg_bwd / u[f"phase3_k{k}"]
    u["pass_ratio"] = lock / new
    u["pixels"] = int(pid.numel())
    return u


def _lane_line(u):
    return (f"lane use lockstep {u['lockstep']:.1%}, phase 1 regen "
            f"{u['phase1']:.1%}, phase 3 chunks k=8 {u['phase3_k8']:.1%} "
            f"k=16 {u['phase3_k16']:.1%} k=32 {u['phase3_k32']:.1%}, "
            f"phase 3 as one mixed loop {u['phase3_mixed']:.1%}; "
            f"op-weighted warp passes lockstep / new {u['pass_ratio']:.2f}x "
            f"({u['pixels']} pixels, {u['live']} live bounces)")


def _diff_launch_info(torch, dk, dkp, ds, build, kernel, spec, nw, npix,
                      spp, mb):
    """Registers, spills, blocks per SM, grid and chunk of the variant a
    K5/K4 launch of `spec` takes on this card, and of its image kernel."""
    lib = build.load()
    flags = ds.variant_flags(spec)
    regs = ptxas_diff(build.library_path().with_suffix(".log").read_text())
    dev = torch.cuda.current_device()
    if kernel == "K5":
        plan, shared = dkp.k5_plan(lib, flags, nw, spec.acc_width, npix, mb)
        per_sm = dkp._occupancy(lib, "packed", flags, nw, spec.acc_width,
                                shared, False, dev)[0]
    else:
        shared = False
        per_sm, sms = dkp._occupancy(lib, "classic", flags, 0, 0, False,
                                     False, dev)
        plan = ds.plan(npix, per_sm, sms, mb, cols_per_thread=spec.acc_width,
                       max_cols=dk.DIFF_CLASSIC_MAX_COLS)
    kern = "packed" if kernel == "K5" else "classic"
    split = dkp.image_plan(lib, kern, flags, nw, npix, spp)
    img_sm = dkp._occupancy(lib, kern, flags, nw, 0, False, True, dev)[0]
    r, st, ld = regs.get((kernel, flags), (None, None, None))
    ri, sti, ldi = regs.get((f"{kernel} image", flags), (None, None, None))
    return dict(flags=dict(zip(("nee", "sil", "met", "die"), flags)),
                registers=r, spill_stores=st, spill_loads=ld,
                blocks_per_sm=per_sm, blocks=plan.blocks,
                rounds=plan.rounds, k=ds.CHUNK_SAMPLES, slots=plan.slots,
                saves_bytes=plan.saves_floats * 4, shared_acc=shared,
                image_split=split,
                image_registers=ri, image_spills=(sti, ldi),
                image_blocks_per_sm=img_sm)


def split_edge(torch, dkp, ds, kernel, spec, nw):
    """The edge of the image kernel's sample split with parts of several
    samples: (label, (width, height), launch arguments, None), the height
    chosen from the image kernel's occupancy on this card so that the
    launch splits SPLIT_EDGE_SPP samples into more than one part and at
    most SPLIT_EDGE_PARTS."""
    from tinyraytracer_tpu_torch import _build
    kern = "packed" if kernel == "K5" else "classic"
    flags = ds.variant_flags(spec)
    per_sm, sms = dkp._occupancy(_build.load(), kern, flags, nw, 0, False,
                                 True, torch.cuda.current_device())
    blocks = -(-ds.SPLIT_WAVES * per_sm * sms // SPLIT_EDGE_PARTS)
    w = SPLIT_EDGE_WIDTH
    h = -(-blocks * ds.BLOCK // w)
    split = dkp.image_plan(_build.load(), kern, flags, nw, w * h,
                           SPLIT_EDGE_SPP)
    if not 1 < split <= SPLIT_EDGE_PARTS < SPLIT_EDGE_SPP:
        raise RuntimeError(f"{kernel}: the split edge {w}x{h} splits "
                           f"{SPLIT_EDGE_SPP} samples into {split} parts")
    return (f"image split {split} of spp={SPLIT_EDGE_SPP}", (w, h),
            dict(spp=SPLIT_EDGE_SPP, max_bounces=4, spp_offset=3), None)


def fused_edges(torch, dkp, ds, kernel, fn, label, tab, cvec, tgt, spec):
    """K5 or K4 (`fn`) against the twin at FUSED_EDGES and split_edge: the
    image bit for bit, the tables within TABLE_RTOL, two launches bit for
    bit. An edge takes the first pixels of `tgt`, or a seeded random
    target when it is larger. Returns the largest table error, absolute
    and relative."""
    worst_abs, worst_rel = 0.0, 0.0
    shipped = ds.CHUNK_SAMPLES
    nw = tab.numel() if kernel == "K5" else 0
    for edge, (w, h), args, k in [*FUSED_EDGES, split_edge(
            torch, dkp, ds, kernel, spec, nw)]:
        if k is not None:
            ds.CHUNK_SAMPLES = k
        if "spp" not in args:       # spp = k + 1 of the shipped k
            args = dict(args, spp=shipped + 1)
        try:
            sub = cvec.clone()
            sub[23] = float(w * h)
            if w * h <= tgt[..., 0].numel():
                t = tgt.reshape(-1, 3)[: w * h].reshape(h, w, 3)
            else:
                t = torch.rand((h, w, 3), device=tgt.device,
                               generator=torch.Generator(
                                   tgt.device).manual_seed(7))
            t = t.contiguous()
            kw = dict(spec=spec, width=w, height=h, seed=3, **args)
            got = fn(tab, sub, t, **kw)
            again = fn(tab, sub, t, **kw)
            want = dkp.packed_diff_reference(tab, sub, t, **kw)
        finally:
            ds.CHUNK_SAMPLES = shipped
        det = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, again))
        img_eq = torch.equal(got[0], want[0])
        rels, d = _tables_rel(torch, got, want)
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, max(rels.values()))
        log(f"[{kernel.lower()}] {label}, edge {edge} ({w}x{h}, "
            f"{', '.join(f'{a}={v}' for a, v in args.items())}"
            + (f", k={k}" if k is not None else "")
            + f"): image bitwise {img_eq}; tables within "
            f"{max(rels.values()):.3g} (allowed {dkp.TABLE_RTOL:g}); two "
            f"launches bit for bit {det}")
        if not (img_eq and det) or max(rels.values()) > dkp.TABLE_RTOL:
            raise RuntimeError(f"{kernel} {label} edge {edge}: disagrees "
                               "with its twin or is not deterministic")
    return worst_abs, worst_rel


def per_seg_split(spec):
    """Operations per live bounce of K5's phase 1 (trace, shade, shadow,
    colour, advance) and of its phase 3 (replay and adjoint), as k5_bound
    counts them."""
    rows = spec.n_sph * OPS_SPHERE_ROW + spec.n_quad * OPS_QUAD_ROW
    shade = OPS_K5_SHADE + (shade_ops(spec.has_met, spec.has_die)
                            - shade_ops(False, False))
    fwd = 2 * rows + shade + OPS_K5_SHADOW + OPS_K5_ADVANCE
    bwd = (fwd + shade + OPS_K5_ADJ + len(spec.surr_s) * OPS_K5_SPH_SURR
           + len(spec.surr_q) * OPS_K5_QUAD_SURR)
    return fwd + OPS_K5_COLOR, bwd


def k5_bound(spec, pixels, spp, segments):
    """Least time (ms) of one K5 call and what bounds it."""
    rows = spec.n_sph * OPS_SPHERE_ROW + spec.n_quad * OPS_QUAD_ROW
    shade = OPS_K5_SHADE + (shade_ops(spec.has_met, spec.has_die)
                            - shade_ops(False, False))
    n_s, n_q = len(spec.surr_s), len(spec.surr_q)
    fwd = 2 * rows + shade + OPS_K5_SHADOW + OPS_K5_ADVANCE
    per_seg = (2 * fwd + OPS_K5_COLOR + shade + OPS_K5_ADJ
               + n_s * OPS_K5_SPH_SURR + n_q * OPS_K5_QUAD_SURR)
    ops = 2 * pixels * spp * OPS_CAMERA + segments * per_seg
    t_ops = ops / FP32_PEAK
    t_bytes = pixels * K5_BYTES_PER_PIXEL / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, per_seg)


def k5_phase(torch, np, presets, dkp, card):
    """K5 against its twin on the card; returns the K5 record."""
    worst_rel, worst_abs = 0.0, 0.0
    names = ("image", "dsph", "dquad", "dmat", "dlight", "dmisc")
    scopes = [("full", {}), ("class", dict(surr_quad=False)),
              ("class, no silhouette", dict(surr_quad=False, sil=False))]
    scenes = []
    for label, maker, size, spp, mb in (
            ("mixed 32x24 spp=2 mb=5", presets.mixed_materials, (32, 24),
             2, 5),
            ("cornell_spheres 64x64 spp=4 mb=4", presets.cornell_spheres,
             (64, 64), 4, 4)):
        world, cam, kw = maker(*size)
        scenes.append((label, (world.build(), cam, kw["background"]), spp,
                       mb))
    for label, (scene, camera, bg), spp, mb in scenes:
        for scope, flags in scopes:
            tab, cvec, spec = _k5_setup(torch, dkp, scene, camera, bg,
                                        flags)
            h, w = camera.height, camera.width
            tgt = torch.from_numpy(np.random.RandomState(0).rand(
                h, w, 3).astype(np.float32) * 0.5).cuda()
            args = dict(spec=spec, width=w, height=h, spp=spp,
                        max_bounces=mb, seed=3)
            before = dkp.packed_diff.launches
            got = dkp.packed_diff(tab, cvec, tgt, **args)
            again = dkp.packed_diff(tab, cvec, tgt, **args)
            torch.cuda.synchronize()
            if dkp.packed_diff.launches != before + 2:
                raise RuntimeError("K5 launch counter did not rise")
            want = dkp.packed_diff_reference(tab, cvec, tgt, **args)
            det = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got, again))
            img_eq = torch.equal(got[0], want[0])
            rels = {}
            for n, a, b in zip(names[1:], got[1:], want[1:]):
                d = float((a - b).abs().max())
                rels[n] = d / max(float(b.abs().max()), 1e-30)
                worst_abs = max(worst_abs, d)
            worst_rel = max(worst_rel, max(rels.values()))
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            log(f"[k5] {label}, {scope} scope: image bitwise {img_eq}; "
                "tables max|d| / max|table| "
                + ", ".join(f"{n} {r:.3g}" for n, r in rels.items())
                + f" (allowed {dkp.TABLE_RTOL:g}); loss "
                f"{float(got[5][0, 3]):.9g}"
                f" twin {float(want[5][0, 3]):.9g}; two launches bit for bit "
                f"{det}; finite {finite}")
            if not (img_eq and det and finite) or max(
                    rels.values()) > dkp.TABLE_RTOL:
                raise RuntimeError(f"{label} {scope}: K5 disagrees with its "
                                   "twin or is not deterministic")

    # config 5's shape: kernel at full spp, twin (and kernel) at spp=2
    w, h, mb = CFG5["width"], CFG5["height"], CFG5["max_bounces"]
    world, cam, kw = presets.cornell_spheres(width=w, height=h)
    tab, cvec, spec = _k5_setup(torch, dkp, world.build(), cam,
                                kw["background"], dict(surr_quad=False))
    tgt = torch.rand(h, w, 3, device="cuda") * 0.5
    args = dict(spec=spec, width=w, height=h, max_bounces=mb, seed=0)
    spp, twin_spp = CFG5["spp"], 2
    ms = time_kernel(torch, lambda: dkp.packed_diff(
        tab, cvec, tgt, spp=spp, **args), 3)
    _, ms_twin_shape = time_once(torch, lambda: dkp.packed_diff(
        tab, cvec, tgt, spp=twin_spp, **args))
    want, plain_ms = time_once(torch, lambda: dkp.packed_diff_reference(
        tab, cvec, tgt, spp=twin_spp, **args))
    got = dkp.packed_diff(tab, cvec, tgt, spp=twin_spp, **args)
    again = dkp.packed_diff(tab, cvec, tgt, spp=twin_spp, **args)
    same = torch.equal(got[0], want[0])
    det = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(got, again))
    rels, cfg5_abs = {}, 0.0
    for n, a, b in zip(names[1:], got[1:], want[1:]):
        d = float((a - b).abs().max())
        rels[n] = d / max(float(b.abs().max()), 1e-30)
        cfg5_abs = max(cfg5_abs, d)
    _, segs = twin_segments(dkp, lambda: dkp.packed_diff_reference(
        tab, cvec, tgt, spp=1, **args))
    segments = segs * spp
    b_ms, b_by, ops, per_seg = k5_bound(spec, w * h, spp, segments)
    log(f"[k5] cfg5 shape {w}x{h} mb={mb} (class scope, 2 spheres + "
        f"{spec.n_quad} quads): K5 {ms:.2f} ms at spp={spp}; at spp="
        f"{twin_spp} kernel {ms_twin_shape:.2f} ms, twin {plain_ms:.1f} ms "
        f"({plain_ms / ms_twin_shape:.1f}x), image bitwise {same}, tables "
        "max|d| / max|table| " + ", ".join(f"{n} {r:.3g}" for n, r in
                                           rels.items())
        + f" (allowed {dkp.TABLE_RTOL:g}; max|d| {cfg5_abs:.3g}), loss "
        f"{float(got[5][0, 3]):.9g} twin {float(want[5][0, 3]):.9g}, two "
        f"launches bit for bit {det}; {segs / (w * h):.4f} live bounces per "
        f"camera ray (twin, spp=1), {per_seg} ops per live bounce; bound "
        f"{b_ms:.3f} ms ({b_by}, {ops:.4g} ops); on {card}")
    if not (same and det) or max(rels.values()) > dkp.TABLE_RTOL:
        raise RuntimeError("cfg5 shape: K5 disagrees with its twin or is "
                           "not deterministic")
    from tinyraytracer_tpu_torch import _build
    from tinyraytracer_tpu_torch.ops import diff_schedule as ds
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    e_abs, e_rel = fused_edges(torch, dkp, ds, "K5", dkp.packed_diff,
                               "cornell_spheres class scope", tab, cvec, tgt,
                               spec)
    info = _diff_launch_info(torch, dk, dkp, ds, _build, "K5", spec,
                             tab.numel(), w * h, spp, mb)
    fwd_ops = per_seg_split(spec)[0]
    lanes = diff_lane_model(torch, dkp, ds, tab, cvec, spec, w, h, spp, mb,
                            fwd_ops, per_seg - fwd_ops,
                            every=K5_LANE_EVERY)
    log(f"[k5] cfg5f launch: {info}; over twice the resident threads at "
        f"the cfg5 shape: {info['rounds']} pixels per thread")
    log(f"[k5] cfg5f lane model (twin, every {K5_LANE_EVERY}th warp, "
        f"spp={spp}): {_lane_line(lanes)}")
    return dict(ms=ms, plain_ms=plain_ms, ms_at_plain_shape=ms_twin_shape,
                plain_shape=f"{w}x{h} spp={twin_spp} mb={mb}",
                bound_ms=b_ms, bound_by=b_by, bound_ops=ops,
                ops_per_segment=per_seg,
                segments_per_ray=segs / (w * h),
                max_abs_err=max(worst_abs, cfg5_abs, e_abs),
                max_abs_err_cfg5_shape=cfg5_abs,
                max_rel_err=max(worst_rel, max(rels.values()), e_rel),
                launch=info, lanes=lanes)


def _k5_setup(torch, dkp, scene, camera, background, flags):
    """(table, camera vector, spec) of K5 for a scene on the card."""
    _, tab, cvec, _, spec = dkp._inputs(
        scene.to("cuda"), camera, torch.zeros(camera.height, camera.width,
                                              3), background, None, True,
        flags.get("sil", True), flags.get("surr_sph", True),
        flags.get("surr_quad", True))
    return tab, cvec, spec


def k4_fwd_ops(spec):
    """(operations of a live bounce's trace, shade and advance in K4, its
    shade alone): K5's counts, without the light sample and shadow ray in
    a scene without lights."""
    lit = spec.nee and spec.n_lights > 0
    rows = spec.n_sph * OPS_SPHERE_ROW + spec.n_quad * OPS_QUAD_ROW
    shade = OPS_K5_SHADE + (shade_ops(spec.has_met, spec.has_die)
                            - shade_ops(False, False))
    if not lit:
        shade -= OPS_K5_LIGHT
    fwd = (2 * rows + OPS_K5_SHADOW if lit else rows) + shade + OPS_K5_ADVANCE
    return fwd, shade


def k4_bound(spec, pixels, spp, segments):
    """Least time (ms) of one K4 call and what bounds it: K5's counts,
    without the light sample, shadow ray and soft shadows in a scene
    without lights (the K4 surrogate rows are the scope's)."""
    lit = spec.nee and spec.n_lights > 0
    fwd, shade = k4_fwd_ops(spec)
    per_sph = OPS_K5_SPH_SURR if lit else (OPS_K4_SPH_SIL if spec.sil
                                           else 0)
    per_quad = OPS_K5_QUAD_SURR if lit or spec.sil else 0
    per_seg = (2 * fwd + OPS_K5_COLOR + shade + OPS_K5_ADJ
               + len(spec.surr_s) * per_sph + len(spec.surr_q) * per_quad)
    ops = 2 * pixels * spp * OPS_CAMERA + segments * per_seg
    t_ops = ops / FP32_PEAK
    t_bytes = pixels * K5_BYTES_PER_PIXEL / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, per_seg)


def lit_spheres(presets, n, width, height):
    """examples/manysphere_fit.py's scene: random_spheres under a lamp
    quad. Returns (world, camera)."""
    from tinyraytracer_tpu_torch.models.geometry import Quad
    from tinyraytracer_tpu_torch.models.materials import Light

    world, camera, _ = presets.random_spheres(width=width, height=height,
                                              n=n)
    world.add_material("lamp", Light((12.0, 12.0, 12.0)))
    world.add_geometry(Quad((-4.0, 11.99, -4.0), (8.0, 0.0, 0.0),
                            (0.0, 0.0, 8.0), "lamp"))
    return world, camera


def _tables_rel(torch, got, want):
    """Per gradient table (and loss): max |d| / max |want|, and max |d|."""
    names = ("dsph", "dquad", "dmat", "dlight", "dmisc")
    rels, worst = {}, 0.0
    for n, a, b in zip(names, got[1:], want[1:]):
        d = float((a - b).abs().max())
        rels[n] = d / max(float(b.abs().max()), 1e-30)
        worst = max(worst, d)
    return rels, worst


def _k4_inputs(torch, np, dkp, scene, camera, bg, surr_sph, surr_quad):
    h, w = camera.height, camera.width
    tgt = torch.from_numpy(np.random.RandomState(0).rand(h, w, 3).astype(
        np.float32) * 0.5)
    _, tab, cvec, tgt, spec = dkp._inputs(scene.to("cuda"), camera, tgt, bg,
                                          None, True, True, surr_sph,
                                          surr_quad)
    return tab, cvec, tgt, spec


def k4_phase(torch, np, presets, dk, dkp, card):
    """K4 against its twin on the card (and against K5 where both run);
    returns the K4 record."""
    worst = dict(abs=0.0, rel=0.0)

    def check(label, args, tab, cvec, tgt, twin_args=None, k5=False):
        before = dk.classic_diff.launches
        got = dk.classic_diff(tab, cvec, tgt, **args)
        again = dk.classic_diff(tab, cvec, tgt, **args)
        torch.cuda.synchronize()
        if dk.classic_diff.launches != before + 2:
            raise RuntimeError("K4 launch counter did not rise")
        want = dkp.packed_diff_reference(tab, cvec, tgt,
                                         **(twin_args or args))
        det = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got, again))
        img_eq = torch.equal(got[0], want[0])
        rels, d = _tables_rel(torch, got, want)
        worst["abs"] = max(worst["abs"], d)
        worst["rel"] = max(worst["rel"], max(rels.values()))
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        msg = (f"[k4] {label}: image bitwise {img_eq}; tables max|d| / "
               "max|table| " + ", ".join(f"{n} {r:.3g}" for n, r in
                                         rels.items())
               + f" (allowed {dkp.TABLE_RTOL:g}; max|d| {d:.3g}); loss "
               f"{float(got[5][0, 3]):.9g} twin {float(want[5][0, 3]):.9g}; "
               f"two launches bit for bit {det}; finite {finite}")
        ok = img_eq and det and finite and max(
            rels.values()) <= dkp.TABLE_RTOL
        if k5:
            five = dkp.packed_diff(tab, cvec, tgt, **args)
            k5_img = torch.equal(got[0], five[0])
            k5_rels, _ = _tables_rel(torch, got, five)
            msg += (f"; K4 vs K5: image bitwise {k5_img}, tables within "
                    f"{max(k5_rels.values()):.3g}")
            ok = ok and k5_img and max(k5_rels.values()) <= dkp.TABLE_RTOL
        log(msg)
        if not ok:
            raise RuntimeError(f"{label}: K4 disagrees with its twin (or "
                               "K5) or is not deterministic")
        return got

    world, cam, kw = presets.mixed_materials(width=32, height=24)
    mixed = world.build()
    for scope, sq in (("full", True), ("class", False)):
        tab, cvec, tgt, spec = _k4_inputs(torch, np, dkp, mixed, cam,
                                          kw["background"], True, sq)
        check(f"mixed 32x24 spp=2 mb=5, {scope} scope, forced onto K4",
              dict(spec=spec, width=32, height=24, spp=2, max_bounces=5,
                   seed=3), tab, cvec, tgt, k5=True)
    world, cam = lit_spheres(presets, 40, 32, 24)
    lit = world.build()
    n_sph = int(lit.sph_valid.sum())
    for scope, ss in (("dense", True), ("subset", (0, 5, n_sph - 1)),
                      ("sphere class off", False)):
        tab, cvec, tgt, spec = _k4_inputs(torch, np, dkp, lit, cam, LIT_BG,
                                          ss, True)
        check(f"random_spheres n=40 + lamp 32x24 spp=2 mb=4, {scope} "
              f"scope", dict(spec=spec, width=32, height=24, spp=2,
                             max_bounces=4, seed=3), tab, cvec, tgt)
    from tinyraytracer_tpu_torch import _build
    from tinyraytracer_tpu_torch.ops import diff_schedule as ds
    world, cam = lit_spheres(presets, 40, 64, 48)
    tab, cvec, tgt, spec = _k4_inputs(torch, np, dkp, world.build(), cam,
                                      LIT_BG, (0, 5, n_sph - 1), True)
    e_abs, e_rel = fused_edges(torch, dkp, ds, "K4", dk.classic_diff,
                               "random_spheres n=40 + lamp, subset scope",
                               tab, cvec, tgt, spec)
    worst["abs"] = max(worst["abs"], e_abs)
    worst["rel"] = max(worst["rel"], e_rel)

    # bench.py's cfg4-class shape: the kernel timed at the cell's spp and
    # at spp=1, and held against the twin at both
    w, h, mb, spp = (CFG4C["width"], CFG4C["height"], CFG4C["max_bounces"],
                     CFG4C["spp"])
    world, cam, kw = presets.random_spheres(width=w, height=h, n=CFG4C["n"])
    scene = world.build()
    rec = {}
    for cell, ss in (("cfg4class", tuple(range(CFG4C_ROWS))),
                     ("cfg4class-dense", True)):
        tab, cvec, tgt, spec = _k4_inputs(torch, np, dkp, scene, cam,
                                          kw["background"], ss, False)
        args = dict(spec=spec, width=w, height=h, max_bounces=mb, seed=0)
        ms = time_kernel(torch, lambda: dk.classic_diff(
            tab, cvec, tgt, spp=spp, **args), 3)
        ms1 = time_kernel(torch, lambda: dk.classic_diff(
            tab, cvec, tgt, spp=1, **args), 3)
        chunk = TWIN_CANDIDATES // (spec.ns + spec.nq)
        (_, segs), plain_ms = time_once(torch, lambda: twin_segments(
            dkp, lambda: dkp.packed_diff_reference(
                tab, cvec, tgt, spp=1, pixel_chunk=chunk, **args)))
        info = _diff_launch_info(torch, dk, dkp, ds, _build, "K4", spec, 0,
                                 w * h, spp, mb)
        for s in (1, spp):      # the cell's spp splits the image kernel
            check(f"{cell} shape {w}x{h} spp={s} mb={mb} ({spec.n_sph} "
                  f"spheres, {len(spec.surr_s)} surrogate rows, na "
                  f"{spec.acc_width}, image split "
                  f"{info['image_split'] if s == spp else 1})",
                  dict(args, spp=s), tab, cvec, tgt,
                  twin_args=dict(args, spp=s, pixel_chunk=chunk))
        b_ms, b_by, ops, per_seg = k4_bound(spec, w * h, spp, segs * spp)
        fwd_ops = k4_fwd_ops(spec)[0] + OPS_K5_COLOR
        lanes = diff_lane_model(torch, dkp, ds, tab, cvec, spec, w, h, spp,
                                mb, fwd_ops, per_seg - fwd_ops)
        log(f"[k4] {cell} launch: {info}")
        log(f"[k4] {cell} lane model (twin, spp={spp}): {_lane_line(lanes)}")
        rec[cell] = dict(ms=ms, ms_spp1=ms1, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, bound_ops=ops,
                         ops_per_segment=per_seg,
                         segments_per_ray=segs / (w * h), launch=info,
                         lanes=lanes)
        log(f"[k4] {cell} {w}x{h} mb={mb}: K4 {ms:.3f} ms at spp={spp}, "
            f"{ms1:.3f} ms at spp=1; twin {plain_ms:.1f} ms at spp=1 "
            f"({plain_ms / ms1:.1f}x); {segs / (w * h):.4f} live bounces "
            f"per camera ray (twin, spp=1), {per_seg} ops per live bounce; "
            f"bound {b_ms:.4f} ms ({b_by}, {ops:.4g} ops), kernel "
            f"{ms / b_ms:.1f}x over it; on {card}")
    main = rec["cfg4class"]
    return dict(main, ms_at_plain_shape=main["ms_spp1"],
                plain_shape=f"{w}x{h} spp=1 mb={mb}",
                max_abs_err=worst["abs"], max_rel_err=worst["rel"],
                cells=rec)


def fused_phase(torch, presets, ik, dk, dkp, inverse, Renderer, card):
    """The fused step against the modular one, and fit's engines."""
    spp, mb = 4, 8
    template, camera, target, kw = _train_setup(torch, presets, Renderer, 64,
                                                64, 16)
    scene = template.to("cuda")
    bg = kw["background"]
    before = (dkp.packed_diff.launches, ik.closest_hit.launches)
    lf, _img, gf = dk.render_value_and_grad(
        scene, camera, target, spp=spp, max_bounces=mb, background=bg,
        seed=0)
    torch.cuda.synchronize()
    k5_n = dkp.packed_diff.launches - before[0]
    from tinyraytracer_tpu_torch.diff.params import scene_params
    lm, gm = inverse.value_and_grad(
        lambda p: inverse.render_loss(
            p, scene, camera, target, spp=spp, max_bounces=mb,
            background=bg, seed=0, compact=ik.compact_rows(scene, "cuda")),
        scene_params(scene))
    loss_rel = abs(float(lf) - float(lm)) / max(float(lm), 1e-6)
    rels = {}
    for k, g in gm.items():
        rels[k] = float((g - gf[k]).abs().max()) / max(float(g.abs().max()),
                                                        1e-8)
    log(f"[fused] cornell_spheres 64x64 spp={spp} mb={mb}, dense "
        f"surrogates: loss fused {float(lf):.9g} modular {float(lm):.9g} "
        f"(rel {loss_rel:.3g}, allowed {FUSED_LOSS_RTOL:g}); per field "
        "max|d| / max|g| " + ", ".join(f"{k} {r:.3g}" for k, r in
                                       rels.items())
        + f" (allowed {FUSED_GRAD_RTOL:g}); K5 launches {k5_n}; on {card}")
    if k5_n != 1 or loss_rel > FUSED_LOSS_RTOL or max(
            rels.values()) > FUSED_GRAD_RTOL:
        raise RuntimeError("the fused and modular gradients disagree")
    for engine, steps in (("fused", 3), ("auto", 2)):
        before = (dkp.packed_diff.launches, ik.closest_hit.launches)
        _, losses = inverse.fit(
            template, camera, target, steps=steps, spp=spp, max_bounces=mb,
            background=bg, trainable=TRAINABLE, engine=engine,
            device="cuda")
        n5 = dkp.packed_diff.launches - before[0]
        n3 = ik.closest_hit.launches - before[1]
        log(f"[fused] fit(engine={engine!r}, steps={steps}): losses "
            f"{[round(x, 6) for x in losses]}; K5 launches {n5}, K3 {n3}")
        if n5 != steps or n3 != 0 or not all(math.isfinite(x)
                                             for x in losses):
            raise RuntimeError(f"fit(engine={engine!r}) did not run on K5")


def cfg5_fused_phase(torch, presets, dk, dkp, inverse, Renderer, card):
    """Config 5 at full size through make_fused_train_step: the slice's
    main path."""
    w, h, mb = CFG5["width"], CFG5["height"], CFG5["max_bounces"]
    template, camera, target, kw = _train_setup(torch, presets, Renderer, w,
                                                h, CFG5["spp"])
    bad = {"loss": 0, "grads": 0}
    real = dk.render_value_and_grad

    def checking(*a, **k):
        loss, img, g = real(*a, **k)
        bad["loss"] += int(not bool(torch.isfinite(loss)))
        bad["grads"] += sum(int((~torch.isfinite(x)).sum())
                            for x in g.values())
        return loss, img, g

    def timed(step, state, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, loss = step(*state, i)
        value = float(loss)         # host read, as bench.py:210-215
        return (p, o), value, time.perf_counter() - t0

    def make(spp):
        return inverse.make_fused_train_step(
            template, camera, target, spp=spp, max_bounces=mb,
            background=kw["background"], seed=0, trainable=TRAINABLE,
            device="cuda")

    from tinyraytracer_tpu_torch.ops import intersect_kernel as ik
    from tinyraytracer_tpu_torch.ops import megakernel as mk
    from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
    probe, state = make(4)
    timed(probe, state, 0)
    per_sample = timed(probe, state, 1)[2] / 4
    spp = max([c for c in range(1, CFG5["spp"] + 1) if CFG5["spp"] % c == 0
               and c * per_sample <= 0.9 * STEP_LIMIT_S] or [1])
    cut = spp != CFG5["spp"]
    step, state = make(spp)
    _zero_counters(ik, mk, mkp, dk, dkp)
    dk.render_value_and_grad = checking
    try:
        state, loss0, warm_s = timed(step, state, 0)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in (1, 2):
            state, loss, dt = timed(step, state, i)
            times.append(dt)
    finally:
        dk.render_value_and_grad = real
    counters = _counters(ik, mk, mkp, dk, dkp)
    peak = torch.cuda.max_memory_allocated()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _, _ = timed(step, state, 3)
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()]
    busy_ms = sum(ms for _, ms, _ in rows)
    k5_ms = sum(ms for n, ms, _ in rows
                if _diff_kernel_kind(n) in ("K5", "K5 image")
                or "fold_kernel" in n)
    red_ms = sum(ms for n, ms, _ in rows if "reduce_kernel" in n)
    step_s = min(times)
    ok = (bad["loss"] == 0 and bad["grads"] == 0 and math.isfinite(loss)
          and all(bool(torch.isfinite(v).all()) for v in state[0].values()))
    res = dict(width=w, height=h, spp=spp, spp_cut=cut, max_bounces=mb,
               warmup_s=warm_s, step_s=times,
               mrays_s=w * h * spp / step_s / 1e6, peak_bytes=peak,
               k5_device_ms=k5_ms, reduce_device_ms=red_ms,
               device_busy=busy_ms / 1e3 / wall, profiled_wall_s=wall,
               loss=[loss0, loss], finite=ok, nonfinite=bad,
               launches=counters,
               top=sorted(rows, key=lambda r: -r[1])[:4])
    log(f"[cfg5f] cornell_spheres {w}x{h} spp={spp}"
        + (f" (cut from {CFG5['spp']})" if cut else "")
        + f" mb={mb}, trainable {'+'.join(TRAINABLE)}, fused step (K5): "
        f"warm-up {warm_s:.3f} s, steps {', '.join(f'{t:.3f}' for t in times)}"
        f" s; {res['mrays_s']:.2f} fwd+bwd camera Mrays/s; peak device "
        f"memory {peak / 2**30:.3f} GiB; profiled step: K5 {k5_ms:.1f} ms "
        f"device time, its reduction {red_ms:.3f} ms, device busy "
        f"{res['device_busy']:.1%} of {wall:.3f} s; loss {loss0:.6g} -> "
        f"{loss:.6g}; loss and gradients finite {ok}; on {card}")
    log(f"[cfg5f] launches in this main path: {counters}")
    if not ok or counters["K5"] != 3 or counters["K3"] or counters["K4"]:
        raise RuntimeError("config 5 fused: non-finite values or wrong "
                           "launch counts")
    return res


def _counters(ik, mk, mkp, dk, dkp):
    return {"K1": mkp.render_packed.launches, "K2": mk.render_flat.launches,
            "K3": ik.closest_hit.launches, "K4": dk.classic_diff.launches,
            "K5": dkp.packed_diff.launches}


def _zero_counters(ik, mk, mkp, dk, dkp):
    mkp.render_packed.launches = mk.render_flat.launches = 0
    ik.closest_hit.launches = dk.classic_diff.launches = 0
    dkp.packed_diff.launches = 0


def cfg4f_phase(torch, presets, ik, mk, mkp, dk, dkp, inverse, card):
    """bench.py's cfg4-class fused training step at full size through
    make_fused_train_step, with and without trainable_rows: this slice's
    main path. Returns the two cells' records."""
    w, h, spp, mb = (CFG4C["width"], CFG4C["height"], CFG4C["spp"],
                     CFG4C["max_bounces"])
    world, camera, kw = presets.random_spheres(width=w, height=h,
                                               n=CFG4C["n"])
    template = world.build()
    st = dk.build_diff_static(template)
    target = torch.zeros((h, w, 3))
    real = dk.render_value_and_grad
    out = {}
    for cell, rows in (("cfg4class", st.sph_rows[:CFG4C_ROWS]),
                       ("cfg4class-dense", None)):
        bad = {"loss": 0, "grads": 0}

        def checking(*a, **k):
            loss, img, g = real(*a, **k)
            bad["loss"] += int(not bool(torch.isfinite(loss)))
            bad["grads"] += sum(int((~torch.isfinite(x)).sum())
                                for x in g.values())
            return loss, img, g

        def timed(step, state, i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, loss = step(*state, i)
            value = float(loss)         # host read, as bench.py:336-339
            return (p, o), value, time.perf_counter() - t0

        step, state = inverse.make_fused_train_step(
            template, camera, target, spp=spp, max_bounces=mb,
            background=kw["background"], seed=0, trainable=TRAINABLE,
            trainable_rows=None if rows is None else {"sph": rows},
            device="cuda")
        p0 = state[0]["sph_center"].clone()
        _zero_counters(ik, mk, mkp, dk, dkp)
        dk.render_value_and_grad = checking
        try:
            state, loss0, warm_s = timed(step, state, 0)
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i in (1, 2, 3):
                state, loss, dt = timed(step, state, i)
                times.append(dt)
        finally:
            dk.render_value_and_grad = real
        counters = _counters(ik, mk, mkp, dk, dkp)
        peak = torch.cuda.max_memory_allocated()
        moved = (state[0]["sph_center"] != p0).any(-1).cpu()
        if rows is None:
            pinned_ok, listed_ok = True, bool(moved.any())
        else:
            listed = torch.zeros_like(moved)
            listed[list(rows)] = True
            pinned_ok = not bool(moved[~listed].any())
            listed_ok = bool(moved[listed].any())
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _, _ = timed(step, state, 4)
            wall = time.perf_counter() - t0
        ev = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()]
        busy_ms = sum(ms for _, ms, _ in ev)
        k4_ms = sum(ms for n, ms, _ in ev
                    if _diff_kernel_kind(n) in ("K4", "K4 image")
                    or "fold_kernel" in n)
        red_ms = sum(ms for n, ms, _ in ev if "classic_reduce" in n)
        step_s = min(times)
        ok = (bad["loss"] == 0 and bad["grads"] == 0 and math.isfinite(loss)
              and all(bool(torch.isfinite(v).all())
                      for v in state[0].values()))
        res = dict(width=w, height=h, spp=spp, max_bounces=mb,
                   n_spheres=len(st.sph_rows),
                   trainable_rows=None if rows is None else list(rows),
                   warmup_s=warm_s, step_s=times,
                   mrays_s=w * h * spp / step_s / 1e6, peak_bytes=peak,
                   k4_device_ms=k4_ms, reduce_device_ms=red_ms,
                   device_busy=busy_ms / 1e3 / wall, profiled_wall_s=wall,
                   loss=[loss0, loss], finite=ok, launches=counters,
                   pinned_rows_unmoved=pinned_ok,
                   rows_moved=int(moved.sum()),
                   top=sorted(ev, key=lambda r: -r[1])[:4])
        log(f"[cfg4f] {cell}: random_spheres n={CFG4C['n']} "
            f"({len(st.sph_rows)} spheres) {w}x{h} spp={spp} mb={mb}, "
            f"trainable {'+'.join(TRAINABLE)}, trainable_rows "
            f"{'sph[:%d]' % CFG4C_ROWS if rows is not None else 'none'}: "
            f"warm-up {warm_s:.4f} s, steps "
            f"{', '.join(f'{t:.4f}' for t in times)} s; {res['mrays_s']:.3f}"
            f" fwd+bwd camera Mrays/s; peak device memory "
            f"{peak / 2**30:.3f} GiB; profiled step: K4 {k4_ms:.3f} ms "
            f"device time, its reduction {red_ms:.3f} ms, device busy "
            f"{res['device_busy']:.1%} of {wall:.4f} s; loss {loss0:.6g} -> "
            f"{loss:.6g}; finite {ok}; untrained rows unmoved {pinned_ok}, "
            f"sphere rows moved {int(moved.sum())}; on {card}")
        log(f"[cfg4f] launches in this main path: {counters}")
        if not (ok and pinned_ok and listed_ok) or counters["K4"] != 4 or any(
                counters[k] for k in ("K1", "K2", "K3", "K5")):
            raise RuntimeError(f"{cell}: non-finite values, moved pinned "
                               "rows or wrong launch counts")
        out[cell] = res
    return out


def routing_phase(torch, presets, ik, mk, mkp, dk, dkp, inverse, optim,
                  card):
    """fit(engine="auto") routes many-sphere scenes to K4 on the card, and
    the many-sphere recipe (examples/manysphere_fit.py) trains one row."""
    world, camera, kw = presets.random_spheres(width=32, height=32, n=17)
    scene = world.build()
    st = dk.build_diff_static(scene)
    common = dict(spp=2, max_bounces=4, background=kw["background"],
                  trainable=TRAINABLE, engine="auto", device="cuda")
    for label, extra in (("", {}), (", trainable_rows sph[:2]",
                                    {"trainable_rows": {
                                        "sph": st.sph_rows[:2]}})):
        _zero_counters(ik, mk, mkp, dk, dkp)
        _, losses = inverse.fit(scene, camera, torch.zeros(32, 32, 3),
                                steps=2, **common, **extra)
        n = _counters(ik, mk, mkp, dk, dkp)
        log(f"[route] fit(engine='auto') on random_spheres n=17 "
            f"({len(st.sph_rows)} spheres){label}: losses "
            f"{[round(x, 6) for x in losses]}; launches {n}")
        if n["K4"] != 2 or n["K5"] or n["K3"] or not all(
                math.isfinite(x) for x in losses):
            raise RuntimeError("fit(engine='auto') did not run on K4")

    # examples/manysphere_fit.py: move the big diffuse sphere along z and
    # fit it back, every other row pinned
    size, spp, mb, steps = 128, 16, 4, 20
    world, camera = lit_spheres(presets, 128, size, size)
    true = world.build().to("cuda")
    rows = torch.nonzero(true.sph_valid).flatten()
    row = int(rows[torch.argmin(torch.linalg.vector_norm(
        true.sph_center[rows] - torch.tensor([-4.0, 1.0, 0.0],
                                             device="cuda"), dim=-1))])
    target = dk.render_value_and_grad(
        true, camera, torch.zeros(size, size, 3), spp=48, max_bounces=mb,
        background=LIT_BG, seed=1)[1]
    start = true.sph_center.clone()
    start[row, 2] += 1.5
    from tinyraytracer_tpu_torch.diff.params import apply_params
    scene0 = apply_params(true, {"sph_center": start})
    step, state = inverse.make_fused_train_step(
        scene0, camera, target, spp=spp, max_bounces=mb, background=LIT_BG,
        seed=0, optimizer=optim.adam(0.08), trainable=("sph_center",),
        trainable_rows={"sph": (row,)}, device="cuda")
    _zero_counters(ik, mk, mkp, dk, dkp)
    t0 = time.perf_counter()
    curve = []
    for i in range(steps):
        p, o, loss = step(*state, i)
        state = (p, o)
        if i % 5 == 0 or i == steps - 1:
            err = float(torch.linalg.vector_norm(
                p["sph_center"][row] - true.sph_center[row]))
            curve.append((i, float(loss), err))
            log(f"[route] manysphere step {i:2d}: loss {float(loss):.6f}, "
                f"position error {err:.4f}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    others = torch.ones(start.shape[0], dtype=torch.bool, device="cuda")
    others[row] = False
    drift = float((state[0]["sph_center"][others] - start[others]).abs()
                  .max())
    n = _counters(ik, mk, mkp, dk, dkp)
    log(f"[route] manysphere fit: {len(rows)} spheres + lamp {size}x{size} "
        f"spp={spp} mb={mb}, row {row} trained (start offset 1.5), Adam "
        f"0.08: {steps} steps in {dt:.2f} s; position error "
        f"{curve[0][2]:.4f} -> {curve[-1][2]:.4f}; drift of untrained rows "
        f"{drift}; launches {n}; on {card}")
    if drift != 0.0 or n["K4"] != steps or n["K5"] or not math.isfinite(
            curve[-1][1]):
        raise RuntimeError("manysphere fit: untrained rows moved, wrong "
                           "launch count or a non-finite loss")
    return dict(curve=curve, seconds=dt, drift=drift, launches=n)


# Phase 18, the mesh route (parallel/sharded.py) on the one card: meshes
# of cuda:0 repeated, (tile, sample) shapes. Config 3 through K1 over each
# of MESH_SHAPES; configs 4b (culled) and 4 (spp cut to MESH_CFG4_SPP:
# the dense walk at full resolution) through K2 over (2, 1); the fused
# steps over 2 cells; the modular step over (1, 2).
MESH_SHAPES = [(2, 1), (1, 2), (2, 2)]
MESH_CFG4_SPP = 20
# A sample split changes only the sample mean's summation order (the JAX
# package's atol 1e-6, tests/test_sharded.py:47-58): each value within
# MESH_SPLIT_RTOL x max(1, |one-device value|), since the Cornell light's
# radiance passes 1. Its distance in ulps is printed.
MESH_SPLIT_RTOL = 1e-6
# The fused steps over a mesh against one device (tests/test_diffkernel.py
# :130-160): the loss within 1e-6 relative, the image within 1e-6, each
# gradient table within 1e-5 of its largest entry. The modular step's
# sample split: the loss within 1e-5 (tests/test_diff.py:114-131), each
# gradient field within MESH_TABLE_RTOL of its largest entry.
MESH_LOSS_RTOL = 1e-6
MESH_IMG_ATOL = 1e-6
MESH_TABLE_RTOL = 1e-5
MESH_MODULAR_LOSS_RTOL = 1e-5
# Each mesh run is timed against the one-device run of the same work in
# MESH_TIME_REPS alternating pairs (which of the two runs first flips
# each pair); the median and the range [min, max] of each are printed. A
# mesh's overhead is stated only where the two ranges do not overlap.
MESH_TIME_REPS = 7


def _spread(xs):
    """(median, min, max) of a list of seconds."""
    ys = sorted(xs)
    n = len(ys)
    return (ys[(n - 1) // 2] + ys[n // 2]) / 2, ys[0], ys[-1]


def _pair_line(key, one, mesh):
    """A printable line and a record of one mesh-vs-one-device pair."""
    m1, lo1, hi1 = _spread(one)
    m2, lo2, hi2 = _spread(mesh)
    resolved = lo2 > hi1 or hi2 < lo1
    rec = dict(one_s=one, mesh_s=mesh, one_median_s=m1, mesh_median_s=m2,
               overhead=(m2 / m1 - 1) if resolved else None)
    over = (f"{m2 / m1 - 1:+.1%}" if resolved
            else "inside the spread (not resolved)")
    line = (f"{key}: one device {m1 * 1e3:.2f} ms [{lo1 * 1e3:.2f}, "
            f"{hi1 * 1e3:.2f}], mesh {m2 * 1e3:.2f} ms [{lo2 * 1e3:.2f}, "
            f"{hi2 * 1e3:.2f}] (median [min, max] of {len(one)}); mesh "
            f"overhead {over}")
    return line, rec


def _ulps(torch, a, b):
    """Largest distance in ulps between two f32 tensors of one sign."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def _mesh_twin_part(mkp, mk, r, packed, max_bounces, seed):
    """render_sharded's part function through the forward twins."""
    def part(device, begin, count, spp, offset):
        if packed:
            low = r.lowered
            table, cam = r.packed_tensors(device)
            return mkp.render_packed_reference(
                table, cam, n_sph=low.n_sph, n_quad=low.n_quad,
                width=r.camera.width, height=r.camera.height, spp=spp,
                max_bounces=max_bounces, seed=seed, spp_offset=offset,
                has_met=low.has_met, has_die=low.has_die, sky=low.sky,
                pixels=(begin, count))
        args = r.flat_args(spp=spp, max_bounces=max_bounces, seed=seed,
                           spp_offset=offset, device=device,
                           pixels=(begin, count))
        args.pop("aabbs")
        return mk.render_flat_reference(**args)
    return part


def mesh_twin_checks(torch, presets, mk, mkp, sharded, lib):
    """K1 and K2 over meshes against the twins' sharded renders, bit for
    bit, at 64x48 spp=4 (every mesh shape; K2 dense and culled) and at the
    sample split's threshold for K1 (an image that fills one wave, whose
    (2, 1) shards do not); K5 and K4 over a (2, 2) mesh against the twin
    on each cell's range. Kernel launches here are comparisons and are
    not counted."""
    dev = torch.device("cuda", 0)
    spp, mb, seed = 4, 8, 3

    def check(label, r, packed, shapes):
        w, h = r.camera.width, r.camera.height
        one = r.render(spp=spp, max_bounces=mb, seed=seed, packed=packed)
        for shape in shapes:
            mesh = sharded.make_mesh([dev] * (shape[0] * shape[1]),
                                     sample_parallel=shape[1])
            got = r.render(spp=spp, max_bounces=mb, seed=seed,
                           packed=packed, mesh=mesh)
            want = sharded.render_sharded(
                mesh, _mesh_twin_part(mkp, mk, r, packed, mb, seed),
                npix=w * h, spp=spp).view(h, w, 3)
            same = bool(torch.equal(got, want))
            tile_same = bool(torch.equal(got, one)) if shape[1] == 1 else None
            log(f"[mesh] {label} {w}x{h} spp={spp} mesh {shape}: kernel == "
                f"twin's sharded render bitwise {same}"
                + ("" if tile_same is None else
                   f", == one-device launch bitwise {tile_same}"))
            if not same or tile_same is False:
                raise RuntimeError(f"{label} mesh {shape}: the kernel's "
                                   "sharded render differs")

    r, _ = _scene(presets, mk, "cornell_box", {}, 64, 48)
    check("K1 cornell_box", r, True, MESH_SHAPES)
    r, _ = _scene(presets, mk, "random_spheres", dict(n=500), 64, 48)
    check("K2 random_spheres_500", r, False, MESH_SHAPES)
    r, _ = _scene(presets, mk, "random_spheres", dict(n=8000), 64, 48)
    check("K2 random_spheres_8000 (culled)", r, False, [(2, 1)])
    r, _ = _scene(presets, mk, "cornell_box", {}, 64, 48)
    low = r.lowered
    flags = (int(low.has_met), int(low.has_die), int(low.sky))
    query = lambda w, h: lib.tinyrt_megakernel_packed_split(  # noqa: E731
        low.table.size, w, h, spp, *flags)
    (w, h) = split_threshold(query)[1]
    shard_rows = -(-h // 2) + 1
    log(f"[mesh] K1 split threshold: {w}x{h} takes split {query(w, h)}, a "
        f"(2, 1) shard's {shard_rows} rows split {query(w, shard_rows)}")
    if not (query(w, h) == 1 and query(w, shard_rows) > 1):
        raise RuntimeError("the threshold image's shards do not split")
    r, _ = _scene(presets, mk, "cornell_box", {}, w, h)
    check("K1 cornell_box at the split threshold", r, True, [(2, 1)])

    # K5 and K4 over a (2, 2) mesh: each cell's range against the twin on
    # the same range (cornell_spheres 64x48 spp=2 mb=4, class scope; K4
    # with the first sphere row as an explicit subset)
    import numpy as np
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    world, camera, kw = presets.cornell_spheres(width=64, height=48)
    scene = world.build().to(dev)
    target = torch.from_numpy(np.random.RandomState(0).rand(
        48, 64, 3).astype(np.float32) * 0.5)
    mesh = sharded.make_mesh([dev] * 4, sample_parallel=2)
    row = dk.build_diff_static(scene).sph_rows[0]
    for kid, fn, surr in (("K5", dkp.packed_diff, (True, False)),
                          ("K4", dk.classic_diff, ((0,), False))):
        run = lambda f: dkp._value_and_grad(  # noqa: E731
            f, scene, camera, target, spp=2, max_bounces=4,
            background=kw["background"], seed=3, spp_offset=1, nee=True,
            silhouette=True, static=None, mesh=mesh, surr_sph=surr[0],
            surr_quad=surr[1])
        lk, ik_, gk = run(fn)
        lt, it, gt = run(dkp.packed_diff_reference)
        same = bool(torch.equal(ik_, it))
        rel = max(float((gk[k] - gt[k]).abs().max())
                  / max(float(gt[k].abs().max()), 1e-30) for k in gt)
        loss_rel = abs(float(lk) - float(lt)) / abs(float(lt))
        log(f"[mesh] {kid} cornell_spheres 64x48 spp=2 mb=4 over (2, 2) "
            f"(sphere row {row} {'only' if kid == 'K4' else 'class'}): "
            f"image == twin bitwise {same}, loss rel {loss_rel:.3g}, "
            f"fields (max |d| / max) worst {rel:.3g}")
        if not same or max(rel, loss_rel) > dkp.TABLE_RTOL:
            raise RuntimeError(f"{kid} over a mesh differs from its twin")


def mesh_phase(torch, presets, ik, mk, mkp, dk, dkp, inverse, sharded,
               Renderer, card):
    """Phase 18: the mesh routes on the card at full width, a
    process-group route over a one-rank NCCL group, and the times of each
    sharded run beside the one-device run. Returns its record, with the
    kernels' launches in the counted window."""
    from tinyraytracer_tpu_torch.diff.params import scene_params

    dev = torch.device("cuda", 0)
    mesh_of = lambda shape, group=None: sharded.make_mesh(  # noqa: E731
        [dev] * (shape[0] * shape[1]), sample_parallel=shape[1], group=group)
    times, res = {}, {"card": card}

    def pair(key, one, mesh_run, reps=MESH_TIME_REPS):
        """Times `one` and `mesh_run` in `reps` alternating pairs into
        times[key] = (one's seconds, the mesh's seconds)."""
        got = ([], [])
        for i in range(reps):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (one, mesh_run)[j]()
                torch.cuda.synchronize()
                got[j].append(time.perf_counter() - t0)
        times[key] = got

    def rises(name, fn, n):
        before = _counters(ik, mk, mkp, dk, dkp)[name]
        out = fn()
        torch.cuda.synchronize()
        got = _counters(ik, mk, mkp, dk, dkp)[name] - before
        if got != n:
            raise RuntimeError(f"{name} launched {got} times, expected {n}")
        return out

    _zero_counters(ik, mk, mkp, dk, dkp)
    # -- forward: config 3 (K1) over each shape, 4b and 4 (K2) over (2, 1)
    fwd = {}
    for label, name, pkw, w, h, spp, mb, _ in CONFIGS:
        if label not in ("cfg3", "cfg4b", "cfg4"):
            continue
        if label == "cfg4":
            spp = MESH_CFG4_SPP
        world, camera, kw = presets.PRESETS[name](width=w, height=h, **pkw)
        r = mk.MegakernelRenderer(world.build(), camera, kw["background"],
                                  dev)
        kid = "K1" if label == "cfg3" else "K2"
        render = lambda mesh=None: r.render(  # noqa: E731
            spp=spp, max_bounces=mb, seed=0, mesh=mesh)
        rises(kid, render, 1)                              # warm-up
        one = rises(kid, render, 1)
        shapes = MESH_SHAPES if label == "cfg3" else [(2, 1)]
        for shape in shapes:
            mesh = mesh_of(shape)
            rises(kid, lambda: render(mesh), mesh.size)    # warm-up
            img = rises(kid, lambda: render(mesh), mesh.size)
            pair(f"{label} mesh {shape}", render, lambda: render(mesh))
            d = float((img - one).abs().max())
            ulps = _ulps(torch, img, one)
            if shape[1] == 1:
                ok = bool(torch.equal(img, one))
            else:
                tol = MESH_SPLIT_RTOL * torch.clamp_min(one.abs(), 1.0)
                ok = bool(((img - one).abs() <= tol).all())
            fwd[f"{label} {shape}"] = dict(max_abs=d, max_ulps=ulps, ok=ok)
            log(f"[mesh] {label} {name} {w}x{h} spp={spp} mb={mb} ({kid}) "
                f"mesh {shape}: {'bitwise' if shape[1] == 1 else 'split'} "
                f"check {ok}, max |d| {d:.3g} ({ulps} ulp)")
            if not ok:
                raise RuntimeError(f"{label} mesh {shape}: the sharded "
                                   "render differs from one device")
        if label == "cfg3":       # the public API's mesh: Renderer(devices=)
            rnd = Renderer(spp, max_bounces=mb,
                           background_color=kw["background"], seed=0,
                           devices=[dev] * 4, sample_parallel=2)
            fb = rises(kid, lambda: rnd.render_array(camera, r.scene), 4)
            same = bool(torch.equal(fb, img))
            log(f"[mesh] Renderer(devices=[cuda:0] * 4, sample_parallel=2)"
                f" {rnd.mesh!r}: == MegakernelRenderer.render(mesh=) "
                f"bitwise {same}")
            if not same:
                raise RuntimeError("Renderer's mesh route differs")
    res["forward"] = fwd

    # -- the fused steps over 2 cells: cfg5f (K5) and cfg4class (K4)
    w, h, mb = CFG5["width"], CFG5["height"], CFG5["max_bounces"]
    template, camera, target, kw = _train_setup(torch, presets, Renderer, w,
                                                h, CFG5["spp"])
    world4, camera4, kw4 = presets.random_spheres(
        width=CFG4C["width"], height=CFG4C["height"], n=CFG4C["n"])
    template4 = world4.build()
    rows4 = dk.build_diff_static(template4).sph_rows[:CFG4C_ROWS]
    fused = {}
    for cell, kid, tmpl, cam, tgt, bg, spp, mbb, rows in (
            ("cfg5f", "K5", template, camera, target, kw["background"],
             CFG5["spp"], mb, None),
            ("cfg4class", "K4", template4, camera4,
             torch.zeros((CFG4C["height"], CFG4C["width"], 3)),
             kw4["background"], CFG4C["spp"], CFG4C["max_bounces"],
             {"sph": rows4})):
        mesh = mesh_of((2, 1))
        # the surrogate scope make_fused_train_step takes for TRAINABLE
        surr = {"sph": None if rows is None else rows["sph"], "quad": ()}
        scene = tmpl.to(dev)
        vg = lambda m=None: dk.render_value_and_grad(  # noqa: E731
            scene, cam, tgt, spp=spp, max_bounces=mbb, background=bg,
            seed=0, surr_rows=surr, mesh=m)
        l1, i1, g1 = rises(kid, vg, 1)
        lm, im, gm = rises(kid, lambda: vg(mesh), 2)
        loss_rel = abs(float(lm) - float(l1)) / abs(float(l1))
        img_d = float((im - i1).abs().max())
        tabs = {k: float((gm[k] - g1[k]).abs().max())
                / max(float(g1[k].abs().max()), 1e-30) for k in g1}
        make = lambda m=None: inverse.make_fused_train_step(  # noqa: E731
            tmpl, cam, tgt, spp=spp, max_bounces=mbb, background=bg,
            seed=0, trainable=TRAINABLE, trainable_rows=rows, mesh=m,
            device=dev)
        s1, st1 = make()
        sm, stm = make(mesh)
        rises(kid, lambda: s1(*st1, 0), 1)                 # warm-up
        rises(kid, lambda: sm(*stm, 0), 2)
        a = rises(kid, lambda: s1(*st1, 0), 1)
        b = rises(kid, lambda: sm(*stm, 0), 2)
        c = rises(kid, lambda: sm(*stm, 0), 2)
        b2 = rises(kid, lambda: sm(b[0], b[1], 1), 2)
        c2 = rises(kid, lambda: sm(c[0], c[1], 1), 2)
        det = all(bool(torch.equal(x[0][k], y[0][k])) for x, y in
                  ((b, c), (b2, c2)) for k in x[0]) and bool(
            torch.equal(b2[2], c2[2]))
        step_rel = abs(float(b[2]) - float(a[2])) / abs(float(a[2]))
        ok = (loss_rel <= MESH_LOSS_RTOL and img_d <= MESH_IMG_ATOL
              and max(tabs.values()) <= MESH_TABLE_RTOL and det
              and step_rel <= MESH_LOSS_RTOL)
        fused[cell] = dict(loss_rel=loss_rel, img_max_abs=img_d,
                           table_rel=tabs, deterministic=det,
                           step_loss_rel=step_rel, ok=ok)
        log(f"[mesh] {cell} ({kid}) {cam.width}x{cam.height} spp={spp} "
            f"mb={mbb} over 2 cells: loss rel {loss_rel:.3g}, image max "
            f"|d| {img_d:.3g}, tables (max |d| / max) worst "
            f"{max(tabs.values()):.3g}; two steps deterministic {det}; step "
            f"loss rel {step_rel:.3g}")
        if not ok:
            raise RuntimeError(f"{cell} over 2 cells disagrees with one "
                               "device or is not deterministic")
        pair(f"{cell} step mesh (2, 1)", lambda: s1(*st1, 0),
             lambda: sm(*stm, 0))
    res["fused"] = fused

    # -- the modular step with K3 (phase 9's shape) over (1, 2)
    mspp, mmb = 4, 8
    mtmpl, mcam, mtgt, mkw = _train_setup(torch, presets, Renderer, 64, 64,
                                          16)
    mscene = mtmpl.to(dev)
    compact = ik.compact_rows(mscene, dev)
    p0 = scene_params(mscene)
    mesh = mesh_of((1, 2))
    lkw = dict(spp=mspp, max_bounces=mmb, background=mkw["background"],
               seed=0)
    l1, g1 = rises("K3", lambda: inverse.value_and_grad(
        lambda p: inverse.render_loss(p, mscene, mcam, mtgt, compact=compact,
                                      **lkw), p0), 2 * mmb)
    lm, gm = rises("K3", lambda: inverse.mesh_value_and_grad(
        mesh, p0, mscene, mcam, mtgt, compact=compact, **lkw), 2 * 2 * mmb)
    loss_rel = abs(float(lm) - float(l1)) / abs(float(l1))
    grel = {k: float((gm[k] - g1[k]).abs().max())
            / max(float(g1[k].abs().max()), 1e-30) for k in TRAINABLE}
    make = lambda m=None: inverse.make_train_step(  # noqa: E731
        mtmpl, mcam, mtgt, trainable=TRAINABLE, use_kernel=True, mesh=m,
        device=dev, **lkw)
    s1, st1 = make()
    sm, stm = make(mesh)
    a = s1(*st1, 0)
    b = sm(*stm, 0)
    c = sm(*stm, 0)
    det = all(bool(torch.equal(b[0][k], c[0][k])) for k in b[0]) and bool(
        torch.equal(b[2], c[2]))
    close = all(bool(torch.allclose(b[0][k], a[0][k], rtol=1e-3, atol=1e-6))
                for k in a[0])
    ok = (loss_rel <= MESH_MODULAR_LOSS_RTOL and det and close
          and max(grel.values()) <= MESH_TABLE_RTOL)
    res["modular"] = dict(loss_rel=loss_rel, grad_rel=grel,
                          deterministic=det, params_close=close, ok=ok)
    log(f"[mesh] modular step (K3) 64x64 spp={mspp} mb={mmb} over (1, 2): "
        f"loss rel {loss_rel:.3g}, trained fields' gradients (max |d| / "
        f"max) {', '.join(f'{k} {v:.3g}' for k, v in grel.items())}; "
        f"deterministic {det}; params after a step within rtol 1e-3 "
        f"{close}")
    if not ok:
        raise RuntimeError("the modular mesh step disagrees with one "
                           "device or is not deterministic")
    pair("modular step mesh (1, 2)", lambda: s1(*st1, 0),
         lambda: sm(*stm, 0))

    # -- the process-group route: a one-rank NCCL group
    res["group"] = mesh_group_route(torch, presets, mk, dk, sharded, dev,
                                    template, camera, target, kw, mesh_of,
                                    pair)
    launches = _counters(ik, mk, mkp, dk, dkp)
    log(f"[mesh] launches in the mesh phase: {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError("the mesh phase did not launch every kernel")

    # -- times
    log(f"[mesh] times on {card} (wall, synchronised; repeated cells of "
        "one card run one after another):")
    res["pairs"] = {}
    for k, (one, mesh_s) in times.items():
        line, res["pairs"][k] = _pair_line(k, one, mesh_s)
        log(f"[mesh]   {line}")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        res["multi_card"] = multi_card_times(torch, presets, mk, dk, sharded,
                                             template, camera, target, kw)
    else:
        log("[mesh] multi-GPU scaling: not measured (one card)")
        res["multi_card"] = None
    res.update(launches=launches)
    return res


def mesh_group_route(torch, presets, mk, dk, sharded, dev, template, camera,
                     target, kw, mesh_of, pair):
    """Config 3's meshes and config 5's fused objective over a one-rank
    NCCL process group (file:// rendezvous under output/): the same bits
    as the one-process mesh of the same shape, and the one-device
    checks."""
    import torch.distributed as dist

    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    rdv = os.path.join(ROOT, "output", "chip_smoke_rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    out = {}
    try:
        group = dist.group.WORLD
        _, name, _, w, h, spp, mb, _ = CONFIGS[2]             # cfg3
        world, cam3, kw3 = presets.PRESETS[name](width=w, height=h)
        r = mk.MegakernelRenderer(world.build(), cam3, kw3["background"],
                                  dev)
        render = lambda mesh=None: r.render(  # noqa: E731
            spp=spp, max_bounces=mb, seed=0, mesh=mesh)
        one = render()
        for shape in ((2, 1), (1, 2)):
            gm = mesh_of(shape, group)
            render(gm)              # warm-up: NCCL makes its communicator
            got = render(gm)
            pair(f"cfg3 group mesh {shape}", render, lambda: render(gm))
            same = bool(torch.equal(got, render(mesh_of(shape))))
            tile = bool(torch.equal(got, one)) if shape[1] == 1 else None
            out[f"cfg3 {shape}"] = dict(same_as_one_process=same,
                                        tile_bitwise=tile)
            log(f"[mesh] group route, cfg3 mesh {shape} ({gm!r}): == "
                f"one-process mesh bitwise {same}"
                + ("" if tile is None else f", == one device {tile}"))
            if not same or tile is False:
                raise RuntimeError(f"group route cfg3 {shape} differs")
        scene = template.to(dev)
        vg = lambda m=None: dk.render_value_and_grad(  # noqa: E731
            scene, camera, target, spp=CFG5["spp"],
            max_bounces=CFG5["max_bounces"], background=kw["background"],
            seed=0, surr_rows={"sph": None, "quad": ()}, mesh=m)
        vg(mesh_of((2, 1), group))
        lg, ig, gg = vg(mesh_of((2, 1), group))
        pair("cfg5f objective group mesh (2, 1)", vg,
             lambda: vg(mesh_of((2, 1), group)))
        lp, ip, gp = vg(mesh_of((2, 1)))
        l1 = vg()[0]
        same = (bool(torch.equal(lg, lp)) and bool(torch.equal(ig, ip))
                and all(bool(torch.equal(gg[k], gp[k])) for k in gg))
        rel = abs(float(lg) - float(l1)) / abs(float(l1))
        out["cfg5f (2, 1)"] = dict(same_as_one_process=same, loss_rel=rel)
        log(f"[mesh] group route, cfg5f over 2 cells: loss, image and "
            f"gradients == one-process mesh bitwise {same}; loss rel to "
            f"one device {rel:.3g}")
        if not same or rel > MESH_LOSS_RTOL:
            raise RuntimeError("group route cfg5f differs")
    finally:
        dist.destroy_process_group()
        if os.path.exists(rdv):
            os.remove(rdv)
    return out


def multi_card_times(torch, presets, mk, dk, sharded, template, camera,
                     target, kw):
    """Config 3 and config 5's fused objective over a tile mesh of every
    card, timed beside one card."""
    mesh = sharded.make_mesh()
    _, name, _, w, h, spp, mb, _ = CONFIGS[2]                 # cfg3
    world, cam3, kw3 = presets.PRESETS[name](width=w, height=h)
    r = mk.MegakernelRenderer(world.build(), cam3, kw3["background"],
                              mesh.device)
    out = {}
    for label, fn in (
            ("cfg3", lambda m=None: r.render(spp=spp, max_bounces=mb,
                                             seed=0, mesh=m)),
            ("cfg5f", lambda m=None: dk.render_value_and_grad(
                template.to(mesh.device), camera, target, spp=CFG5["spp"],
                max_bounces=CFG5["max_bounces"],
                background=kw["background"], seed=0,
                surr_rows={"sph": None, "quad": ()}, mesh=m))):
        got = ([], [])
        fn(None)
        fn(mesh)
        for i in range(MESH_TIME_REPS):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                for d in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(d)
                t0 = time.perf_counter()
                fn((None, mesh)[j])
                for d in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(d)
                got[j].append(time.perf_counter() - t0)
        line, out[label] = _pair_line(
            f"multi-card {label}, one card against {mesh.size} cards", *got)
        log(f"[mesh] {line}")
    return out


# The BVH route (phase 19, ops/bvh.py): config 4b (bench.py's 8 000
# spheres at 400x225, mb=50) through Renderer(accelerator="bvh"), spp=16
# unless a render passes STEP_LIMIT_S (then the largest divisor of 16 that
# keeps it under), and cornell_box (the coplanar-tie scene) at
# BVH_CORNELL. The walk is plain PyTorch, launched op by op, so
# images are held to the kernels' images by the modular tracer's
# tolerances, measured on the H100: cfg4b against K2 7.2 % of pixels over
# PARITY_ATOL, image mean 2.5e-4 apart; Cornell against K1 15.2 %, 4.8e-3
# (the light/ceiling z-fight over 20 bounces; the dense modular route
# differs from K1 the same way), and against the dense modular route 3
# pixels of 360 000.
BVH_CFG4B = dict(width=400, height=225, n=8000, spp=16, max_bounces=50)
BVH_CORNELL = dict(width=600, height=600, spp=16, max_bounces=20)
BVH_K2_MAX_FRAC = 0.10
BVH_K1_MAX_FRAC = 0.20
BVH_DENSE_MAX_FRAC = 1e-3
# traverse against K3's global route on the same rays: winners may differ
# only at near-tangent contacts (the two leaf formulas round apart)
BVH_K3_MAX_FLIP = 0.01
# traverse on the card against the CPU: the rays of config 4b's camera at
# 64x48 spp=4 (primary, then one bounce's scattered rays)
BVH_RAYS = dict(width=64, height=48, spp=4)
BVH_TIME_REPS = 3
# the walks of the render profiled for the device's busy share: a profiled
# whole render would record some 2.3 million kernels, whose processing
# takes minutes
BVH_PROFILED_WALKS = (10, 30, 60)


def _image_check(np, label, got, want, max_frac, mean_rtol):
    """Share of pixels over PARITY_ATOL and the image means' relative
    gap; raises beyond (max_frac, mean_rtol)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    d = np.abs(got - want).max(-1)
    frac = float((d > PARITY_ATOL).mean())
    mean_rel = float(abs(got.mean() - want.mean()) / want.mean())
    log(f"[bvh] {label}: max|d| {d.max():.3g}, pixels > {PARITY_ATOL:g}: "
        f"{frac:.4%} (allowed {max_frac:.2%}), mean rel {mean_rel:.3g} "
        f"(allowed {mean_rtol:g})")
    if not np.isfinite(got).all() or frac > max_frac or mean_rel > mean_rtol:
        raise RuntimeError(f"{label}: the BVH image disagrees")
    return dict(max_abs=float(d.max()), frac=frac, mean_rel=mean_rel)


def _walk_counts(bvh_ops):
    c = bvh_ops.walk_counts
    return dict(walks=c.walks, iterations=c.iterations,
                max_iterations=c.max_iterations, ray_steps=c.ray_steps,
                iterations_mean=c.iterations / max(c.walks, 1))


def bvh_phase(torch, np, presets, ik, mk, mkp, dk, dkp, bvh_ops, trace_ops,
              generate_rays, Renderer, card):
    """The BVH accelerator on the card: the builder, the walk against the
    CPU and K3, config 4b and Cornell through Renderer(accelerator="bvh")
    with K1-K5 idle, the (2, 1) mesh and the CLI's --accelerator bvh
    --profile."""
    import dataclasses
    from tinyraytracer_tpu_torch.__main__ import main as cli_main
    from tinyraytracer_tpu_torch.ops import intersect as isect
    from tinyraytracer_tpu_torch.ops.scatter import scatter
    res = {}
    c4 = BVH_CFG4B
    world, camera, kw = presets.random_spheres(width=c4["width"],
                                               height=c4["height"], n=c4["n"])
    scene = world.build()
    build_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        host_bvh = bvh_ops.build_bvh(scene)
        build_s.append(time.perf_counter() - t0)
    a = host_bvh.numpy()
    lp, hl, ml = a["leaf_prim"], a["hit_link"], a["miss_link"]
    m = lp.shape[0]
    inner = lp < 0
    left = (np.arange(m) + 1)[inner]
    ok = (m == 2 * int((lp >= 0).sum()) - 1
          and (hl > np.arange(m)).all() and (ml > np.arange(m)).all()
          and (hl <= m).all() and (ml <= m).all()
          and (a["node_min"] <= a["node_max"]).all()
          and (a["node_min"][inner] <= a["node_min"][left] + 1e-6).all()
          and (a["node_max"][inner] >= a["node_max"][left] - 1e-6).all())
    med, lo, hi = _spread(build_s)
    res["build"] = dict(primitives=int((lp >= 0).sum()), nodes=m,
                        build_s=build_s, median_s=med)
    log(f"[bvh] build_bvh at {int((lp >= 0).sum())} primitives ({m} nodes) "
        f"on the host: {med * 1e3:.1f} ms [{lo * 1e3:.1f}, {hi * 1e3:.1f}] "
        f"(median [min, max] of 3); layout well-formed: {ok}")
    if not ok:
        raise RuntimeError("the BVH's threaded layout is malformed")

    # the walk on the card against the CPU, and against K3's global route
    rw, rh, rspp = BVH_RAYS["width"], BVH_RAYS["height"], BVH_RAYS["spp"]
    cam_r = presets.random_spheres(width=rw, height=rh, n=c4["n"])[1]
    pid, sid = trace_ops.round_ids(torch.arange(rw * rh), rspp, 0)
    o, d = generate_rays(cam_r, pid, sid, 0)
    t, j = bvh_ops.traverse(scene, host_bvh, o, d)
    rec = isect.select_to_record(scene, o, d,
                                 torch.where(j >= 0, t, isect.MISS_T), j)
    new_d, _, absorbed = scatter(d, rec, 0, pid, sid, 0)
    keep = rec.hit & ~absorbed
    cw, cc, _ = presets.cornell_box(width=rw, height=rh)
    cscene = cw.build()
    co, cd = generate_rays(cc, torch.arange(rw * rh), 0, 0)
    waves = {"cfg4b primary": (scene, host_bvh, o, d),
             "cfg4b scattered": (scene, host_bvh, rec.point[keep].contiguous(),
                                 new_d[keep].contiguous()),
             "Cornell primary (light/ceiling tie)":
                 (cscene, bvh_ops.build_bvh(cscene), co, cd)}
    res["walk"] = {}
    for label, (sc, bv, oo, dd) in waves.items():
        t_c, j_c = bvh_ops.traverse(sc, bv, oo, dd)
        t_g, j_g = bvh_ops.traverse(sc.to("cuda"), bv.to("cuda"), oo.cuda(),
                                    dd.cuda())
        same = (torch.equal(t_g.cpu(), t_c) and torch.equal(j_g.cpu(), j_c))
        cs = dataclasses.replace(ik.compact_rows(sc, "cuda"), bank=None)
        _, j_k = ik.closest_hit(cs, oo.cuda(), dd.cuda())
        j_k = j_k.long().cpu()
        hit = j_c >= 0
        masks = torch.equal(hit, j_k >= 0)
        flip = float((hit & (j_c != j_k)).sum()) / max(int(hit.sum()), 1)
        res["walk"][label] = dict(rays=oo.shape[0], card_equals_cpu=same,
                                  hit_masks_equal=masks, k3_flip=flip)
        log(f"[bvh] traverse, {label} rays ({oo.shape[0]}): card == CPU "
            f"bit for bit on (t, j): {same}; against K3's global route: "
            f"hit masks equal {masks}, winners differ on {flip:.4%} of hits "
            f"(allowed {BVH_K3_MAX_FLIP:.0%})")
        if not same or not masks or flip > BVH_K3_MAX_FLIP:
            raise RuntimeError(f"traverse on {label} rays disagrees")

    # one walk of config 4b's primary rays at full size
    o4, d4 = generate_rays(camera, torch.arange(c4["width"] * c4["height"]),
                           0, 0)
    o4, d4 = o4.cuda(), d4.cuda()
    gscene, gbvh = scene.to("cuda"), host_bvh.to("cuda")
    bvh_ops.traverse(gscene, gbvh, o4, d4)              # warm-up
    walk_ms = []
    for _ in range(BVH_TIME_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bvh_ops.traverse(gscene, gbvh, o4, d4)
        torch.cuda.synchronize()
        walk_ms.append((time.perf_counter() - t0) * 1e3)
    wmed, wlo, whi = _spread(walk_ms)
    res["primary_walk"] = dict(rays=o4.shape[0], ms=walk_ms, median_ms=wmed)
    log(f"[bvh] one walk of cfg4b's {o4.shape[0]} primary rays: "
        f"{wmed:.2f} ms [{wlo:.2f}, {whi:.2f}] (median [min, max] of "
        f"{BVH_TIME_REPS})")

    # config 4b through the BVH route, alternating with K2
    counters = lambda: _counters(ik, mk, mkp, dk, dkp)   # noqa: E731
    spp = c4["spp"]

    def bvh_renderer(n):
        return Renderer(n, max_bounces=c4["max_bounces"],
                        background_color=kw["background"], seed=0,
                        accelerator="bvh", device="cuda")

    # warm-up, with a few walks profiled and every walk's wall time summed
    walk_wall = [0.0]
    profiled = []
    real = bvh_ops.traverse
    from torch.profiler import ProfilerActivity, profile

    def watched(*args, **kwargs):
        k = watched.calls
        watched.calls += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k not in BVH_PROFILED_WALKS:
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            walk_wall[0] += time.perf_counter() - t0
            return out
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        dev_ms = sum(e.self_device_time_total
                     for e in prof.key_averages()) / 1e3
        profiled.append(dict(walk=k, wall_ms=wall * 1e3, device_ms=dev_ms,
                             busy=dev_ms / (wall * 1e3),
                             held_s=time.perf_counter() - t0))
        return out

    watched.calls = 0
    bvh_ops.traverse = watched
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bvh_renderer(spp).render_array(camera, scene)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        bvh_ops.traverse = real
    # the unprofiled walks' share of the render without the profiled ones
    walk_share = walk_wall[0] / (warm_s - sum(p["held_s"] for p in profiled))
    if warm_s > STEP_LIMIT_S:
        spp = max(s for s in range(1, spp + 1) if spp % s == 0
                  and warm_s * s / c4["spp"] < STEP_LIMIT_S)
        log(f"[bvh] cfg4b warm-up {warm_s:.1f} s passes {STEP_LIMIT_S:.0f} s:"
            f" spp cut to {spp}")
    k2 = Renderer(spp, max_bounces=c4["max_bounces"],
                  background_color=kw["background"], seed=0, device="cuda")
    times = {"bvh": [], "k2": []}
    img = img_k2 = None
    for _ in range(BVH_TIME_REPS):
        _zero_counters(ik, mk, mkp, dk, dkp)
        bvh_ops.walk_counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = bvh_renderer(spp).render_array(camera, scene)
        torch.cuda.synchronize()
        times["bvh"].append(time.perf_counter() - t0)
        idle = counters()
        walks = _walk_counts(bvh_ops)
        if any(idle.values()):
            raise RuntimeError(f"a kernel ran on the BVH route: {idle}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_k2 = k2.render_array(camera, scene)
        torch.cuda.synchronize()
        times["k2"].append(time.perf_counter() - t0)
    if tuple(img.shape) != (c4["height"], c4["width"], 3) or \
            not bool(torch.isfinite(img).all()) or bool((img < 0).any()):
        raise RuntimeError("cfg4b BVH image not finite / negative")
    mb_, lo_b, hi_b = _spread(times["bvh"])
    mk_, lo_k, hi_k = _spread(times["k2"])
    rays = c4["width"] * c4["height"] * spp
    busy = [p["busy"] for p in profiled]
    res["cfg4b"] = dict(
        spp=spp, max_bounces=c4["max_bounces"], render_s=times["bvh"],
        median_s=mb_, mrays_s=rays / mb_ / 1e6, k2_render_s=times["k2"],
        k2_median_s=mk_, warmup_s=warm_s, walks=walks,
        iterations_per_bounce_mean=walks["iterations_mean"],
        iterations_per_bounce_max=walks["max_iterations"],
        ray_steps_per_ray_walk=walks["ray_steps"] / (rays * c4[
            "max_bounces"]),
        profiled_walks=profiled, walk_share=walk_share, kernels_idle=True,
        vs_k2=_image_check(np, "cfg4b BVH image vs K2", img, img_k2,
                           BVH_K2_MAX_FRAC, PARITY_MEAN_RTOL))
    log(f"[bvh] cfg4b {c4['width']}x{c4['height']} spp={spp} "
        f"mb={c4['max_bounces']}, Renderer(accelerator=\"bvh\").render_array"
        f" {mb_ * 1e3:.1f} ms [{lo_b * 1e3:.1f}, {hi_b * 1e3:.1f}], "
        f"{rays / mb_ / 1e6:.3f} camera Mrays/s; K2 {mk_ * 1e3:.2f} ms "
        f"[{lo_k * 1e3:.2f}, {hi_k * 1e3:.2f}] (median [min, max] of "
        f"{BVH_TIME_REPS}, alternating) on {card}; K1-K5 launches during "
        f"the BVH renders: 0")
    groups = walks["walks"] // c4["max_bounces"]
    log(f"[bvh] cfg4b walks: {walks['walks']} ({groups} lockstep groups x "
        f"{c4['max_bounces']} bounces), walk iterations per bounce mean "
        f"{walks['iterations_mean']:.1f}, max {walks['max_iterations']}; "
        f"{res['cfg4b']['ray_steps_per_ray_walk']:.1f} node steps per ray "
        f"and bounce; the walks take "
        f"{walk_share:.1%} of the render's wall time (warm-up)")
    log(f"[bvh] cfg4b device busy under torch.profiler, walks "
        f"{[p['walk'] for p in profiled]}: "
        + ", ".join(f"{p['busy']:.1%} ({p['device_ms']:.1f} of "
                    f"{p['wall_ms']:.1f} ms)" for p in profiled))
    if len(profiled) != len(BVH_PROFILED_WALKS) or not all(
            b > 0 for b in busy):
        raise RuntimeError("the profiler saw no device time in the walks")

    # Cornell, the coplanar-tie scene: against K1 and the dense route
    cb = BVH_CORNELL
    cw, cc, ckw = presets.cornell_box(width=cb["width"], height=cb["height"])
    cscene = cw.build()
    args = dict(max_bounces=cb["max_bounces"],
                background_color=ckw["background"], seed=0, device="cuda")
    _zero_counters(ik, mk, mkp, dk, dkp)
    bvh_ops.walk_counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cimg = Renderer(cb["spp"], accelerator="bvh", **args).render_array(
        cc, cscene)
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    idle = counters()
    cwalks = _walk_counts(bvh_ops)
    if any(idle.values()):
        raise RuntimeError(f"a kernel ran on the BVH route: {idle}")
    ck1 = Renderer(cb["spp"], **args).render_array(cc, cscene)
    cdense = Renderer(cb["spp"], accelerator="none", **args).render_array(
        cc, cscene)
    crays = cb["width"] * cb["height"] * cb["spp"]
    res["cornell"] = dict(
        spp=cb["spp"], render_s=c_s, mrays_s=crays / c_s / 1e6,
        walks=cwalks,
        vs_k1=_image_check(np, "Cornell BVH image vs K1", cimg, ck1,
                           BVH_K1_MAX_FRAC, ZFIGHT_MEAN_RTOL),
        vs_dense=_image_check(np, "Cornell BVH image vs the dense route",
                              cimg, cdense, BVH_DENSE_MAX_FRAC,
                              PARITY_MEAN_RTOL))
    log(f"[bvh] cornell_box {cb['width']}x{cb['height']} spp={cb['spp']} "
        f"mb={cb['max_bounces']}: {c_s * 1e3:.1f} ms (one run), "
        f"{crays / c_s / 1e6:.3f} camera Mrays/s; walk iterations per "
        f"bounce mean {cwalks['iterations_mean']:.1f}, max "
        f"{cwalks['max_iterations']}; K1-K5 idle")

    # the (2, 1) mesh of the one card, bit for bit with one device
    mesh_r = Renderer(spp, max_bounces=c4["max_bounces"],
                      background_color=kw["background"], seed=0,
                      accelerator="bvh", devices=["cuda:0", "cuda:0"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mimg = mesh_r.render_array(camera, scene)
    torch.cuda.synchronize()
    m_s = time.perf_counter() - t0
    equal = torch.equal(mimg, img)
    res["mesh"] = dict(shape=dict(mesh_r.mesh.shape), render_s=m_s,
                       equal=equal)
    log(f"[bvh] cfg4b over a {mesh_r.mesh.shape} mesh of the card: "
        f"{m_s * 1e3:.1f} ms, bit for bit with one device: {equal}")
    if not equal:
        raise RuntimeError("the BVH route over a mesh differs")

    # the CLI: --accelerator bvh --profile DIR on the card
    out_dir = os.path.join(ROOT, "output", "chip_smoke_bvh_profile")
    png = os.path.join(ROOT, "output", "chip_smoke_cli_bvh.png")
    for f in (glob.glob(os.path.join(out_dir, "*.json"))
              if os.path.isdir(out_dir) else []):
        os.remove(f)
    rc = cli_main(["--preset", "cornell_box", "--width", "64", "--height",
                   "48", "--spp", "4", "--max-bounces", "8", "--device",
                   "cuda", "--accelerator", "bvh", "--profile", out_dir,
                   "--out", png])
    traces = glob.glob(os.path.join(out_dir, "*.pt.trace.json"))
    n_kernels = 0
    for path in traces:
        with open(path) as f:
            n_kernels += sum(1 for e in json.load(f)["traceEvents"]
                             if e.get("cat") == "kernel")
    res["cli"] = dict(rc=rc, traces=len(traces), kernel_events=n_kernels,
                      png=os.path.exists(png))
    log(f"[bvh] CLI --accelerator bvh --profile: rc {rc}, PNG "
        f"{os.path.exists(png)}, {len(traces)} trace(s) with {n_kernels} "
        f"CUDA kernel events")
    if rc != 0 or not os.path.exists(png) or len(traces) != 1 \
            or n_kernels == 0:
        raise RuntimeError("the CLI's BVH profile run failed")
    return res


PHASES = ("forward", "k3", "train", "cfg5", "modular", "k5", "fused",
          "cfg5f", "k4", "cfg4f", "mesh", "bvh")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phase groups to run: forward "
                    "(phases 3-7), k3 (8), train (9), cfg5 (10), modular "
                    "(11), k5 (12), fused (13), cfg5f (14), k4 (15), "
                    "cfg4f (16-17), mesh (18), bvh (19); the result lines "
                    "need the default set")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    import numpy as np
    import torch

    card = env_phase(torch)
    sys.path.insert(0, ROOT)
    from tinyraytracer_tpu_torch import Image, Renderer, _build
    from tinyraytracer_tpu_torch.diff import inverse, optim
    from tinyraytracer_tpu_torch.models import presets
    from tinyraytracer_tpu_torch.ops import diffkernel as dk
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp
    from tinyraytracer_tpu_torch.models.camera import generate_rays
    from tinyraytracer_tpu_torch.ops import intersect_kernel as ik
    from tinyraytracer_tpu_torch.ops import megakernel as mk
    from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
    from tinyraytracer_tpu_torch.ops import bvh as bvh_ops
    from tinyraytracer_tpu_torch.ops import trace as trace_ops
    from tinyraytracer_tpu_torch.parallel import sharded

    t_start = time.perf_counter()
    build_phase(_build)
    sass = sass_phase(_build)
    results = {}
    if "forward" in only:
        worst = parity_phase(torch, np, presets, mk, mkp, _build.load())
        launches, results = main_path_phase(torch, np, presets, mk, mkp,
                                            Renderer, card)
        breakdown_phase(torch, np, presets, mk, Image, Renderer, card,
                        results)
        for k, v in kernel_vs_twin_phase(torch, np, presets, mk, mkp, card,
                                         results, _build.load()).items():
            worst[k] = max(worst[k], v)
        results["sass"] = sass
        api_phase(torch, np, presets, Renderer)
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
    if "k5" in only:
        results["k5"] = k5_phase(torch, np, presets, dkp, card)
    if "fused" in only:
        fused_phase(torch, presets, ik, dk, dkp, inverse, Renderer, card)
    if "cfg5f" in only:
        results["cfg5f"] = cfg5_fused_phase(torch, presets, dk, dkp, inverse,
                                            Renderer, card)
    if "k4" in only:
        results["k4"] = k4_phase(torch, np, presets, dk, dkp, card)
    if "cfg4f" in only:
        results["cfg4f"] = cfg4f_phase(torch, presets, ik, mk, mkp, dk, dkp,
                                       inverse, card)
        results["route"] = routing_phase(torch, presets, ik, mk, mkp, dk,
                                         dkp, inverse, optim, card)
    if "mesh" in only:
        mesh_twin_checks(torch, presets, mk, mkp, sharded, _build.load())
        results["mesh"] = mesh_phase(torch, presets, ik, mk, mkp, dk, dkp,
                                     inverse, sharded, Renderer, card)
    if "bvh" in only:
        results["bvh"] = bvh_phase(torch, np, presets, ik, mk, mkp, dk, dkp,
                                   bvh_ops, trace_ops, generate_rays,
                                   Renderer, card)
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    with open(os.path.join(ROOT, "output", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, results=results), f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the "
        "environment check")
    if set(only) != set(PHASES):
        return 0

    mesh = results["mesh"]["launches"]

    def entry(kid, name, source, replaces, cfg):
        res = results[cfg]
        return {
            "name": name, "route": "cuda",
            "source": f"tinyraytracer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[kid] + mesh[kid],
            "max_abs_err": worst[kid], "ms": res["kernel_ms"],
            "plain_ms": res["twin_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            "config": cfg, "plain_shape": res["twin_shape"],
            "ms_at_plain_shape": res["kernel_ms_at_twin_shape"],
        }

    k3, k4, k5 = results["k3"], results["k4"], results["k5"]
    print(json.dumps({"kernels": [
        entry("K1", "megakernel_packed", "megakernel_packed.cu",
              "tinyraytracer_tpu/ops/megakernel_packed.py:125", "cfg3"),
        entry("K2", "megakernel_flat", "megakernel.cu",
              "tinyraytracer_tpu/ops/megakernel.py:489", "cfg4"),
        {"name": "closest_hit", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/closest_hit.cu",
         "replaces": "tinyraytracer_tpu/ops/intersect_pallas.py:166",
         "launches": results["cfg5"]["launches"]["K3"] + mesh["K3"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None, "config": "cfg5",
         "plain_shape": f"{k3['rays']} rays",
         "ms_at_plain_shape": k3["ms"],
         "ms_launch_weighted": k3["ms_launch_weighted"]},
        {"name": "diffkernel_packed", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/diffkernel_packed.cu",
         "replaces": "tinyraytracer_tpu/ops/diffkernel_packed.py:240",
         "launches": results["cfg5f"]["launches"]["K5"] + mesh["K5"],
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": None, "config": "cfg5f",
         "plain_shape": k5["plain_shape"],
         "ms_at_plain_shape": k5["ms_at_plain_shape"]},
        {"name": "diffkernel", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/diffkernel.cu",
         "replaces": "tinyraytracer_tpu/ops/diffkernel.py:357",
         "launches": results["cfg4f"]["cfg4class"]["launches"]["K4"]
         + mesh["K4"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "config": "cfg4class", "plain_shape": k4["plain_shape"],
         "ms_at_plain_shape": k4["ms_at_plain_shape"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
