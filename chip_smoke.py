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
   K2 with participating media (its HAS_MED instantiations) on one
   scene of 60 spheres, two quads and two media: the BVH walk, the dense
   search and the twin bit for bit.
4. Main path: `Renderer(...).render(camera, world)` for BASELINE configs
   1-4 and 4b at full size, one warm-up then one timed render each; the
   PNG goes to output/ through the native encoder (native/, built at
   first use) and must decode back to the image's pixels. Checks finite,
   non-negative radiance and the
   Cornell box's orientation. The launch counters are zeroed before this
   phase; K1's must rise on configs 1-3 only, K2's on 4 and 4b only, the
   gamma's (G1, csrc/gamma.cu) by one a render, and each image must equal
   `tonemap.gamma_reference` of the warm-up's framebuffer bit for bit.
   Then the benchmark's media scene (perfbench/configs/rtnw_final.json:
   Ray Tracing: The Next Week's final scene, 2 401 quads, 1 006 spheres,
   2 media) at its size, 800x800 with 40 bounces, at spp=2: one render
   through `Renderer.render`, which must be one HAS_MED launch on the BVH
   walk and one G1 launch (the counters zeroed just before), its image
   equal to `gamma_reference` of its framebuffer, and a band of 64 image
   rows through the ball that holds a medium held to K2's twin bit for
   bit.
5. Where the time goes: the steps of one render (lowering, copies,
   kernel, the card's gamma, readback) timed one by one beside whole
   renders. Then G1 against its twin at cfg3's and cfg4's framebuffers:
   bit for bit, its device time, its bound, the twin's time, and torch's
   float64 expression's time and bits.
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
10. Config 5 at full size (cornell_spheres 600x600 mb=20, spp cut from
   200 to CFG5_SPP, a cut of depth): where a step at spp=4 goes, then 1
   warm-up and 2 timed steps, each ended by a host read of the loss;
   fwd+bwd camera Mrays/s, peak memory, K3 launches and share of the
   step. K3's counter is zeroed before and read after.
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
   without trainable_rows, runs on K4; examples/torch_manysphere_fit.py
   for 20 steps (n=128 + lamp, 128x128 spp=16 mb=4, the big diffuse
   sphere's row): K4 once a step, K5 never, finite losses, the untrained
   rows' drift exactly 0.

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
   spheres on the host by the C++ builder (native/) and by numpy
   (use_native=False), the arrays bit for bit, both timed, the threaded
   layout checked; traverse on the card
   against the CPU, bit for bit on (t, j), on config 4b's primary rays
   and one bounce's scattered rays (64x48 spp=4) and on Cornell's
   primary rays (the light/ceiling tie), and against K3's global route
   on the same rays (hit masks equal, winners within BVH_K3_MAX_FLIP);
   one walk of config 4b's full-size primary rays timed (median and
   range of BVH_TIME_REPS); config 4b through Renderer(accelerator="bvh") at
   400x225 spp=16 mb=50 (cut below STEP_LIMIT_S if need be): a warm-up
   with three walks profiled for the device's busy share, then
   BVH_RENDER_REPS renders alternating with K2's (the mean and each
   reading, camera Mrays/s, walk iterations per bounce), every kernel
   counter zeroed before each BVH render and read after it (all must
   stay 0), the image against K2's; cornell_box at 600x600 spp=16
   mb=20 against K1 and the dense modular route; config 4b over a (2, 1)
   mesh of the card, bit for bit with one device; the CLI's
   --accelerator bvh --profile DIR on the card (a PNG that decodes to
   the image's size and a Chrome trace with CUDA kernel events).

20. The last public names and the examples. With every counter zeroed,
   one `MegakernelRenderer.render_burst` of config 1 (K1, seeds 0-7) and
   of config 4b (K2, culled, 2 seeds): K1 must rise by exactly 8 and K2
   by 2, and every frame must equal its single `render` bit for bit;
   then config 1 per image in a burst of 8 against single synchronised
   renders, in alternating pairs (median, [min, max]). `intersect_scene`
   on cornell_box's primary rays (64x48), the card against the CPU.
   Outside the counted runs, each fused kernel against the twin at the
   examples' own inputs (image bit for bit, tables within TABLE_RTOL,
   two launches bit for bit): K5 at the inverse example's first step
   (spp=32) and its refine phase's first (spp=128), K4 at the many-sphere
   example's first step (its one surrogate row).
   examples/torch_inverse_render.py at its defaults (96x96 spp=32, the
   last 20 % at 128, mb=6, 400 steps): K5 once a step, K4 never, finite
   losses, max center error below INVERSE_MAX_ERROR; then a 60-step run
   with a checkpoint, resumed at step 50 by a second run that must equal
   it bit for bit. examples/torch_manysphere_fit.py at its defaults (128
   spheres + lamp, 128x128 spp=16 mb=4, 80 steps): K4 once a step, K5
   never, the untrained rows' drift exactly 0, the position error below
   MANYSPHERE_MAX_ERROR. Each gate asks for half the recovery of the
   example's first full run on the card.

21. bench_torch.py, the port of bench.py. First, outside the counted
   run, K5 with every field trainable (all 18 quads' boundary
   surrogates) against its twin at the first input of the bench's
   cornell_box 300x300 mb=8 step (spp cut from 16 to 2) and of its
   all-fields north star, 600x600 mb=20 (spp cut from 200 to 2): the
   image bit for bit, the tables within TABLE_RTOL, two launches bit for
   bit; each step's route and accumulator width, and the registers,
   spills and save slots of its launch at its own spp. Then, with every
   counter zeroed, bench_torch.main on the card: it prints its JSON
   line, which must hold every key with no `_error`, positive rates and
   shares in (0, 1]; each kernel must have launched BENCH_LAUNCHES
   times. The config-5 shaped step is printed beside phase 14's; the
   line carries `pct_sol_cornell_vs_measured_mix`.

22. The measured-mix ceiling (csrc/microbench.cu, the port of
   scripts/probe_vpu_microbench.py's kernel): in phase 2's SASS, each
   mix's loop body holds at least the operations the mix counts; each
   mix (fma, select, sphere, transcendental, quad) against its twin at
   one full wave of threads (select, sphere and quad bit for bit, fma
   within 1 ulp, transcendental within microbench.TRANSC_ULP), two
   launches bit for bit, then timed beside the twin at the probe's 2 000
   iterations; then scripts/torch_probe_vpu_microbench.py with the
   counter zeroed (5 launches a mix): the five rates with the SM clock,
   and utils/sol.py's three rates within SOL_RTOL of the sphere, quad
   and transcendental mixes'; each mix's issue bound (its loop's SASS
   instructions off the slow-path calls, 128 lanes a SM and clock).

23. The layout probes P1-P4 (csrc/probe_*.cu, the ports of
   scripts/probe_sublanes.py, probe_packgrad.py, probe_packgrad2.py and
   probe_seglayout.py; wrappers and twins in utils/probes.py): in phase
   2's SASS, some loop of each kernel holds the operations it counts an
   element and bounce; each of the seven bodies at each of its probe's
   shapes, on the probe's inputs and on seeded variants (PROBE_SEEDS;
   for P4 probes.P4_SEEDS: P4_SEED_SHORT, P4_SEED_LIVE, whose rays never
   NaN, and the special-value tables P4_SPECIAL), against its twin bit
   for bit (P2 A also within PROBE_TABLE_RTOL of the largest entry of
   the twin's order in turns), two launches and GRID = 1 against the
   probe's GRID bit for bit, the kernel timed at the probe's GRID beside
   its FP32 and issue bounds (P2 A: and its shared-traffic bound) and
   the twin at one grid step; P2's and P4's registers, spills, blocks a
   SM and slow-path CALL sites; P4's segments on a NaN state a ray, its
   special discriminants, and its time on the probe's inputs over its
   time off the NaN path (P4_SEED_LIVE); then the four
   scripts/torch_probe_*.py with the counters zeroed, each launching its
   kernel PROBE_LAUNCHES times and printing the probe's lines.

`--only` runs some phase groups: forward (3-7), k3 (8), train (9), cfg5
(10), modular (11), k5 (12), fused (13), cfg5f (14), k4 (15), cfg4f
(16-17), mesh (18), bvh (19), examples (20), bench (21), sol (22),
probes (23). Each group's time is printed after it ("[lap]").

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
sys.path.insert(0, ROOT)

# The roofline model (FP32 operations per unit of work, the card's peaks,
# the kernels' bounds) is defined once, in the package.
from tinyraytracer_tpu_torch.utils import profiling, sol  # noqa: E402

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
# Phase 10's depth: config 5's modular step runs at this spp, cut from
# 200 to keep the script's time: on the H100 a step at spp=50 takes 30 s,
# at spp=100 61-65 s, and the phase 120 s at 50 against 215 s at 100.
CFG5_SPP = 50
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
# K2's HAS_MED instantiations (a scene with media): the dense and culled
# searches add the media's row walk; the BVH walk stays one loop.
MED_DENSE_BACK_EDGES = 9
MED_BVH_BACK_EDGES = 5
# Back edges of each kernel that are not its vote-latched loops: walks
# over sphere, quad, light and surrogate rows, K2's BVH walk (one loop,
# five back edges as built), the table loads and the fixed-order sums,
# read off the SASS of the shipped build. NEE adds the
# shadow ray's and the light's walks, the silhouette its row walks. A
# sample or bounce loop rebuilt on a thread's own counters would add one.
PLAIN_BACK_EDGES = {"flat_kernel": 8, "flat_kernel bvh": 5,
                    "flat_kernel med": MED_DENSE_BACK_EDGES,
                    "flat_kernel bvh med": MED_BVH_BACK_EDGES,
                    "packed_kernel": 7, "K5": 24, "K4": 22, "K5 image": 8,
                    "K4 image": 8}
PLAIN_BACK_EDGES_NEE = {"K5": 6, "K4": 6, "K5 image": 2, "K4 image": 2}
PLAIN_BACK_EDGES_SIL = {"K5": 2, "K4": 2}
# The K5 lane model at cfg5f reads every K5_LANE_EVERY-th warp of the
# image (the twin's phase 1 at spp=200).
K5_LANE_EVERY = 16
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


# Each wrapper's launches at its last zero_launches (the host counters
# `launches.<wrapper>` only rise).
_LAUNCH_BASE: dict = {}


def n_launches(fn) -> int:
    """Launches of the kernel wrapper `fn` since zero_launches(fn) (its host
    counter, utils/profiling.py); `fn` may be the counter's name after
    `launches.` ("gamma": tonemap.gamma_cuda's)."""
    name = fn if isinstance(fn, str) else fn.__name__
    return profiling.counter(f"launches.{name}") - _LAUNCH_BASE.get(name, 0)


def zero_launches(*fns) -> None:
    for fn in fns:
        name = fn if isinstance(fn, str) else fn.__name__
        _LAUNCH_BASE[name] = profiling.counter(f"launches.{name}")


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
            if kind == "flat_kernel" and "BvhScene" in name:
                kind = "flat_kernel bvh"     # the BVH walk: its one loop
            elif kind == "flat_kernel" and "BvhMedScene" in name:
                kind = "flat_kernel bvh med"
            elif kind == "flat_kernel" and "FlatMedScene" in name:
                kind = "flat_kernel med"
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


def read_png(np, path):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows all use filter
    0, as the port's encoders write it (native/ and encode_png); raises on
    a bad signature, chunk CRC, header or filter."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path}: not a PNG")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise RuntimeError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = head[0], head[1]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if head[2:] != (8, 2, 0, 0, 0) or rows[:, 0].any():
        raise RuntimeError(f"{path}: not 8-bit RGB with filter 0: {head}")
    return rows[:, 1:].reshape(h, w, 3)


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
        before = n_launches(mkp.render_packed)
        launch = lambda: mkp.render_packed(r.table, r.cam, **args)  # noqa
        got = launch()
        torch.cuda.synchronize()
        if n_launches(mkp.render_packed) != before + 1:
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
        before = n_launches(mk.render_flat)
        got = mk.render_flat(**args)
        torch.cuda.synchronize()
        if n_launches(mk.render_flat) != before + 1:
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
            w, h, spp, *k2_flags, int(r.bvh), 0)}
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


def media_phase(torch, mk):
    """K2's HAS_MED route on one scene with media (tests/torch_media_scenes
    "walk": 60 spheres of every kind, two quads, a medium in a glass
    ball's place and a fog around everything) at 64x48 spp=4, 12
    bounces: the walk (the route the rule takes), the dense search and
    the twin bit for bit, the walk's launch repeated bit for bit."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_media_scenes import port_world

    world, camera, bg = port_world("walk", 64, 48)
    scene = world.build()
    walk = mk.MegakernelRenderer(scene, camera, bg, "cuda")
    dense = mk.MegakernelRenderer(scene, camera, bg, "cuda", bvh=False)
    if not walk.bvh or walk.flat.n_med != 2:
        raise RuntimeError("the media scene does not take the walk")
    args = dict(spp=4, max_bounces=12, seed=3)
    got = walk.render(**args)
    torch.cuda.synchronize()
    _repeat_check(torch, "K2 media walk", lambda: walk.render(**args), got)
    twin = dense.flat_args(**args)
    twin.pop("aabbs")
    same = (torch.equal(got, dense.render(**args)),
            torch.equal(got, mk.render_flat_reference(**twin)))
    log(f"[parity] K2 media (2 media, {walk.n_sph} spheres, {walk.n_quad} "
        f"quads) 64x48 spp=4 mb=12: walk == dense {same[0]}, == twin "
        f"{same[1]}")
    if not all(same):
        raise RuntimeError("K2 with media differs from its twin")


def main_path_phase(torch, np, presets, mk, mkp, Renderer, card):
    """Configs 1-4b through `Renderer.render`: K1 or K2 twice (warm-up and
    render) and G1 once a config, the image equal to `gamma_reference` of
    the warm-up framebuffer bit for bit. Returns the launches and, a
    config, its results and the warm-up framebuffer."""
    from tinyraytracer_tpu_torch.ops import tonemap

    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    results, fbs = {}, {}
    zero_launches(mkp.render_packed, mk.render_flat, "gamma")
    for label, name, pkw, w, h, spp, mb, _ in CONFIGS:
        world, camera, kw = presets.PRESETS[name](width=w, height=h, **pkw)
        renderer = Renderer(spp, max_bounces=mb,
                            background_color=kw["background"], seed=0,
                            device="cuda")
        before = (n_launches(mkp.render_packed),
                  n_launches(mk.render_flat),
                  n_launches("gamma"))
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
        rose = (n_launches(mkp.render_packed) - before[0],
                n_launches(mk.render_flat) - before[1],
                n_launches("gamma") - before[2])
        want = (2, 0, 1) if label in ("cfg1", "cfg2", "cfg3") else (0, 2, 1)
        if rose != want:
            raise RuntimeError(f"{label}: launches (K1, K2, G1) rose by "
                               f"{rose}, expected {want}")
        data = image.data
        if not np.isfinite(data).all() or data.min() < 0:
            raise RuntimeError(f"{label}: image not finite / negative")
        # the same seed: the render's framebuffer is the warm-up's
        if not np.array_equal(data, tonemap.gamma_reference(
                fb.cpu().numpy())):
            raise RuntimeError(f"{label}: the card's gamma differs from "
                               "gamma_reference")
        fbs[label] = fb
        path = os.path.join(ROOT, "output", f"chip_smoke_{label}_{name}.png")
        image.save(path)        # the native encoder
        if not np.array_equal(read_png(np, path), image.to_u8()):
            raise RuntimeError(f"{label}: the PNG does not decode to the "
                               "image's pixels")
        mrays = w * h * spp / dt / 1e6
        results[label] = dict(preset=name, width=w, height=h, spp=spp,
                              max_bounces=mb, render_s=dt, mrays_s=mrays,
                              mean=float(fb.mean()), kernel="K1" if want[0]
                              else "K2")
        log(f"[main] {label} {name} {w}x{h} spp={spp} mb={mb}: "
            f"Renderer.render {dt * 1e3:.1f} ms, {mrays:.1f} camera Mrays/s "
            f"on {card}; launches (K1, K2, G1) +{rose}, the image == "
            f"gamma_reference; wrote "
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
    launches = {"K1": n_launches(mkp.render_packed),
                "K2": n_launches(mk.render_flat),
                "G1": n_launches("gamma")}
    log(f"[main] launches in the main path: {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError("the main path did not launch every kernel")
    return launches, results, fbs


# The media scene of the main path (phase 4): the benchmark's rtnw_final
# at its size and bounces, spp=2; the twin's band (image rows
# [RTNW_BAND[0], +RTNW_BAND[1])) crosses the glass ball that holds a
# medium.
RTNW = dict(config="perfbench/configs/rtnw_final.json", width=800,
            height=800, spp=2, max_bounces=40, seed=2_718_281_828)
RTNW_BAND = (560, 64)


def rtnw_main_path(torch, np, mk, Image, Renderer, card):
    """The benchmark's media scene through `Renderer.render` at 800x800,
    40 bounces: one HAS_MED launch on the BVH walk; a band of the image
    equal to the twin's bit for bit."""
    from perfbench.traffic import render_media
    from tinyraytracer_tpu_torch.ops import tonemap

    with open(os.path.join(ROOT, RTNW["config"])) as f:
        desc = render_media.description(json.load(f))
    w, h, spp, mb = (RTNW[k] for k in ("width", "height", "spp",
                                        "max_bounces"))
    world, camera = render_media.port_scene(desc, w, h)
    bg = tuple(desc["background"])
    renderer = Renderer(spp, max_bounces=mb, background_color=bg,
                        seed=RTNW["seed"], device="cuda")
    r = mk.MegakernelRenderer(world.build(), camera, bg, "cuda")
    if not r.bvh or r.n_med != 2:
        raise RuntimeError("rtnw_final: the media scene does not take the "
                           "walk")
    torch.cuda.synchronize()
    zero_launches(mk.render_flat, "gamma")
    t0 = time.perf_counter()
    image = renderer.render(camera, world)   # ends in a host copy
    dt = time.perf_counter() - t0
    rose = (n_launches(mk.render_flat), n_launches("gamma"))
    if rose != (1, 1):
        raise RuntimeError(f"rtnw_final: launches (K2, G1) rose by {rose}, "
                           "expected (1, 1)")
    fb = renderer.render_array(camera, world.build())
    if not np.array_equal(Image.from_linear(fb, gamma=tonemap.GAMMA).data,
                          image.data):
        raise RuntimeError("rtnw_final: a second render differs")
    if not np.array_equal(image.data, tonemap.gamma_reference(
            fb.cpu().numpy())):
        raise RuntimeError("rtnw_final: the card's gamma differs from "
                           "gamma_reference")
    if not bool(torch.isfinite(fb).all()) or bool((fb < 0).any()):
        raise RuntimeError("rtnw_final: radiance not finite / negative")
    row0, rows = RTNW_BAND
    twin = r.flat_args(spp=spp, max_bounces=mb, seed=RTNW["seed"],
                       pixels=(row0 * w, rows * w))
    twin.pop("aabbs")
    twin["pixel_chunk"] = max(1, TWIN_CANDIDATES // (r.n_sph + r.n_quad
                                                      + r.n_med))
    want, twin_ms = time_once(torch,
                              lambda: mk.render_flat_reference(**twin))
    got = fb.reshape(-1, 3)[row0 * w:(row0 + rows) * w]
    same = torch.equal(got, want)
    path = os.path.join(ROOT, "output", "chip_smoke_rtnw_final.png")
    image.save(path)
    mrays = w * h * spp / dt / 1e6
    log(f"[main] rtnw_final {w}x{h} spp={spp} mb={mb} ({r.n_sph} spheres, "
        f"{r.n_quad} quads, {r.n_med} media; walk): Renderer.render "
        f"{dt * 1e3:.1f} ms, {mrays:.1f} camera Mrays/s on {card}; "
        f"launches (K2, G1) +{rose}, the image == gamma_reference; image rows {row0}-{row0 + rows - 1} == twin "
        f"{same} (twin {twin_ms:.0f} ms); wrote "
        f"{os.path.relpath(path, ROOT)}")
    if not same:
        raise RuntimeError("rtnw_final: K2 differs from its twin")
    return dict(width=w, height=h, spp=spp, max_bounces=mb, render_s=dt,
                mrays_s=mrays, mean=float(fb.mean()), kernel="K2")


def breakdown_phase(torch, np, presets, mk, Renderer, card, results):
    """Where one `Renderer.render` call's time goes: the steps it takes
    called one by one, each ended by a synchronize (the gamma: the card's,
    `launches.gamma` checked, before the copy of its image). Median of 3
    (1 at cfg4), beside the median of as many whole `Renderer.render`
    calls on a world already built, as in the main path."""
    from tinyraytracer_tpu_torch.ops import tonemap

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
            before = profiling.counter("launches.gamma")
            t0 = clock()
            corrected = tonemap.gamma_cuda(fb)
            torch.cuda.synchronize()
            t["gamma"] = clock() - t0
            rose = profiling.counter("launches.gamma") - before
            if rose != 1:
                raise RuntimeError(f"{label}: the card's gamma launched "
                                   f"{rose} times, expected 1")
            t0 = clock()
            corrected.cpu().numpy()
            t["d2h"] = clock() - t0
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
            f"{med['h2d']:.2f}, kernel {med['kernel']:.2f}, gamma (card) "
            f"{med['gamma']:.2f}, D2H {med['d2h']:.2f} ms (World.build "
            f"uncached {med['build']:.2f} ms); device busy "
            f"{med['device_busy']:.1%}; on {card}")


# G1 (phase 5b): launches timed together; the main path's shapes it is
# timed and checked at.
GAMMA_REPS = 200
GAMMA_CONFIGS = ("cfg3", "cfg4")


def gamma_phase(torch, np, lib, card, fbs):
    """G1 (csrc/gamma.cu) against its twin on the main path's framebuffers
    (cfg3 600x600, cfg4 1200x675): the output bit for bit with
    `gamma_reference`; the kernel's device time (CUDA events around
    GAMMA_REPS launches of the C entry into one output), the host cost of
    one `gamma_cuda` call (what `tinyrt.render.gamma` wraps on the card),
    the twin's time on the host, and torch's float64 expression, its time
    (`library_ms`) and whether it gives the same bits; the bound: 8 bytes
    an element (4 read, 4 written) at HBM_BYTES_S."""
    from tinyraytracer_tpu_torch.ops import tonemap

    rows = {}
    inv = float(tonemap.inv_gamma(tonemap.GAMMA))
    stream = torch.cuda.current_stream().cuda_stream
    for label in GAMMA_CONFIGS:
        fb = fbs[label]
        host = fb.cpu().numpy()
        t0 = time.perf_counter()
        want = tonemap.gamma_reference(host)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = tonemap.gamma_cuda(fb).cpu().numpy()
        err = float(np.abs(got.astype(np.float64) - want).max())
        if not np.array_equal(got, want):
            raise RuntimeError(f"{label}: G1 differs from gamma_reference "
                               f"(max |d| {err:.3g})")
        out = torch.empty_like(fb)

        def launch():
            if lib.tinyrt_gamma(fb.data_ptr(), out.data_ptr(), fb.numel(),
                                inv, stream):
                raise RuntimeError(f"{label}: the gamma launch failed")

        ms = time_kernel(torch, launch, GAMMA_REPS)
        torch.cuda.synchronize()
        host_cost = []
        for _ in range(20):
            t0 = time.perf_counter()
            tonemap.gamma_cuda(fb)
            host_cost.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()

        def library():
            return torch.clamp_min(fb, 0).double().pow(inv).float()

        library_same = torch.equal(library(), out)
        library_ms = time_kernel(torch, library, GAMMA_REPS)
        bound_ms = 8 * fb.numel() / sol.HBM_BYTES_S * 1e3
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           max_abs_err=err, library_ms=library_ms,
                           library_same_bits=library_same,
                           wrapper_host_ms=float(np.median(host_cost)),
                           shape=list(fb.shape))
        log(f"[gamma] {label} {tuple(fb.shape)}: G1 {ms * 1e3:.2f} us a "
            f"launch (device, {GAMMA_REPS} launches), bound "
            f"{bound_ms * 1e3:.2f} us (bytes), == gamma_reference True; "
            f"gamma_cuda's host cost {rows[label]['wrapper_host_ms']:.4f} "
            f"ms; twin (numpy, host) {plain_ms:.2f} ms; torch's float64 "
            f"expression {library_ms * 1e3:.2f} us, same bits "
            f"{library_same}; on {card}")
    return rows


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

    def counting_dense(sph, quad, pay, med=None):
        inner = dense(sph, quad, pay, med)

        def hit(ox, oy, oz, dx, dy, dz, **key):
            if blocks is not None:
                last["enter"], last["lens"] = culled_blocks(
                    ox, oy, oz, dx, dy, dz)
            return inner(ox, oy, oz, dx, dy, dz, **key)
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
            per_seg = sol.segment_ops(low.n_sph, low.n_quad, low.has_met,
                                      low.has_die)
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
            per_seg = sol.segment_ops(f.n_sph, f.n_quad, f.has_met,
                                      f.has_die)
            in_bytes = sum(4 * a.size for a in (f.sph, f.quad, f.pay, f.cam))
            flags = (f.has_met, f.has_die)
            split = lib.tinyrt_megakernel_flat_split(
                w, h, spp, int(f.has_met), int(f.has_die), int(f.sky),
                int(r.bvh), int(f.n_med > 0))
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
        b_ms, b_by, ops = sol.bound(w * h * spp, segments, per_seg, 12 * w * h,
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
            f"({b_by}, {ops:.4g} ops at {sol.FP32_PEAK / 1e12:g} TFLOP/s)")
        if blocks is not None:
            rows_per_seg = n["rows"] / n["seg"]
            warp_rows = n["warp_rows"] / n["warp_steps"]
            res.update(warp_rows_per_step=warp_rows)
            log(f"[count] {label}: a lockstep warp walks {warp_rows:.1f} "
                f"sphere rows per bounce step under the per-thread cull")
            c_seg = sol.culled_segment_ops(args["aabbs"].shape[0],
                                           rows_per_seg, *flags)
            cb_ms, cb_by, c_ops = sol.bound(w * h * spp, segments, c_seg,
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
                    before = n_launches(ik.closest_hit)
                    outs.append(ik.closest_hit(c, o, d, need_j))
                    torch.cuda.synchronize()
                    if n_launches(ik.closest_hit) != before + (
                            o.shape[0] > 0):
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
    glob_bound, glob_by, _ = sol.k3_bound(glob_rays, cs.n_sph, cs.n_quad)
    log(f"[k3] global route bound: {glob_bound:.4f} ms a wavefront "
        f"({glob_by})")

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
    bound_ms, bound_by, _ = sol.k3_bound(r, cs.n_sph, cs.n_quad)

    def named(t):
        return {f"{k} {b}": v for (k, b), v in t.items()}

    rec = dict(rays=r, ms=times[("primary", 0)], plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
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
        before = n_launches(ik.closest_hit)
        out = step(p0, o0, 0) if compact is None else step(p0, o0, 0,
                                                           compact)
        torch.cuda.synchronize()
        return out, n_launches(ik.closest_hit) - before

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

    # a 2-round probe step at spp=4, broken down and profiled
    npix = w * h
    probe_step, state = make(4)
    timed(probe_step, state, 0)
    _, _, probe_s = timed(probe_step, state, 1)
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
    spp = CFG5_SPP
    cut = spp != CFG5["spp"]
    chunk = trace_ops.sample_rounds(npix, spp, True)[0]
    log(f"[cfg5] probe step at spp=4: {probe_s:.2f} s; running spp={spp} "
        f"(cut from {CFG5['spp']}, a cut of depth), rounds of "
        f"{chunk * npix} rays")
    step, state = make(spp)
    counters = {"K1": 0, "K2": 0, "K3": 0}
    from tinyraytracer_tpu_torch.ops import megakernel as mk
    from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
    zero_launches(mkp.render_packed, mk.render_flat, ik.closest_hit)
    inverse.mesh_value_and_grad = checking_vg
    try:
        state, loss0, warm_s = timed(step, state, 0)
        torch.cuda.reset_peak_memory_stats()
        times, per_step = [], []
        for i in (1, 2):
            before = n_launches(ik.closest_hit)
            state, loss, dt = timed(step, state, i)
            times.append(dt)
            per_step.append(n_launches(ik.closest_hit) - before)
    finally:
        inverse.mesh_value_and_grad = real_vg
    counters.update(K1=n_launches(mkp.render_packed),
                    K2=n_launches(mk.render_flat),
                    K3=n_launches(ik.closest_hit))
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


def ptxas_entries(log_text):
    """Registers and spills of every kernel in a build's `nvcc -Xptxas -v`
    log: {mangled name: (registers, spill store bytes, spill load
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
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def ptxas_diff(log_text):
    """Registers and spills of each fused-kernel variant from a build's
    `nvcc -Xptxas -v` log: {(kernel "K5"/"K4"/"K5 image"/"K4 image",
    (nee, sil, met, die)): (registers, spill store bytes, spill load
    bytes)}."""
    import re
    out = {}
    for name, entry in ptxas_entries(log_text).items():
        kind = _diff_kernel_kind(name)
        if kind:
            f = re.search(r"ILb(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
            out[(kind, tuple(bool(int(x)) for x in f.groups()))] = entry
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
    replay = per_seg_fwd - sol.OPS_K5_COLOR
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
            before = n_launches(dkp.packed_diff)
            got = dkp.packed_diff(tab, cvec, tgt, **args)
            again = dkp.packed_diff(tab, cvec, tgt, **args)
            torch.cuda.synchronize()
            if n_launches(dkp.packed_diff) != before + 2:
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
    b_ms, b_by, ops, per_seg = sol.k5_bound(spec, w * h, spp, segments)
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
    fwd_ops = sol.per_seg_split(spec)[0]
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


def diff_twin_check(torch, dkp, tag, kernel, label, args, tab, cvec, tgt,
                    twin_args=None):
    """A fused kernel's wrapper (`kernel`: packed_diff or classic_diff)
    launched twice on the card against the twin on the same inputs: the
    image bit for bit, every gradient table within TABLE_RTOL of its
    largest entry, the two launches bit for bit, all finite. Returns the
    kernel's outputs, whether all held, the message, the largest table
    ratio and the largest |d|."""
    before = n_launches(kernel)
    got = kernel(tab, cvec, tgt, **args)
    again = kernel(tab, cvec, tgt, **args)
    torch.cuda.synchronize()
    if n_launches(kernel) != before + 2:
        raise RuntimeError(f"{label}: the launch counter did not rise")
    want = dkp.packed_diff_reference(tab, cvec, tgt, **(twin_args or args))
    det = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(got, again))
    img_eq = torch.equal(got[0], want[0])
    rels, d = _tables_rel(torch, got, want)
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    msg = (f"[{tag}] {label}: image bitwise {img_eq}; tables max|d| / "
           "max|table| " + ", ".join(f"{n} {r:.3g}" for n, r in
                                     rels.items())
           + f" (allowed {dkp.TABLE_RTOL:g}; max|d| {d:.3g}); loss "
           f"{float(got[5][0, 3]):.9g} twin {float(want[5][0, 3]):.9g}; "
           f"two launches bit for bit {det}; finite {finite}")
    ok = img_eq and det and finite and max(rels.values()) <= dkp.TABLE_RTOL
    return got, ok, msg, max(rels.values()), d


def k4_phase(torch, np, presets, dk, dkp, card):
    """K4 against its twin on the card (and against K5 where both run);
    returns the K4 record."""
    worst = dict(abs=0.0, rel=0.0)

    def check(label, args, tab, cvec, tgt, twin_args=None, k5=False):
        got, ok, msg, rel, d = diff_twin_check(
            torch, dkp, "k4", dk.classic_diff, label, args, tab, cvec, tgt,
            twin_args)
        worst["abs"] = max(worst["abs"], d)
        worst["rel"] = max(worst["rel"], rel)
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
        b_ms, b_by, ops, per_seg = sol.k4_bound(spec, w * h, spp, segs * spp)
        fwd_ops = sol.k4_fwd_ops(spec)[0] + sol.OPS_K5_COLOR
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
    before = (n_launches(dkp.packed_diff), n_launches(ik.closest_hit))
    lf, _img, gf = dk.render_value_and_grad(
        scene, camera, target, spp=spp, max_bounces=mb, background=bg,
        seed=0)
    torch.cuda.synchronize()
    k5_n = n_launches(dkp.packed_diff) - before[0]
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
        before = (n_launches(dkp.packed_diff), n_launches(ik.closest_hit))
        _, losses = inverse.fit(
            template, camera, target, steps=steps, spp=spp, max_bounces=mb,
            background=bg, trainable=TRAINABLE, engine=engine,
            device="cuda")
        n5 = n_launches(dkp.packed_diff) - before[0]
        n3 = n_launches(ik.closest_hit) - before[1]
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
    return {"K1": n_launches(mkp.render_packed),
            "K2": n_launches(mk.render_flat),
            "K3": n_launches(ik.closest_hit),
            "K4": n_launches(dk.classic_diff),
            "K5": n_launches(dkp.packed_diff)}


def _zero_counters(ik, mk, mkp, dk, dkp):
    zero_launches(mkp.render_packed, mk.render_flat, ik.closest_hit,
                  dk.classic_diff, dkp.packed_diff)


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


ROUTE_MANYSPHERE_STEPS = 20


def routing_phase(torch, presets, ik, mk, mkp, dk, dkp, inverse, card):
    """fit(engine="auto") routes many-sphere scenes to K4 on the card, and
    the many-sphere example trains one row."""
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

    # the many-sphere example (examples/torch_manysphere_fit.py) for
    # ROUTE_MANYSPHERE_STEPS steps: the big diffuse sphere moved along z
    # and fitted back, every other row pinned
    steps = ROUTE_MANYSPHERE_STEPS
    manysphere = _example("torch_manysphere_fit")["main"]
    _zero_counters(ik, mk, mkp, dk, dkp)
    ms = manysphere(["--steps", str(steps)])
    n = _counters(ik, mk, mkp, dk, dkp)
    curve = ms["curve"]
    log(f"[route] manysphere fit: {ms['spheres']} spheres + lamp 128x128 "
        f"spp=16 mb=4, row {ms['row']} trained (start offset 1.5): "
        f"{steps} steps in {ms['seconds']:.2f} s; position error "
        f"{curve[0][2]:.4f} -> {ms['final_error']:.4f}; drift of untrained "
        f"rows {ms['drift']}; launches {n}; on {card}")
    if (ms["drift"] != 0.0 or n["K4"] != steps or n["K5"]
            or not all(math.isfinite(c[1]) for c in curve)):
        raise RuntimeError("manysphere fit: untrained rows moved, wrong "
                           "launch count or a non-finite loss")
    return dict(curve=curve, seconds=ms["seconds"], drift=ms["drift"],
                launches=n)


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
# config 4b's whole renders through the BVH, each beside K2's: 2, a cut
# of depth to keep the script's time: each takes 30-40 s of host-bound
# walks
BVH_RENDER_REPS = 2
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
    from tinyraytracer_tpu_torch.native import runtime as native_rt
    t0 = time.perf_counter()
    native_rt.load()            # g++ at first use, unless phase 4 built it
    load_s = time.perf_counter() - t0
    build_s, numpy_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        host_bvh = bvh_ops.build_bvh(scene)       # the native builder
        build_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        numpy_bvh = bvh_ops.build_bvh(scene, use_native=False)
        numpy_s.append(time.perf_counter() - t0)
    a = host_bvh.numpy()
    same = all(np.array_equal(v, numpy_bvh.numpy()[k]) and
               v.dtype == numpy_bvh.numpy()[k].dtype for k, v in a.items())
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
    nmed, nlo, nhi = _spread(numpy_s)
    res["build"] = dict(primitives=int((lp >= 0).sum()), nodes=m,
                        build_s=build_s, median_s=med, numpy_s=numpy_s,
                        numpy_median_s=nmed, native_equals_numpy=same,
                        native_load_s=load_s)
    log(f"[bvh] build_bvh at {int((lp >= 0).sum())} primitives ({m} nodes) "
        f"on the host, the C++ builder (native/, loaded in {load_s:.2f} s: "
        f"the g++ build unless phase 4 did it): {med * 1e3:.2f} ms "
        f"[{lo * 1e3:.2f}, "
        f"{hi * 1e3:.2f}], use_native=False (numpy): {nmed * 1e3:.1f} ms "
        f"[{nlo * 1e3:.1f}, {nhi * 1e3:.1f}] (median [min, max] of 3); "
        f"arrays bit for bit: {same}; layout well-formed: {ok}")
    if not ok or not same:
        raise RuntimeError("the BVH's threaded layout is malformed, or the "
                           "native builder's arrays differ from numpy's")

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
    for _ in range(BVH_RENDER_REPS):
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
    mb_ = sum(times["bvh"]) / len(times["bvh"])
    mk_ = sum(times["k2"]) / len(times["k2"])
    rays = c4["width"] * c4["height"] * spp
    busy = [p["busy"] for p in profiled]
    res["cfg4b"] = dict(
        spp=spp, max_bounces=c4["max_bounces"], render_s=times["bvh"],
        mean_s=mb_, mrays_s=rays / mb_ / 1e6, k2_render_s=times["k2"],
        k2_mean_s=mk_, warmup_s=warm_s, walks=walks,
        iterations_per_bounce_mean=walks["iterations_mean"],
        iterations_per_bounce_max=walks["max_iterations"],
        ray_steps_per_ray_walk=walks["ray_steps"] / (rays * c4[
            "max_bounces"]),
        profiled_walks=profiled, walk_share=walk_share, kernels_idle=True,
        vs_k2=_image_check(np, "cfg4b BVH image vs K2", img, img_k2,
                           BVH_K2_MAX_FRAC, PARITY_MEAN_RTOL))
    log(f"[bvh] cfg4b {c4['width']}x{c4['height']} spp={spp} "
        f"mb={c4['max_bounces']}, Renderer(accelerator=\"bvh\").render_array"
        f" {mb_ * 1e3:.1f} ms ("
        + ", ".join(f"{t * 1e3:.1f}" for t in times["bvh"])
        + f"), {rays / mb_ / 1e6:.3f} camera Mrays/s; K2 {mk_ * 1e3:.2f} ms ("
        + ", ".join(f"{t * 1e3:.2f}" for t in times["k2"])
        + f") (mean (readings) of {BVH_RENDER_REPS}, alternating) on {card};"
        " K1-K5 launches during the BVH renders: 0")
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
    if read_png(np, png).shape != (48, 64, 3):
        raise RuntimeError("the CLI's PNG does not decode to 64x48")
    return res


# Phase 20, the examples group: the last public names on the card and the
# port's two examples at their defaults. render_burst on cfg1 (K1, 8
# seeds, timed per image against single renders in BURST_REPS alternating
# pairs) and cfg4b (K2, culled, 2 seeds); intersect_scene on cfg3's
# primary rays (INTERSECT_RAYS), card against CPU.
BURST_SEEDS = 8
BURST_SEEDS_K2 = 2
BURST_REPS = 7
INTERSECT_RAYS = dict(width=64, height=48)
INTERSECT_T_ULP = 4          # ROADMAP's few-ulp tier for hit t
INVERSE_START_ERROR = 3.0    # the perturbation's largest offset per axis
MANYSPHERE_START_ERROR = 1.5
# Recovery gates: each example must make at least half the recovery it
# made in its first full run on the card (NVIDIA H100 80GB HBM3, PERF.md
# §6: max center error 3.0 -> 1.0999, position error 1.5 -> 1.2490).
# The runs repeat bit for bit on one card; half leaves room for another
# build's last bits to move the noisy fit.
INVERSE_MAX_ERROR = INVERSE_START_ERROR - (INVERSE_START_ERROR
                                           - 1.0999) / 2
MANYSPHERE_MAX_ERROR = MANYSPHERE_START_ERROR - (MANYSPHERE_START_ERROR
                                                 - 1.2490) / 2


def _example(name):
    """The `main` and helpers of examples/<name>.py."""
    import runpy

    return runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"))


def burst_checks(torch, presets, ik, mk, mkp, dk, dkp, card):
    """render_burst: one counted burst of each kernel, every frame bit for
    bit its single render, then cfg1 timed per image. Returns the record
    and the counted launches."""
    renderers = {}
    for label in ("cfg1", "cfg4b"):
        _, name, pkw, w, h, spp, mb, _ = next(c for c in CONFIGS
                                              if c[0] == label)
        world, camera, kw = presets.PRESETS[name](width=w, height=h, **pkw)
        renderers[label] = (mk.MegakernelRenderer(
            world.build(), camera, kw["background"], "cuda"), spp, mb)
    seeds = {"cfg1": list(range(BURST_SEEDS)),
             "cfg4b": list(range(BURST_SEEDS_K2))}
    for r, spp, mb in renderers.values():          # lowerings and build
        r.render(spp=1, max_bounces=1)
    torch.cuda.synchronize()
    _zero_counters(ik, mk, mkp, dk, dkp)
    bursts = {label: r.render_burst(spp=spp, max_bounces=mb,
                                    seeds=seeds[label])
              for label, (r, spp, mb) in renderers.items()}
    torch.cuda.synchronize()
    launches = _counters(ik, mk, mkp, dk, dkp)
    want = dict(K1=BURST_SEEDS, K2=BURST_SEEDS_K2, K3=0, K4=0, K5=0)
    log(f"[burst] render_burst cfg1 x{BURST_SEEDS} (K1), cfg4b "
        f"x{BURST_SEEDS_K2} (K2, culled): launches {launches}")
    if launches != want:
        raise RuntimeError(f"render_burst launched {launches}, expected "
                           f"{want}")
    for label, (r, spp, mb) in renderers.items():
        for i, s in enumerate(seeds[label]):
            if not torch.equal(bursts[label][i],
                               r.render(spp=spp, max_bounces=mb, seed=s)):
                raise RuntimeError(f"render_burst {label} frame {i} differs "
                                   "from its single render")
        if not bool(torch.isfinite(bursts[label]).all()):
            raise RuntimeError(f"render_burst {label}: non-finite frame")
    log("[burst] every frame == render(seed=) bit for bit")

    r, spp, mb = renderers["cfg1"]
    n = BURST_SEEDS

    def burst():
        t0 = time.perf_counter()
        r.render_burst(spp=spp, max_bounces=mb, seeds=range(n))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    def singles():
        t0 = time.perf_counter()
        for s in range(n):
            r.render(spp=spp, max_bounces=mb, seed=s)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    burst(), singles()
    _, span = time_once(torch, lambda: r.render_burst(
        spp=spp, max_bounces=mb, seeds=range(n)))
    b_s, s_s = [], []
    for k in range(BURST_REPS):
        pair = [(burst, b_s), (singles, s_s)]
        for fn, acc in (pair if k % 2 == 0 else pair[::-1]):
            acc.append(fn())
    bm, s = _spread(b_s), _spread(s_s)
    w, h = r.camera.width, r.camera.height
    log(f"[burst] cfg1 {w}x{h} spp={spp} mb={mb}, ms per image over "
        f"{BURST_REPS} alternating pairs: burst of {n} {bm[0] * 1e3:.4f} "
        f"[{bm[1] * 1e3:.4f}, {bm[2] * 1e3:.4f}], single synchronised "
        f"render {s[0] * 1e3:.4f} [{s[1] * 1e3:.4f}, {s[2] * 1e3:.4f}]; "
        f"a burst's device span (CUDA events) {span / n:.4f} per image; "
        f"burst {w * h * spp / bm[0] / 1e6:.1f} camera Mrays/s; on {card}")
    return dict(burst_ms=[x * 1e3 for x in bm],
                single_ms=[x * 1e3 for x in s], span_ms=span / n,
                mrays_s=w * h * spp / bm[0] / 1e6), launches


def intersect_check(torch, presets, generate_rays):
    """intersect_scene on cfg3's primary rays: the card against the CPU.
    Hit masks equal; winners equal but at ties, where the CPU's own
    candidate t of the two winners are within INTERSECT_T_ULP (the light
    is coplanar with the ceiling); hit t within INTERSECT_T_ULP."""
    from tinyraytracer_tpu_torch.ops import intersect as isect

    w, h = INTERSECT_RAYS["width"], INTERSECT_RAYS["height"]
    world, camera, _ = presets.cornell_box(width=w, height=h)
    scene, gpu = world.build(), world.build().to("cuda")
    o, d = generate_rays(camera, torch.arange(w * h), 0, 0)
    cpu_rec = isect.intersect_scene(scene, o, d)
    card_rec = isect.intersect_scene(gpu, o.cuda(), d.cuda())
    j_cpu = isect.closest_select(scene, o, d)[1]
    j_card = isect.closest_select(gpu, o.cuda(), d.cuda())[1].cpu()
    hit = cpu_rec.hit
    if not torch.equal(card_rec.hit.cpu(), hit):
        raise RuntimeError("intersect_scene: hit masks differ card vs CPU")
    rows = torch.nonzero(hit & (j_card != j_cpu)).flatten()
    t_all = torch.cat([isect.sphere_ts(scene, o, d),
                       isect.quad_ts(scene, o, d)], 1)
    t_a, t_b = t_all[rows, j_card[rows]], t_all[rows, j_cpu[rows]]
    tie_ulps = _ulps(torch, t_a, t_b) if len(rows) else 0
    exact = int((t_a == t_b).sum())
    ulps = _ulps(torch, card_rec.t.cpu()[hit], cpu_rec.t[hit])
    log(f"[intersect] intersect_scene on cornell_box's primary rays "
        f"{w}x{h}: {int(hit.sum())} hits, masks equal; winners differ on "
        f"{len(rows)} ({exact} exact ties, the CPU's candidate t within "
        f"{tie_ulps} ulp); hit t within {ulps} ulp")
    if tie_ulps > INTERSECT_T_ULP or ulps > INTERSECT_T_ULP:
        raise RuntimeError("intersect_scene: the card differs from the CPU")
    return dict(hits=int(hit.sum()), winner_flips=len(rows),
                exact_ties=exact, t_ulps=ulps)


def example_twin_checks(torch, presets, dk, dkp, inverse, trace_ops):
    """K5 and K4 against the twin at the examples' own inputs, outside
    the counted runs: the inverse example's first step at its spp and its
    refine phase's first step at --refine-spp (K5, the perturbed
    cornell_spheres at 96x96, mb=6), and the many-sphere example's first
    step (K4, one surrogate row). Returns the largest |d| per kernel."""
    worst = dict(K5=0.0, K4=0.0)

    def check(kid, label, scene, camera, target, bg, trainable, rows, runs):
        st = dk.build_diff_static(scene)
        sil, surr = inverse._surrogate_scope(frozenset(trainable))
        if rows is not None:
            surr = {k: tuple(rows.get(k, ())) for k in ("sph", "quad")}
        surr_s, surr_q, class_level = dk._surrogate_rows(st, surr)
        packed = class_level and dk.routes_packed(st, bg)
        if packed != (kid == "K5"):
            raise RuntimeError(f"{label}: the step would not route to {kid}")
        if packed:
            surr_s, surr_q = bool(surr_s), bool(surr_q)
        _, tab, cvec, tgt, spec = dkp._inputs(scene, camera, target, bg, st,
                                              True, sil, surr_s, surr_q)
        kernel = dkp.packed_diff if packed else dk.classic_diff
        for spp, mb, seed, offset in runs:
            _, ok, msg, _, d = diff_twin_check(
                torch, dkp, "examples", kernel, f"{kid} at {label} {spp=} "
                f"mb={mb} spp_offset={offset}",
                dict(spec=spec, width=camera.width, height=camera.height,
                     spp=spp, max_bounces=mb, seed=seed, spp_offset=offset),
                tab, cvec, tgt)
            log(msg)
            worst[kid] = max(worst[kid], d)
            if not ok:
                raise RuntimeError(f"{label}: {kid} disagrees with its twin "
                                   "or is not deterministic")

    ex = _example("torch_inverse_render")
    size, spp, refine, mb, steps = 96, 32, 128, 6, 400
    world, camera, kw = presets.cornell_spheres(width=size, height=size)
    scene, camera = world.build().to("cuda"), camera.to("cuda")
    target = trace_ops.render_image(scene, camera, spp=64, max_bounces=mb,
                                    background=kw["background"], seed=7,
                                    nee=True)
    refine_from = max(40, steps * 4 // 5)
    check("K5", f"the inverse example's cornell_spheres {size}x{size}",
          ex["perturb"](scene), camera, target, kw["background"],
          ("sph_center", "mat_albedo"), None,
          [(spp, mb, 13, 0), (refine, mb, 13, refine_from * refine)])

    build = _example("torch_manysphere_fit")["build"]
    bg = (0.01, 0.01, 0.015)
    true, camera, _, row = build(0.0)
    camera = camera.to("cuda")
    target = trace_ops.render_image(true.to("cuda"), camera, spp=48,
                                    max_bounces=4, background=bg, seed=1,
                                    nee=True)
    check("K4", "the many-sphere example's 128 spheres + lamp 128x128",
          build(1.5)[0].to("cuda"), camera, target, bg, ("sph_center",),
          {"sph": (row,)}, [(16, 4, 0, 0)])
    return worst


def examples_phase(torch, presets, ik, mk, mkp, dk, dkp, inverse, trace_ops,
                   generate_rays, card):
    """Phase 20: render_burst, intersect_scene, K5 and K4 against the twin
    at the examples' inputs, and both examples at their defaults, every
    counter zeroed before each counted run."""
    res, launches = burst_checks(torch, presets, ik, mk, mkp, dk, dkp, card)
    res["intersect"] = intersect_check(torch, presets, generate_rays)
    res["max_abs_err"] = example_twin_checks(torch, presets, dk, dkp,
                                             inverse, trace_ops)
    out = os.path.join(ROOT, "output")

    inverse = _example("torch_inverse_render")["main"]
    _zero_counters(ik, mk, mkp, dk, dkp)
    t0 = time.perf_counter()
    inv = inverse(["--out", os.path.join(out, "torch_inverse")])
    total = time.perf_counter() - t0
    n = _counters(ik, mk, mkp, dk, dkp)
    losses = inv["losses"]
    log(f"[examples] torch_inverse_render at its defaults (96x96 spp=32, "
        f"refine 128, mb=6, 400 steps, engine {inv['engine']}): "
        f"{inv['seconds'] / inv['steps'] * 1e3:.3f} ms a step, "
        f"{total:.2f} s in all; loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"max center error {inv['max_center_error']:.4f} (start "
        f"{INVERSE_START_ERROR}, allowed {INVERSE_MAX_ERROR:.4f}); albedos "
        f"{inv['albedos'].tolist()}; launches {n}; on {card}")
    if (n["K5"] != inv["steps"] or n["K4"]
            or not all(math.isfinite(x) for x in losses)
            or not inv["max_center_error"] < INVERSE_MAX_ERROR):
        raise RuntimeError("torch_inverse_render: not on K5, a non-finite "
                           "loss, or no recovery")
    for k in launches:
        launches[k] += n[k]

    ckpt = os.path.join(out, "torch_inverse_resume.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    argv = ["--steps", "60", "--checkpoint", ckpt,
            "--out", os.path.join(out, "torch_inverse_resume")]
    whole, resumed = inverse(argv), inverse(argv)
    same = (resumed["start"] == 50
            and resumed["losses"] == whole["losses"][50:]
            and all(torch.equal(v, resumed["last_params"][k])
                    for k, v in whole["last_params"].items()))
    log(f"[examples] resume: 60 steps, checkpoint at 50, resumed steps "
        f"{resumed['start']}-59 == the uninterrupted run bit for bit "
        f"(losses and params): {same}")
    if not same:
        raise RuntimeError("torch_inverse_render: resume is not bit for bit")

    manysphere = _example("torch_manysphere_fit")["main"]
    _zero_counters(ik, mk, mkp, dk, dkp)
    t0 = time.perf_counter()
    ms = manysphere([])
    total_ms = time.perf_counter() - t0
    n = _counters(ik, mk, mkp, dk, dkp)
    log(f"[examples] torch_manysphere_fit at its defaults ({ms['spheres']} "
        f"spheres + lamp, 128x128 spp=16 mb=4, {ms['steps']} steps, row "
        f"{ms['row']}): {ms['seconds'] / ms['steps'] * 1e3:.3f} ms a step, "
        f"{total_ms:.2f} s in all; loss {ms['curve'][0][1]:.6f} -> "
        f"{ms['curve'][-1][1]:.6f}; position error {ms['curve'][0][2]:.4f} "
        f"-> {ms['final_error']:.4f} (start {MANYSPHERE_START_ERROR}, "
        f"allowed {MANYSPHERE_MAX_ERROR:.4f}); drift {ms['drift']}; "
        f"launches {n}; on {card}")
    if (n["K4"] != ms["steps"] or n["K5"] or ms["drift"] != 0.0
            or not ms["final_error"] < MANYSPHERE_MAX_ERROR
            or not all(math.isfinite(c[1]) for c in ms["curve"])):
        raise RuntimeError("torch_manysphere_fit: not on K4, rows drifted, "
                           "a non-finite loss or no recovery")
    for k in launches:
        launches[k] += n[k]
    res["inverse"] = dict(
        {k: inv[k] for k in ("engine", "seconds", "steps",
                             "max_center_error")},
        ms_per_step=inv["seconds"] / inv["steps"] * 1e3, total_s=total,
        first_loss=losses[0], last_loss=losses[-1],
        albedos=inv["albedos"].tolist(), resume_bitwise=same)
    res["manysphere"] = dict(
        {k: ms[k] for k in ("seconds", "steps", "final_error", "drift",
                            "curve")},
        ms_per_step=ms["seconds"] / ms["steps"] * 1e3, total_s=total_ms)
    res["launches"] = launches
    log(f"[examples] launches in the phase's counted runs: {launches}")
    return res


# Phase 21: bench_torch.py, the port of bench.py. Its launches, each
# section's calls: configs 1-3 a warm-up and 3 timed renders each (K1 12)
# plus config 1's 4 bursts of 8 (K1 32); config 4 (K2 4) and config 4b's
# two Renderers, 3 renders each (K2 6); mean_executed_bounces' trace,
# one t-and-j launch a bounce of each of its 2 samples at mb=20 (K3 40);
# the 300x300 step, 1 + 5 (K5 6), the all-fields north star's warm-up
# and 2 steps (K5 3), the config-5 shaped step 1 + 2 (K5 3); the
# cfg4-class step 1 + 3 (K4 4).
BENCH_LAUNCHES = {"K1": 44, "K2": 10, "K3": 40, "K4": 4, "K5": 12}
# K5 at the first input of the all-fields 300x300 step and north star,
# against the twin: each step's shape with spp cut (from 16 and 200) to
# BENCH_TWIN_SPP (the twin runs the 18 quads' surrogates as (rows,
# pixels) matrices).
BENCH_TWIN_SPP = 2


def _defaults(fn):
    """The keyword defaults of a bench section: its sizes."""
    import inspect

    return {k: v.default for k, v in inspect.signature(fn).parameters.items()
            if v.default is not inspect.Parameter.empty}


def bench_phase(torch, presets, ik, mk, mkp, dk, dkp, inverse, card,
                cfg5f=None):
    """Phase 21: bench_torch.py on the card. First, outside the counted
    run, K5 with every field trainable (the full surrogate scope) against
    its twin at the first input of the 300x300 step and of the north
    star, spp cut to BENCH_TWIN_SPP, with the route, the accumulator
    width and the launch plan of each; then bench_torch.main with every
    counter zeroed: no error or missing key, every rate positive, every
    share in (0, 1], each kernel launched BENCH_LAUNCHES times."""
    import bench_torch
    from tinyraytracer_tpu_torch import _build
    from tinyraytracer_tpu_torch.ops import diff_schedule as ds

    errs, infos = [], {}
    for name, fn in (("fwdbwd", bench_torch.bench_fwdbwd),
                     ("northstar", bench_torch.bench_northstar)):
        b = _defaults(fn)
        w, h, mb = b["width"], b["height"], b["max_bounces"]
        world, camera, kw = presets.cornell_box(width=w, height=h)
        scene, camera = world.build().to("cuda"), camera.to("cuda")
        bg = kw["background"]
        st = dk.build_diff_static(scene)
        acc = dk.packed_acc_width(len(st.sph_rows), len(st.quad_rows),
                                  st.nm, st.n_lights)
        packed = dk.routes_packed(st, bg)
        sil, surr = inverse._surrogate_scope(None)
        surr_s, surr_q, class_level = dk._surrogate_rows(st, surr)
        target = torch.zeros((h, w, 3), device="cuda")
        _, tab, cvec, tgt, spec = dkp._inputs(scene, camera, target, bg, st,
                                              True, sil, bool(surr_s),
                                              bool(surr_q))
        log(f"[bench] {name}: cornell_box {w}x{h}, every field trainable: "
            f"{len(st.sph_rows)} spheres + {len(st.quad_rows)} quads, "
            f"{len(spec.surr_s)} sphere and {len(spec.surr_q)} quad "
            f"surrogates, silhouette {sil}; accumulator {acc} of "
            f"{dk.DIFF_PACKED_MAX_ACC} floats; class scope {class_level}; "
            f"routes to {'K5' if packed and class_level else 'K4'}")
        if not (packed and class_level):
            raise RuntimeError(f"the all-fields {name} step would not run "
                               "on K5")
        t0 = time.perf_counter()
        _, ok, msg, _, err = diff_twin_check(
            torch, dkp, "bench", dkp.packed_diff,
            f"K5 at the {name} step's first input {w}x{h} "
            f"spp={BENCH_TWIN_SPP} (cut from {b['spp']}) mb={mb}",
            dict(spec=spec, width=w, height=h, spp=BENCH_TWIN_SPP,
                 max_bounces=mb, seed=0), tab, cvec, tgt)
        log(f"{msg}; {time.perf_counter() - t0:.1f} s")
        if not ok:
            raise RuntimeError(f"K5 at the bench's all-fields {name} input "
                               "disagrees with its twin or is not "
                               "deterministic")
        errs.append(err)
        infos[name] = _diff_launch_info(torch, dk, dkp, ds, _build, "K5",
                                        spec, tab.numel(), w * h, b["spp"],
                                        mb)
        log(f"[bench] all-fields {name} launch ({w}x{h} spp={b['spp']} "
            f"mb={mb}): {infos[name]}")

    _zero_counters(ik, mk, mkp, dk, dkp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    line = bench_torch.main(["--device", "cuda"])
    wall = time.perf_counter() - t0
    counters = _counters(ik, mk, mkp, dk, dkp)
    peak = torch.cuda.max_memory_allocated()
    bad = bench_torch.problems(line)
    log(f"[bench] bench_torch.main in {wall:.1f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB; launches {counters} (expected "
        f"{BENCH_LAUNCHES}); problems {bad or 'none'}; on {card}")
    ns, c5 = (line.get("fwdbwd_northstar_step_s"),
              line.get("fwdbwd_northstar_cfg5_step_s"))
    if cfg5f is not None and c5 and ns:
        log(f"[bench] config-5 shaped step {c5:.4f} s against phase 14's "
            f"cfg5f {min(cfg5f['step_s']):.4f} s (ratio "
            f"{c5 / min(cfg5f['step_s']):.4f}); all fields {ns:.4f} s")
    if bad or counters != BENCH_LAUNCHES:
        raise RuntimeError(f"bench_torch: {bad}; launches {counters}")
    return dict(line=line, launches=counters, wall_s=wall, peak_bytes=peak,
                max_abs_err=max(errs), launch=infos, acc_width=acc)


# Phase 22: the measured-mix ceiling (csrc/microbench.cu, P5). Each mix's
# kernel against its twin at one full wave and SOL_TWIN_ITERS iterations
# (select, sphere and quad bit for bit, fma within 1 ulp, transcendental
# within microbench.TRANSC_ULP: 0, measured), two launches bit for bit;
# the five mixes timed beside the twin at the probe's 2 000 iterations;
# then the rates through scripts/torch_probe_vpu_microbench.py, which
# must find utils/sol.py's three rates within SOL_RTOL.
SOL_TWIN_ITERS = 64
SOL_RTOL = 0.15
SOL_ULP = {"fma": 1, "select": 0, "sphere": 0, "quad": 0}
# The counted operations of a mix, as opcodes of its loop body: in sol.py's
# units an FFMA counts 2, every other listed opcode 1 (a select none).
SASS_COUNTED = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "MUFU")


def slow_call_blocks(ins, addrs, opcodes):
    """Per instruction of a function's SASS (`ins`: (address, text)
    pairs), 1 if it lies in a slow-path call block: the few instructions
    a predicated forward branch skips to reach a CALL of IEEE sqrt's or
    divide's slow path, which run only when a lane needs it."""
    import re
    slow = [0] * len(ins)
    for i, (_, x) in enumerate(ins):
        t = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", x)
        if t and int(t.group(1), 16) > addrs[i] and x.lstrip()[:1] == "@":
            j = addrs.index(int(t.group(1), 16))
            if j - i <= 8 and "CALL" in opcodes[i + 1:j]:
                slow[i + 1:j] = [1] * (j - i - 1)
    return slow


def microbench_sass():
    """Opcodes of each microbench_kernel variant's loop body (the back
    edge of largest span), read off phase 2's listing: its counted
    operations (SASS_COUNTED, an FFMA twice) must be at least the mix's
    OPS_PER_ITER x UNROLL (nvcc hoisted or folded none), and the fma mix
    holds exactly 3 x UNROLL FFMAs."""
    import re
    from collections import Counter

    from tinyraytracer_tpu_torch.utils import microbench as mb

    with open(os.path.join(ROOT, "output", "forward_sass.txt")) as f:
        sass = f.read()
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"microbench_kernelILi(\d)E", part.split()[0])
        if not m:
            continue
        mix = mb.MIXES[int(m.group(1))]
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
        addrs = [int(a, 16) for a, _ in ins]
        loops = []
        for i, (_, x) in enumerate(ins):
            b = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", x)
            if b and int(b.group(1), 16) < addrs[i]:
                loops.append((addrs[i] - int(b.group(1), 16),
                              addrs.index(int(b.group(1), 16)), i))
        if not loops:
            raise RuntimeError(f"microbench {mix}: no loop in the SASS")
        _, a, b = max(loops)
        opcodes = [re.sub(r"^@!?P\d+\s+", "", x.strip()).split()[0]
                   .split(".")[0] for _, x in ins]
        ops = Counter(opcodes[a:b + 1])
        counted = sum(ops[k] * (2 if k == "FFMA" else 1)
                      for k in SASS_COUNTED)
        fast = b - a + 1 - sum(slow_call_blocks(ins, addrs, opcodes)[a:b + 1])
        want = mb.OPS_PER_ITER[mix] * mb.UNROLL
        log(f"[sol] SASS of the {mix} loop: {b - a + 1} instructions for "
            f"{mb.UNROLL} iterations ({fast} off its slow-path calls), "
            f"counted-class {counted} (want >= {want}): "
            f"{dict(sorted(ops.items()))}")
        if counted < want or (mix == "fma" and ops["FFMA"] != 3 * mb.UNROLL):
            raise RuntimeError(f"microbench {mix}: the loop holds fewer "
                               "operations than the mix counts")
        out[mix] = dict(instructions=b - a + 1, fast=fast, counted=counted,
                        opcodes=dict(ops))
    if set(out) != set(mb.MIXES):
        raise RuntimeError(f"microbench variants in the SASS: {sorted(out)}")
    return out


def sol_phase(torch, card):
    """Phase 22: csrc/microbench.cu against its twin, timed beside it at
    the probe's iterations, then the main path: the probe script's rates
    with the microbench counter zeroed before and read after, and
    utils/sol.py's three rates held to them."""
    import importlib.util

    from tinyraytracer_tpu_torch.utils import microbench as mb
    from tinyraytracer_tpu_torch.utils import probes, sol

    sass = microbench_sass()
    errs, ulps, rows = {}, {}, {}
    for mix in mb.MIXES:
        n = mb.wave(mix)
        x0 = mb.inputs(n, 1, "cuda")
        got = mb.microbench(mix, x0, SOL_TWIN_ITERS)
        again = mb.microbench(mix, x0, SOL_TWIN_ITERS)
        want = mb.microbench_reference(mix, x0, SOL_TWIN_ITERS)
        torch.cuda.synchronize()
        tol = SOL_ULP.get(mix, mb.TRANSC_ULP)
        ulps[mix] = _ulps(torch, got, want)
        errs[mix] = float((got - want).abs().max())
        same = bool(torch.equal(got, again))
        log(f"[sol] {mix} at {n} threads x {SOL_TWIN_ITERS} iterations: "
            f"kernel vs twin {ulps[mix]} ulps (allowed {tol}), max abs "
            f"{errs[mix]:.3g}, two launches bit for bit {same}")
        if ulps[mix] > tol or not same:
            raise RuntimeError(f"microbench {mix} disagrees with its twin or "
                               "is not deterministic")
        ms = time_kernel(torch, lambda: mb.microbench(mix, x0,
                                                      mb.PROBE_ITERS), 3)
        want, plain_ms = time_once(torch, lambda: mb.microbench_reference(
            mix, x0, mb.PROBE_ITERS))
        got = mb.microbench(mix, x0, mb.PROBE_ITERS)
        torch.cuda.synchronize()
        bound_ms, by = sol.microbench_bound(n, mb.PROBE_ITERS,
                                            mb.OPS_PER_ITER[mix])
        rows[mix] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=by, threads=n,
                         ulps=_ulps(torch, got, want),
                         max_abs_err=float((got - want).abs().max()))
        errs[mix] = max(errs[mix], rows[mix]["max_abs_err"])
        log(f"[sol] {mix} at {n} threads x {mb.PROBE_ITERS} iterations: "
            f"kernel {ms:.4f} ms, twin {plain_ms:.1f} ms, bound "
            f"{bound_ms:.4f} ms ({by}), kernel vs twin "
            f"{rows[mix]['ulps']} ulps")

    spec = importlib.util.spec_from_file_location(
        "torch_probe_vpu_microbench",
        os.path.join(ROOT, "scripts", "torch_probe_vpu_microbench.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    zero_launches(mb.microbench)
    line = probe.main()
    launches = n_launches(mb.microbench)
    for mix in mb.MIXES:
        log(f"[sol] {mix}: {line[f'{mix}_tops']:.4f} T counted ops/s "
            f"({line[f'{mix}_s']:.4f} s, {line[f'{mix}_iters']} iterations "
            f"x {line[f'{mix}_threads']} threads, SM clock "
            f"{line[f'{mix}_sm_clock_mhz']} MHz); on {card}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mix in mb.MIXES:
        clock = line[f"{mix}_sm_clock_mhz"]
        per = sass[mix]["fast"] / mb.UNROLL
        issue = probes.issue_bound_ms(per, rows[mix]["threads"]
                                      * mb.PROBE_ITERS, sms, clock)
        rows[mix]["issue_bound_ms"] = issue
        log(f"[sol] {mix}: {per:.2f} SASS instructions an iteration in the "
            f"loop off its slow-path calls; issue bound {issue:.4f} ms at "
            f"{mb.PROBE_ITERS} iterations ({sms} SMs x 128 lanes x {clock} "
            f"MHz) beside the kernel's "
            f"{rows[mix]['ms']:.4f} ms ({issue / rows[mix]['ms']:.1%}) and "
            f"the FP32 bound {rows[mix]['bound_ms']:.4f}; on {card}")
    log(f"[sol] microbench launches in the probe's run: {launches}")
    if launches != 5 * len(mb.MIXES):
        raise RuntimeError(f"the probe launched the microbench {launches} "
                           "times, not 5 a mix")
    held = {"CAND_COUNTED_OPS_PER_SEC": ("sphere",
                                         sol.CAND_COUNTED_OPS_PER_SEC),
            "QUAD_COUNTED_OPS_PER_SEC": ("quad",
                                         sol.QUAD_COUNTED_OPS_PER_SEC),
            "FIXED_COUNTED_OPS_PER_SEC": ("transcendental",
                                          sol.FIXED_COUNTED_OPS_PER_SEC)}
    bad = []
    for name, (mix, rate) in held.items():
        got = line[f"{mix}_tops"] * 1e12
        log(f"[sol] sol.{name} = {rate:.4g} against the {mix} mix's "
            f"{got:.4g} (ratio {rate / got:.4f}, allowed 1 +- {SOL_RTOL})")
        if abs(rate / got - 1.0) > SOL_RTOL:
            bad.append(name)
    if bad:
        raise RuntimeError(f"utils/sol.py's {bad} are more than "
                           f"{SOL_RTOL:.0%} from this card's measured mix")
    return dict(line=line, launches=launches, rows=rows, sass=sass,
                max_abs_err=max(errs.values()), ulps=ulps,
                sm_clock_mhz=line["sphere_sm_clock_mhz"])


# Phase 23: the layout probes P1-P4 (utils/probes.py, csrc/probe_*.cu).
# Each body at each of its probe's shapes, on the probe's inputs and
# seeded variants (P4: two seeds and the special-value tables): kernel
# against twin bit for bit (P2 A also within PROBE_TABLE_RTOL of the
# table's largest entry of the twin's order in turns, the fused kernels'
# gradient-table tier), two launches and GRID = 1 against the probe's
# GRID bit for bit; kernel timed at the probe's GRID beside its FP32 and
# issue bounds (P2 A: and its shared-traffic bound), the twin at one grid
# step; P2's, P3's and P4's registers, spills, blocks a SM and slow-path
# CALL sites. P3's kernels, shorter than their wrapper's host path, are
# also timed on the device alone (a CUDA graph of wrapper calls: its row's
# ms), beside its issue bound, the parent design's and C's gather-traffic
# bound. Then the four scripts with the counters zeroed, each launching
# its kernel PROBE_LAUNCHES times.
PROBE_TABLE_RTOL = 1e-5
PROBE_SEEDS = {"packgrad2": (3,), "sublanes": (1,)}   # P4: probes.P4_SEEDS
PROBE_LAUNCHES = {"packgrad": 8, "packgrad2": 8, "seglayout": 48,
                  "sublanes": 30}
PROBE_KERNELS = {"packgrad": ("scatter_kernel", "masked_kernel"),
                 "packgrad2": ("gather_kernel", "table_kernel"),
                 "seglayout": ("gather_kernel", "select_kernel"),
                 "sublanes": ("chain_kernel",)}
PROBE_REPLACES = {"packgrad": "scripts/probe_packgrad.py:71",
                  "packgrad2": "scripts/probe_packgrad2.py:77",
                  "seglayout": "scripts/probe_seglayout.py:154",
                  "sublanes": "scripts/probe_sublanes.py:23"}
PROBE_IDS = {"packgrad": "P2", "packgrad2": "P3", "seglayout": "P4",
             "sublanes": "P1"}
# Element-bounces a pass of a body's hot loop: P1's loop runs 4 steps,
# P3's 4 sublanes side by side (csrc/probe_packgrad2.cu kE).
PROBE_LOOP_ELEMENTS = {("sublanes", "chain"): 4, ("packgrad2", "C"): 4,
                       ("packgrad2", "D"): 4}
# P3's issue bounds at the probe's GRID before its redesign (25 and 48
# SASS instructions an element-bounce; 1 980 MHz, 132 SMs).
P3_PARENT_ISSUE_MS = {"C": 0.0251, "D": 0.0481}


def _probe_kernel(name):
    """(probe, kernel) of a probe kernel's mangled name, else None."""
    import re
    m = re.search(r"_probe_(packgrad2|packgrad|seglayout|sublanes)_cu_", name)
    k = re.search(r"(scatter|masked|gather|table|select|chain)_kernelE", name)
    return (m.group(1), k.group(1) + "_kernel") if m and k else None


def probe_sass():
    """Each probe kernel's loops in phase 2's listing: some back edge's
    body holds at least the operations OPS_PER_ELEMENT counts an element
    and bounce (times PROBE_LOOP_ELEMENTS: P1's loop runs 4 steps a
    pass, P3's 4 sublanes), in SASS_COUNTED
    opcodes (an FFMA twice), so nvcc hoisted or folded none of them. The
    smallest such loop is the kernel's hot loop: its instructions an
    element and bounce, less those of its slow-path call blocks (run only
    when a lane needs IEEE sqrt's or divide's slow path), give the issue
    bound. Also counts each kernel's CALL sites."""
    import re
    from collections import Counter

    from tinyraytracer_tpu_torch.utils import probes

    with open(os.path.join(ROOT, "output", "forward_sass.txt")) as f:
        sass = f.read()
    out = {}
    for part in sass.split("Function : ")[1:]:
        found = _probe_kernel(part.split()[0])
        if not found:
            continue
        probe, kernel = found
        body = probes.BODIES[probe][PROBE_KERNELS[probe].index(kernel)]
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
        addrs = [int(a, 16) for a, _ in ins]
        opcodes = [re.sub(r"^@!?P\d+\s+", "", y.strip()).split()[0]
                   .split(".")[0] for _, y in ins]
        per = PROBE_LOOP_ELEMENTS.get((probe, body), 1)
        want = probes.OPS_PER_ELEMENT[probe, body] * per
        target = [re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", x)
                  for _, x in ins]
        target = [int(t.group(1), 16) if t else None for t in target]
        slow = slow_call_blocks(ins, addrs, opcodes)
        best, hot = 0, None
        for i, t in enumerate(target):
            if t is None or t >= addrs[i]:
                continue
            a = addrs.index(t)
            ops = Counter(opcodes[a:i + 1])
            counted = sum(ops[k] * (2 if k == "FFMA" else 1)
                          for k in SASS_COUNTED)
            best = max(best, counted)
            n = i + 1 - a
            if counted >= want and (hot is None or n < hot[0]):
                hot = (n, n - sum(slow[a:i + 1]))
        calls = opcodes.count("CALL")
        log(f"[probes] SASS of {probe} {body} ({kernel}): {len(ins)} "
            f"instructions, the fullest loop holds {best} counted "
            f"operations (want >= {want}); the hot loop {hot and hot[0]} "
            f"instructions for {per} element-bounce(s), {hot and hot[1]} "
            f"off its slow-path calls; {calls} CALL sites (IEEE slow paths)")
        if best < want:
            raise RuntimeError(f"probe {probe} {body}: no loop holds the "
                               "operations the kernel counts")
        out[f"{probe} {body}"] = dict(
            instructions=len(ins), counted=best, want=want, calls=calls,
            loop=hot[0], loop_per_element=hot[1] / per)
    if len(out) != 7:
        raise RuntimeError(f"probe kernels in the SASS: {sorted(out)}")
    return out


def probe_ptxas():
    """Registers and spill bytes of each probe kernel in the build log:
    {(probe, kernel): (registers, stores, loads)}."""
    from tinyraytracer_tpu_torch import _build

    text = _build.library_path().with_suffix(".log").read_text()
    return {_probe_kernel(name): entry
            for name, entry in ptxas_entries(text).items()
            if _probe_kernel(name)}


def _probe_cases(torch, probes, dev):
    """(probe, body, shape, seed, launch(grid), twin()) for every body,
    shape and input the phase checks."""
    out = []
    for body in probes.BODIES["packgrad"]:
        out.append(("packgrad", body, probes.P2_SHAPE, None,
                    lambda g, b=body: probes.packgrad(b, dev, g),
                    lambda b=body: probes.packgrad_reference(b, dev)))
    for seed in (None, *PROBE_SEEDS["packgrad2"]):
        pay = probes.packgrad2_inputs(seed, dev)
        out.append(("packgrad2", "C", probes.P3_SHAPE, seed,
                    lambda g, p=pay: probes.packgrad2("C", p, grid=g),
                    lambda p=pay: probes.packgrad2_reference("C", p)))
    out.append(("packgrad2", "D", probes.P3_SHAPE, None,
                lambda g: probes.packgrad2("D", device=dev, grid=g),
                lambda: probes.packgrad2_reference("D", device=dev)))
    for seed in (None, *probes.P4_SEEDS):
        tab = probes.seglayout_inputs(seed, dev)
        for body, shapes in (("A", probes.P4_A_SHAPES),
                             ("B", probes.P4_B_SHAPES)):
            for shape in shapes:
                out.append((
                    "seglayout", body, shape, seed,
                    lambda g, b=body, s=shape, t=tab: probes.seglayout(
                        b, s, t, g),
                    lambda b=body, s=shape, t=tab:
                        probes.seglayout_reference(b, s, t)))
    for seed in (None, *PROBE_SEEDS["sublanes"]):
        for shape in probes.P1_SHAPES:
            x = probes.sublanes_inputs(shape, seed, dev)
            out.append(("sublanes", "chain", shape, seed,
                        lambda g, x=x: probes.sublanes(x, g),
                        lambda x=x: probes.sublanes_reference(x)))
    return out


def probes_phase(torch, card, clock_mhz=None):
    """Phase 23: the layout probes against their twins, then the main
    path: the four scripts/torch_probe_*.py with their launch counters
    zeroed before and read after. `clock_mhz`: the SM clock phase 22
    read under load, for the issue bounds (read here if None)."""
    import importlib.util

    from tinyraytracer_tpu_torch.utils import microbench, probes

    sass = probe_sass()
    dev = torch.device("cuda")
    if clock_mhz is None:     # read while a few P4 launches run
        tab = probes.seglayout_inputs(None, dev)
        for _ in range(8):
            probes.seglayout("B", probes.P4_B_SHAPES[-1], tab)
        clock_mhz = microbench.sm_clock_mhz(dev)
        torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs = probe_ptxas()
    info = {}
    for probe in ("seglayout", "packgrad", "packgrad2"):
        for body, kernel in zip(probes.BODIES[probe], PROBE_KERNELS[probe]):
            k = probes.kernel_info(probe, body, dev)
            r, st, ld = regs[probe, kernel]
            info[f"{probe} {body}"] = dict(k, ptxas_registers=r,
                                           spill_stores=st, spill_loads=ld,
                                           calls=sass[f"{probe} {body}"][
                                               "calls"])
            log(f"[probes] {PROBE_IDS[probe]} {probe} {body} ({kernel}): "
                f"{r} registers (ptxas; {k['registers']} by the runtime), "
                f"spills {st} B stored, {ld} B loaded, {k['blocks_per_sm']} "
                f"blocks of 256 a SM, {info[f'{probe} {body}']['calls']} "
                f"slow-path CALL sites; on {card}")
    grids = {"packgrad": probes.P2_GRID, "packgrad2": probes.P3_GRID,
             "seglayout": probes.P4_GRID, "sublanes": probes.P1_GRID}
    rows = {p: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ms_grid1=0.0,
                    max_abs_err=0.0, by=set(), cases=0) for p in grids}
    nan, seg_ms, issue, p3 = {}, {}, {}, {}
    for probe, body, shape, seed, launch, twin in _probe_cases(torch, probes,
                                                                dev):
        grid = grids[probe]
        got, again, one = launch(grid), launch(grid), launch(1)
        want, plain_ms = time_once(torch, twin)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ulps = _ulps(torch, got, want)
        ok = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        if (probe, body) == ("packgrad", "A"):
            turns = probes.packgrad_reference("A", dev, turns=True)
            rel = float((got - turns).abs().max() / turns.abs().max())
            log(f"[probes] P2 A against the twin's order in turns: "
                f"{rel:.3g} of the table's largest entry (allowed "
                f"{PROBE_TABLE_RTOL})")
            ok = ok and rel <= PROBE_TABLE_RTOL
        same = bool(torch.equal(got.view(torch.int32),
                                again.view(torch.int32)))
        grid1 = bool(torch.equal(got.view(torch.int32),
                                 one.view(torch.int32)))
        ms = time_kernel(torch, lambda: launch(grid), 2)
        ms1 = time_kernel(torch, lambda: launch(1), 2)
        bound_ms, by = probes.bound(probe, body, shape, grid)
        issue_ms = probes.issue_bound_ms(
            sass[f"{probe} {body}"]["loop_per_element"],
            probes.element_bounces(probe, shape, grid), sms, clock_mhz)
        extra = ""
        if (probe, body) == ("packgrad", "A"):
            smem_ms = probes.shared_bound_ms(probes.shared_bytes(grid), sms,
                                             clock_mhz)
            extra = f", shared-traffic bound {smem_ms:.4f} ms"
        label = (f"{PROBE_IDS[probe]} {probe} {body} {tuple(shape)} "
                 f"{'probe inputs' if seed is None else f'seed {seed}'}")
        log(f"[probes] {label}: kernel vs twin {ulps} ulps, max abs "
            f"{err:.3g}, two launches bit for bit {same}, GRID 1 = GRID "
            f"{grid} {grid1}; kernel {ms:.4f} ms at GRID {grid} ({ms1:.4f}"
            f" at 1), twin {plain_ms:.1f} ms at one step, bound "
            f"{bound_ms:.4f} ms ({by}), issue bound {issue_ms:.4f} ms "
            f"({sass[f'{probe} {body}']['loop_per_element']:g} SASS "
            f"instructions an element-bounce, {sms} SMs x 128 lanes x "
            f"{clock_mhz} MHz){extra}; on {card}")
        if not (ok and same and grid1):
            raise RuntimeError(f"{label}: the kernel disagrees with its twin "
                               "or is not deterministic")
        if probe == "seglayout":
            seg_ms[body, tuple(shape), str(seed)] = ms
        if probe == "packgrad2" and seed is None:
            p3[body] = p3_device_times(probes, body, launch, grid, ms, ms1,
                                       bound_ms, issue_ms, sms, clock_mhz,
                                       card)
        if seed is None:
            issue[f"{probe} {body} {tuple(shape)}"] = dict(
                ms=ms, bound_ms=bound_ms, issue_bound_ms=issue_ms)
            r = rows[probe]
            if probe == "packgrad2":
                r["ms_with_launch"] = r.get("ms_with_launch", 0.0) + ms
                ms, ms1 = p3[body]["device_ms"], p3[body]["device_ms_grid1"]
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bound_ms"] += bound_ms
            r["ms_grid1"] += ms1
            r["by"].add(by)
            r["cases"] += 1
        rows[probe]["max_abs_err"] = max(rows[probe]["max_abs_err"], err)
    for seed in (None, *probes.P4_SEEDS):
        st = {}
        probes.seglayout_reference("A", probes.P4_A_SHAPES[0],
                                   probes.seglayout_inputs(seed, dev),
                                   stats=st)
        ns = st["nan_segments"].float()
        nan[str(seed)] = dict(mean=float(ns.mean()), min=int(ns.min()),
                              max=int(ns.max()), hits=st["hits"][:8],
                              disc=st["disc"])
        log(f"[probes] P4 A (1, 1024), "
            f"{'probe inputs' if seed is None else f'seed {seed}'}: "
            f"segments starting on a NaN state a ray: mean "
            f"{nan[str(seed)]['mean']:.2f}, min {nan[str(seed)]['min']}, "
            f"max {nan[str(seed)]['max']} of {probes.P4_SEGMENTS}; rays "
            f"hitting in segments 1-8: {st['hits'][:8]}; discriminants "
            f"{st['disc']}")
    counters = {"packgrad": probes.packgrad, "packgrad2": probes.packgrad2,
                "seglayout": probes.seglayout, "sublanes": probes.sublanes}
    lines, launches = {}, {}
    for probe, fn in counters.items():
        spec = importlib.util.spec_from_file_location(
            f"torch_probe_{probe}",
            os.path.join(ROOT, "scripts", f"torch_probe_{probe}.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        for f in counters.values():
            zero_launches(f)
        lines[probe] = script.main()
        launches[probe] = n_launches(fn)
        others = {p: n_launches(f) for p, f in counters.items()
                  if p != probe}
        log(f"[probes] scripts/torch_probe_{probe}.py: {n_launches(fn)} "
            f"launches (want {PROBE_LAUNCHES[probe]}), the other probes' "
            f"{others}; on {card}")
        if n_launches(fn) != PROBE_LAUNCHES[probe] or any(others.values()):
            raise RuntimeError(f"torch_probe_{probe}.py launched its kernel "
                               f"{n_launches(fn)} times")
    for (body, shape, seed), ms in seg_ms.items():
        if seed == str(probes.P4_SEED_LIVE):
            ratio = seg_ms[body, shape, "None"] / ms
            nan[f"ratio {body} {shape}"] = ratio
            log(f"[probes] P4 {body} {shape}: the probe's inputs (NaN from "
                f"segment 2 or 3) take {ratio:.3f}x the time of seed "
                f"{seed}'s (no NaN state); on {card}")
    for r in rows.values():
        r["by"] = "/".join(sorted(r["by"]))
    return dict(rows=rows, launches=launches, lines=lines, sass=sass,
                nan=nan, seglayout_ms={" ".join(map(str, k)): v
                                       for k, v in seg_ms.items()},
                info=info, issue=issue, p3=p3, sm_clock_mhz=clock_mhz)


def p3_device_times(probes, body, launch, grid, ms, ms1, bound_ms, issue_ms,
                    sms, clock_mhz, card):
    """P3 `body` on the device alone (probes.graph_ms) at the probe's GRID
    and at 1, beside the events-around-two-launches times `ms`, `ms1`,
    its FP32 and issue bounds, the parent design's issue bound and (C)
    the bound of its gathers' shared-memory traffic."""
    dev_ms = probes.graph_ms(lambda: launch(grid))
    dev_ms1 = probes.graph_ms(lambda: launch(1))
    out = dict(device_ms=dev_ms, device_ms_grid1=dev_ms1, ms_with_launch=ms,
               ms_with_launch_grid1=ms1, bound_ms=bound_ms,
               issue_bound_ms=issue_ms,
               parent_issue_bound_ms=P3_PARENT_ISSUE_MS[body],
               issue_share=issue_ms / dev_ms)
    extra = ""
    if body == "C":
        out["gather_bound_ms"] = probes.shared_bound_ms(
            probes.gather_bytes(grid), sms, clock_mhz)
        out["gather_share"] = out["gather_bound_ms"] / dev_ms
        extra = (f", its gathers' shared-memory bound "
                 f"{out['gather_bound_ms']:.4f} ms "
                 f"({out['gather_share']:.1%})")
    log(f"[probes] P3 packgrad2 {body} on the device alone (a CUDA graph of "
        f"20 launches): {dev_ms:.4f} ms at GRID {grid}, {dev_ms1:.4f} at 1 "
        f"(events around two wrapper launches: {ms:.4f}, {ms1:.4f}); issue "
        f"bound {issue_ms:.4f} ms ({out['issue_share']:.1%} of it reached; "
        f"the parent design's {P3_PARENT_ISSUE_MS[body]}), FP32 bound "
        f"{bound_ms:.4f} ms{extra}; on {card}")
    return out


PHASES = ("forward", "k3", "train", "cfg5", "modular", "k5", "fused",
          "cfg5f", "k4", "cfg4f", "mesh", "bvh", "examples", "bench", "sol",
          "probes")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phase groups to run: forward "
                    "(phases 3-7), k3 (8), train (9), cfg5 (10), modular "
                    "(11), k5 (12), fused (13), cfg5f (14), k4 (15), "
                    "cfg4f (16-17), mesh (18), bvh (19), examples (20), "
                    "bench (21), sol (22), probes (23); the result lines "
                    "need the default set")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    import numpy as np
    import torch

    card = env_phase(torch)
    from tinyraytracer_tpu_torch import Image, Renderer, _build
    from tinyraytracer_tpu_torch.diff import inverse
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

    t_start = t_lap = time.perf_counter()

    def lap(group):
        nonlocal t_lap
        now = time.perf_counter()
        log(f"[lap] {group}: {now - t_lap:.1f} s")
        t_lap = now

    build_phase(_build)
    sass = sass_phase(_build)
    lap("build")
    results = {}
    if "forward" in only:
        worst = parity_phase(torch, np, presets, mk, mkp, _build.load())
        media_phase(torch, mk)
        launches, results, fbs = main_path_phase(torch, np, presets, mk,
                                                 mkp, Renderer, card)
        results["rtnw_final"] = rtnw_main_path(torch, np, mk, Image,
                                               Renderer, card)
        breakdown_phase(torch, np, presets, mk, Renderer, card, results)
        results["gamma"] = gamma_phase(torch, np, _build.load(), card, fbs)
        del fbs
        for k, v in kernel_vs_twin_phase(torch, np, presets, mk, mkp, card,
                                         results, _build.load()).items():
            worst[k] = max(worst[k], v)
        results["sass"] = sass
        api_phase(torch, np, presets, Renderer)
        lap("forward")
    if "k3" in only:
        results["k3"] = k3_phase(torch, presets, ik, trace_ops,
                                 generate_rays, card)
        lap("k3")
    if "train" in only:
        train_phase(torch, presets, ik, inverse, Renderer, card)
        lap("train")
    if "cfg5" in only:
        results["cfg5"] = cfg5_phase(torch, presets, ik, inverse, trace_ops,
                                     Renderer, card)
        lap("cfg5")
    if "modular" in only:
        modular_render_phase(torch, np, presets, Renderer, card)
        lap("modular")
    if "k5" in only:
        results["k5"] = k5_phase(torch, np, presets, dkp, card)
        lap("k5")
    if "fused" in only:
        fused_phase(torch, presets, ik, dk, dkp, inverse, Renderer, card)
        lap("fused")
    if "cfg5f" in only:
        results["cfg5f"] = cfg5_fused_phase(torch, presets, dk, dkp, inverse,
                                            Renderer, card)
        lap("cfg5f")
    if "k4" in only:
        results["k4"] = k4_phase(torch, np, presets, dk, dkp, card)
        lap("k4")
    if "cfg4f" in only:
        results["cfg4f"] = cfg4f_phase(torch, presets, ik, mk, mkp, dk, dkp,
                                       inverse, card)
        results["route"] = routing_phase(torch, presets, ik, mk, mkp, dk,
                                         dkp, inverse, card)
        lap("cfg4f")
    if "mesh" in only:
        mesh_twin_checks(torch, presets, mk, mkp, sharded, _build.load())
        results["mesh"] = mesh_phase(torch, presets, ik, mk, mkp, dk, dkp,
                                     inverse, sharded, Renderer, card)
        lap("mesh")
    if "bvh" in only:
        results["bvh"] = bvh_phase(torch, np, presets, ik, mk, mkp, dk, dkp,
                                   bvh_ops, trace_ops, generate_rays,
                                   Renderer, card)
        lap("bvh")
    if "examples" in only:
        results["examples"] = examples_phase(torch, presets, ik, mk, mkp, dk,
                                             dkp, inverse, trace_ops,
                                             generate_rays, card)
        lap("examples")
    if "bench" in only:
        results["bench"] = bench_phase(torch, presets, ik, mk, mkp, dk, dkp,
                                       inverse, card, results.get("cfg5f"))
        lap("bench")
    if "sol" in only:
        results["sol"] = sol_phase(torch, card)
        lap("sol")
    if "probes" in only:
        results["probes"] = probes_phase(
            torch, card, results.get("sol", {}).get("sm_clock_mhz"))
        lap("probes")
    os.makedirs(os.path.join(ROOT, "output"), exist_ok=True)
    with open(os.path.join(ROOT, "output", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, results=results), f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the "
        "environment check")
    if set(only) != set(PHASES):
        return 0

    mesh = results["mesh"]["launches"]
    ex = results["examples"]["launches"]
    ex_err = results["examples"]["max_abs_err"]
    bench = results["bench"]["launches"]

    def entry(kid, name, source, replaces, cfg):
        res = results[cfg]
        return {
            "name": name, "route": "cuda",
            "source": f"tinyraytracer_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[kid] + mesh[kid] + ex[kid] + bench[kid],
            "max_abs_err": worst[kid], "ms": res["kernel_ms"],
            "plain_ms": res["twin_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            "config": cfg, "plain_shape": res["twin_shape"],
            "ms_at_plain_shape": res["kernel_ms_at_twin_shape"],
        }

    k3, k4, k5 = results["k3"], results["k4"], results["k5"]
    g1 = results["gamma"]["cfg3"]
    mbr = results["sol"]["rows"]

    def probe_entry(probe):
        r = results["probes"]["rows"][probe]
        return {
            "name": f"probe_{probe}", "route": "cuda",
            "source": f"tinyraytracer_tpu_torch/csrc/probe_{probe}.cu",
            "replaces": PROBE_REPLACES[probe],
            "launches": results["probes"]["launches"][probe],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["by"], "library_ms": None, "config": "probes",
            "plain_shape": f"one grid step of each of the {r['cases']} "
                           "bodies and shapes",
            "ms_at_plain_shape": r["ms_grid1"],
            **({"ms_with_launch": r["ms_with_launch"]}
               if "ms_with_launch" in r else {}),
        }
    print(json.dumps({"kernels": [
        entry("K1", "megakernel_packed", "megakernel_packed.cu",
              "tinyraytracer_tpu/ops/megakernel_packed.py:125", "cfg3"),
        entry("K2", "megakernel_flat", "megakernel.cu",
              "tinyraytracer_tpu/ops/megakernel.py:489", "cfg4"),
        {"name": "gamma", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/gamma.cu",
         "replaces": "tinyraytracer_tpu/utils/image.py:27",
         "launches": launches["G1"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in results["gamma"].values()),
         "ms": g1["ms"], "plain_ms": g1["plain_ms"],
         "bound_ms": g1["bound_ms"], "bound_by": "bytes",
         "library_ms": g1["library_ms"], "config": "cfg3",
         "plain_shape": "600x600x3, the kernel's own",
         "ms_at_plain_shape": g1["ms"]},
        {"name": "closest_hit", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/closest_hit.cu",
         "replaces": "tinyraytracer_tpu/ops/intersect_pallas.py:166",
         "launches": results["cfg5"]["launches"]["K3"] + mesh["K3"]
         + ex["K3"] + bench["K3"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None, "config": "cfg5",
         "plain_shape": f"{k3['rays']} rays",
         "ms_at_plain_shape": k3["ms"],
         "ms_launch_weighted": k3["ms_launch_weighted"]},
        {"name": "diffkernel_packed", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/diffkernel_packed.cu",
         "replaces": "tinyraytracer_tpu/ops/diffkernel_packed.py:240",
         "launches": results["cfg5f"]["launches"]["K5"] + mesh["K5"]
         + ex["K5"] + bench["K5"],
         "max_abs_err": max(k5["max_abs_err"], ex_err["K5"],
                            results["bench"]["max_abs_err"]),
         "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": None, "config": "cfg5f",
         "plain_shape": k5["plain_shape"],
         "ms_at_plain_shape": k5["ms_at_plain_shape"]},
        {"name": "diffkernel", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/diffkernel.cu",
         "replaces": "tinyraytracer_tpu/ops/diffkernel.py:357",
         "launches": results["cfg4f"]["cfg4class"]["launches"]["K4"]
         + mesh["K4"] + ex["K4"] + bench["K4"],
         "max_abs_err": max(k4["max_abs_err"], ex_err["K4"]),
         "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "config": "cfg4class", "plain_shape": k4["plain_shape"],
         "ms_at_plain_shape": k4["ms_at_plain_shape"]},
        {"name": "microbench", "route": "cuda",
         "source": "tinyraytracer_tpu_torch/csrc/microbench.cu",
         "replaces": "scripts/probe_vpu_microbench.py:40",
         "launches": results["sol"]["launches"],
         "max_abs_err": results["sol"]["max_abs_err"],
         "ms": sum(r["ms"] for r in mbr.values()),
         "plain_ms": sum(r["plain_ms"] for r in mbr.values()),
         "bound_ms": sum(r["bound_ms"] for r in mbr.values()),
         "bound_by": mbr["sphere"]["bound_by"], "library_ms": None,
         "config": "sol",
         "plain_shape": "the five mixes, one wave x 2000 iterations each",
         "ms_at_plain_shape": sum(r["ms"] for r in mbr.values())},
        *(probe_entry(p) for p in ("sublanes", "packgrad", "packgrad2",
                                   "seglayout")),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
