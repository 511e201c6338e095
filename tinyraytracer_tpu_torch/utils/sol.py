"""Speed-of-light (roofline) model of the CUDA kernels on an NVIDIA H100.

The counterpart of the JAX package's utils/sol.py, with the card's model:
the same public names (`ops_per_camera_ray`, `pct_of_sol`,
`ops_per_camera_ray_diff`, `pct_of_sol_diff`, `mean_executed_bounces`),
FP32 operations counted off the CUDA sources in place of the TPU's VPU
ops, and the H100's published peaks in place of the TPU's. The kernel
bounds of chip_smoke.py (`bound`, `k3_bound`, `k5_bound`, `k4_bound`)
are built from the same counts, so one definition of the work serves both.

Counting rule: every add, subtract, multiply, divide, compare, min/max,
sqrt and libm call counts one FP32 operation, read off csrc/ as it is
built (`--fmad=false`: no multiply-add is fused). An IEEE divide, sqrt
or libm call takes several instructions, so every bound here is
optimistic. Rows are the scene's real rows, never the padded ones: the
kernels test real rows only.

**These counts are the model of the work, not a description of one
build.** A later kernel that computes the same function in fewer
instructions does not edit them; that is what keeps a share taken after
a redesign comparable with one taken before it.

A share is work over time against a published peak: the H100 SXM data
sheet's 67e12 FP32 operations a second outside the tensor cores and
3.35e12 bytes a second of HBM, at the full 700 W power limit. Print every
share beside the card's name and power limit (`nvidia-smi
--query-gpu=name,power.limit`); a card set below 700 W runs slower under
load. A share above 1.0 means the count is wrong (a padded row, a
double-counted shadow ray), not that the kernel is fast, and `pct_*`
raise on one.

`pct_of_sol_measured` sets the forward rate against the card's measured
mix instead of the data sheet: counted operations cost what
csrc/microbench.cu (utils/microbench.py) measured them to sustain: the
sphere rows at the sphere-row mix's rate, the quad rows at the quad-row
mix's, and the per-ray and per-segment work at the transcendental mix's. With `--fmad=false` no
multiply-add fuses, so in these units the FP32 peak is out of reach.

Not ported: the JAX module's `QUAD_BOUNDARY_OPS_PER_ROW`, fitted to a TPU
measurement: the quad surrogates are counted from csrc/diff_common.cuh
here.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, 700 W).
FP32_PEAK = 67e12        # FP32 operations a second, outside the tensor cores
HBM_BYTES_S = 3.35e12    # HBM bytes a second

# The measured-mix ceiling: counted operations a second that one full
# wave of the card sustains on the sphere candidate row (sphere_hit_t and
# the running-minimum compare), on the quad candidate row (quad_hit_t and
# the compare) and on the transcendental-leaning shade mix (1/sqrt, IEEE
# divide, expf/logf), as scripts/torch_probe_vpu_microbench.py measured
# them on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, SM clock
# 1980 MHz under the load (PERF.md section 6); chip_smoke.py phase 22
# fails when a card measures any of them more than 15 % away.
CAND_COUNTED_OPS_PER_SEC = 20.31e12     # 20.3088 T: 24 ops in ~40 issues
QUAD_COUNTED_OPS_PER_SEC = 24.48e12     # 24.4794 T: 45 ops in ~60 issues
FIXED_COUNTED_OPS_PER_SEC = 5.107e12    # 5.1071 T: 13 ops in ~85 issues

# K1/K2 (csrc/common.cuh, csrc/megakernel.cu): FP32 operations per unit.
OPS_SPHERE_ROW = 24      # sphere_hit_t + the running-minimum compare
OPS_QUAD_ROW = 45        # quad_hit_t + the running-minimum compare
OPS_AABB = 25            # one block's slab test (megakernel.cu)
OPS_CULL_SEGMENT = 6     # the slab test's three guarded reciprocals
OPS_SHADE_BASE = 108     # shade_bounce without metal or dielectric lobes
OPS_REFLECT = 14         # the shared reflection (metal or dielectric)
OPS_METAL = 7            # fuzz and the kind select
OPS_DIELECTRIC = 49      # Schlick, refraction and the kind select
OPS_CAMERA = 62          # camera_ray and the per-sample fold

# K3 (csrc/closest_hit.cu): operations per real row (sphere_t / quad_t
# plus the running-minimum compare) and bytes per ray (origin and
# direction in, t and j out).
OPS_K3_SPHERE_ROW = 29
OPS_K3_QUAD_ROW = 49
K3_BYTES_PER_RAY = 32

# K5 (csrc/diffkernel_packed.cu on csrc/diff_common.cuh): operations per
# live bounce, closest-hit rows as K1's (the same common.cuh tests):
# `shade` 235 without metal or dielectric (the intersection math, 113; the
# light sample, 67; the scatter, 55), colour 40, state update 29, the
# shadow test 2 besides its closest hit; the adjoint besides its own
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
# K4 (csrc/diffkernel.cu) runs K5's estimator, so the same counts hold,
# with two more: the light sample inside OPS_K5_SHADE (skipped in a scene
# without lights, as is the shadow ray), and a surrogate sphere's
# silhouette alone (bounce_adj's A1 loop: all a sphere costs when no
# light makes soft shadows).
OPS_K5_LIGHT = 67
OPS_K4_SPH_SIL = 88


def _share(achieved_ops_s: float, what: str) -> float:
    share = achieved_ops_s / FP32_PEAK
    if not share > 0.0 or share > 1.0:
        raise ValueError(f"{what}: share of the FP32 peak {share!r} is "
                         "outside (0, 1]: the operation count is wrong")
    return share


def _bound(ops: float, nbytes: float) -> tuple:
    """(ms, "operations" or "bytes"): the larger of ops over the FP32 peak
    and bytes over HBM's rate."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# --- forward kernels K1 and K2 ---------------------------------------------

def shade_ops(has_met: bool, has_die: bool) -> int:
    """Operations of one shade_bounce (csrc/common.cuh) with the lobes the
    scene's materials compile in."""
    ops = OPS_SHADE_BASE
    if has_met or has_die:
        ops += OPS_REFLECT
    if has_met:
        ops += OPS_METAL
    if has_die:
        ops += OPS_DIELECTRIC
    return ops


def segment_ops(n_sph: int, n_quad: int, has_met: bool = False,
                has_die: bool = False) -> int:
    """Operations of one bounce segment of K1/K2: every real row's test,
    then the shade."""
    return (n_sph * OPS_SPHERE_ROW + n_quad * OPS_QUAD_ROW
            + shade_ops(has_met, has_die))


def culled_segment_ops(n_aabbs: int, rows_per_segment: float,
                       has_met: bool = False, has_die: bool = False) -> float:
    """Operations of one K2 segment under the block cull: the slab test of
    every block, then the sphere rows of the blocks the ray enters."""
    return (OPS_CULL_SEGMENT + n_aabbs * OPS_AABB
            + rows_per_segment * OPS_SPHERE_ROW + shade_ops(has_met, has_die))


def bound(camera_rays, segments, per_segment, out_bytes, in_bytes):
    """Least time (ms) for a forward kernel's work: the larger of
    operations over the FP32 peak and bytes (inputs once, output once)
    over HBM's rate. Returns (ms, what bounds it, operations)."""
    ops = camera_rays * OPS_CAMERA + segments * per_segment
    return (*_bound(ops, out_bytes + in_bytes), ops)


def ops_per_camera_ray(n_sph_rows: int, n_quad_rows: int,
                       bounces_executed: float, *, has_met: bool = False,
                       has_die: bool = False) -> float:
    """Operations one camera ray costs in K1/K2 (the dense walk): the
    camera ray and `bounces_executed` segments over the real rows."""
    return OPS_CAMERA + bounces_executed * segment_ops(
        n_sph_rows, n_quad_rows, has_met, has_die)


def pct_of_sol(rays_per_sec: float, n_sph_rows: int, n_quad_rows: int,
               bounces_executed: float, *, has_met: bool = False,
               has_die: bool = False) -> float:
    """Fraction of the FP32 peak the measured forward rate achieves.

    The kernels regenerate samples per lane (csrc/common.cuh), so lanes
    stop paying for dead bounces: `bounces_executed` must be the mean
    executed segments per camera ray (`mean_executed_bounces`), not the
    bounce budget, which would credit the kernel for work it skipped.
    """
    return _share(rays_per_sec * ops_per_camera_ray(
        n_sph_rows, n_quad_rows, bounces_executed, has_met=has_met,
        has_die=has_die), "forward")


def pct_of_sol_measured(rays_per_sec: float, n_sph_rows: int,
                        n_quad_rows: int, bounces_executed: float, *,
                        has_met: bool = False,
                        has_die: bool = False) -> float:
    """Fraction of the measured-mix ceiling the forward rate achieves
    (the JAX module's model, with the quad rows at a rate of their own):
    over `bounces_executed` segments, the sphere rows' operations at
    CAND_COUNTED_OPS_PER_SEC and the quad rows' at
    QUAD_COUNTED_OPS_PER_SEC; the camera ray's and the segments' shading
    at FIXED_COUNTED_OPS_PER_SEC. Raises on a share outside (0, 1]."""
    sph = bounces_executed * n_sph_rows * OPS_SPHERE_ROW
    quad = bounces_executed * n_quad_rows * OPS_QUAD_ROW
    fixed = OPS_CAMERA + bounces_executed * shade_ops(has_met, has_die)
    share = rays_per_sec * (sph / CAND_COUNTED_OPS_PER_SEC
                            + quad / QUAD_COUNTED_OPS_PER_SEC
                            + fixed / FIXED_COUNTED_OPS_PER_SEC)
    if not share > 0.0 or share > 1.0:
        raise ValueError(f"forward: share of the measured-mix ceiling "
                         f"{share!r} is outside (0, 1]: the operation "
                         "count is wrong")
    return share


# --- the microbenchmark P5 ---------------------------------------------------

def microbench_bound(threads: int, iters: int, ops_per_iter: int) -> tuple:
    """Least time (ms) of one csrc/microbench.cu launch and what bounds
    it: its counted operations over the FP32 peak, a float in and one out
    a thread over HBM's rate."""
    return _bound(threads * iters * ops_per_iter, 8 * threads)


# --- closest hit K3 ----------------------------------------------------------

def k3_bound(rays: int, n_sph: int, n_quad: int) -> tuple:
    """Least time (ms) of one K3 launch over `rays` rays and the real
    rows, what bounds it, and its operations."""
    ops = rays * (n_sph * OPS_K3_SPHERE_ROW + n_quad * OPS_K3_QUAD_ROW)
    return (*_bound(ops, rays * K3_BYTES_PER_RAY), ops)


# --- fused differentiable kernels K5 and K4 --------------------------------

def _k5_stages(n_sph, n_quad, has_met, has_die, n_surr_sph, n_surr_quad):
    """K5's operations per live bounce by stage: (phase 1: trace, shade,
    shadow, advance, colour; the replay: phase 1 without the colour; the
    replay with an intersection cache: shade and advance only; the
    adjoint: re-shade, adjoint chains, surrogates)."""
    rows = n_sph * OPS_SPHERE_ROW + n_quad * OPS_QUAD_ROW
    shade = OPS_K5_SHADE + (shade_ops(has_met, has_die)
                            - shade_ops(False, False))
    fwd = 2 * rows + shade + OPS_K5_SHADOW + OPS_K5_ADVANCE
    adjoint = (shade + OPS_K5_ADJ + n_surr_sph * OPS_K5_SPH_SURR
               + n_surr_quad * OPS_K5_QUAD_SURR)
    return fwd + OPS_K5_COLOR, fwd, shade + OPS_K5_ADVANCE, adjoint


def _spec_stages(spec):
    return _k5_stages(spec.n_sph, spec.n_quad, spec.has_met, spec.has_die,
                      len(spec.surr_s), len(spec.surr_q))


def per_seg_split(spec):
    """Operations per live bounce of K5's phase 1 (trace, shade, shadow,
    colour, advance) and of its phase 3 (replay and adjoint), as k5_bound
    counts them; `spec` is a diffkernel_packed.PackedSpec."""
    phase1, replay, _, adjoint = _spec_stages(spec)
    return phase1, replay + adjoint


def k5_bound(spec, pixels, spp, segments):
    """Least time (ms) of one K5 call over `segments` live bounces, what
    bounds it, its operations and its operations per live bounce."""
    phase1, replay, _, adjoint = _spec_stages(spec)
    per_seg = phase1 + replay + adjoint
    ops = 2 * pixels * spp * OPS_CAMERA + segments * per_seg
    return (*_bound(ops, pixels * K5_BYTES_PER_PIXEL), ops, per_seg)


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
    return (*_bound(ops, pixels * K5_BYTES_PER_PIXEL), ops, per_seg)


def ops_per_camera_ray_diff(n_sph_rows: int, n_quad_rows: int,
                            max_bounces: int, *,
                            fwd_bounces: float | None = None,
                            cached_replay: bool = False,
                            has_met: bool = False,
                            has_die: bool = False) -> float:
    """Operations one camera sample costs in the fused train step (K5):
    two camera rays (phase 1 and the replay), phase 1 over `fwd_bounces`
    bounces, the replay and the adjoint over `max_bounces`.

    The same reckoning of the step's work as the JAX package's
    ops_per_camera_ray_diff: phase 1 at `fwd_bounces` (the budget by
    default; the measured mean for a regenerating phase 1), the replay and
    adjoint at the full budget; `cached_replay` charges a replay that
    reads phase 1's hits (shade and advance only, no re-trace). Every
    real row runs its boundary surrogates (the all-fields scope, every
    field trainable, as bench.py's two Cornell steps with a share).
    """
    if fwd_bounces is None:
        fwd_bounces = float(max_bounces)
    phase1, replay, replay_cached, adjoint = _k5_stages(
        n_sph_rows, n_quad_rows, has_met, has_die, n_sph_rows, n_quad_rows)
    if cached_replay:
        replay = replay_cached
    return (2 * OPS_CAMERA + fwd_bounces * phase1
            + max_bounces * (replay + adjoint))


def pct_of_sol_diff(rays_per_sec: float, n_sph_rows: int, n_quad_rows: int,
                    max_bounces: int, **kw) -> float:
    """Fraction of the FP32 peak the fused fwd+bwd step achieves, for the
    work `ops_per_camera_ray_diff(..., **kw)` reckons."""
    return _share(rays_per_sec * ops_per_camera_ray_diff(
        n_sph_rows, n_quad_rows, max_bounces, **kw), "fused step")


# --- the executed-bounce estimate -------------------------------------------

def mean_executed_bounces(scene, camera, *, max_bounces: int, background,
                          spp: int = 2, seed: int = 0,
                          device="cuda") -> float:
    """Empirical mean bounce segments per camera ray for this scene.

    Traces a low-spp wavefront with the modular path (ops/trace.py,
    count_alive=True; closest hits by K3 on a CUDA device, its twin on
    the CPU) and integrates the survival curve: executed segments = 1
    (the guaranteed first bounce) + sum_b alive_after(b). The path-length
    distribution is camera and scene geometry, independent of resolution
    to first order, so a cheap low-spp estimate serves the roofline of
    any render size of the same scene.
    """
    import torch

    from tinyraytracer_tpu_torch.models.camera import generate_rays
    from tinyraytracer_tpu_torch.ops import intersect_kernel
    from tinyraytracer_tpu_torch.ops.trace import trace
    from tinyraytracer_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    compact = intersect_kernel.compact_rows(scene, dev)
    npix = camera.width * camera.height
    pid = torch.arange(npix, dtype=torch.int64, device=dev)
    alive_total = 0.0
    with torch.no_grad():
        for s in range(spp):
            o, d = generate_rays(camera, pid, s, seed)
            _, alive_counts = trace(
                scene, o, d, pid, s, seed, max_bounces=max_bounces,
                background=background, compact=compact, count_alive=True)
            # alive_after(max_bounces-1) rays execute no further segment.
            alive_total += float(alive_counts[:-1].sum())
    return 1.0 + alive_total / (npix * spp)


# --- the layout probes P1-P4 -------------------------------------------------

def probe_bound(ops: float, nbytes: float) -> tuple:
    """Least time (ms) of one launch of a layout probe's kernel
    (csrc/probe_*.cu; utils/probes.py counts its operations and bytes)
    and what bounds it."""
    return _bound(ops, nbytes)
