"""The work of a render and of a training step, counted in FP32
operations: the benchmark's frozen copy of the counting rules.

Counting rule: every add, subtract, multiply, divide, compare, min/max,
sqrt and libm call counts one FP32 operation, as the system's CUDA
sources (csrc/common.cuh, csrc/diff_common.cuh) computed the estimator
when these counts were read off them, with no multiply-add fused. Rows
are the scene's real rows. The counts are the model of the work, not a
description of one build: a later kernel that computes the same function
in fewer instructions, or skips rows by an acceleration structure, is
charged the same, so a share taken after a redesign stays comparable.
That is also why no share is given here for a walk whose rows depend on
an acceleration structure (the dense K2 and K4 walks): a count that
charges every row would read above 100 % once a structure skips rows.

The segments a camera ray executes are counted by the reference
(perfbench/reference/) on the inputs it compares, never taken from the
system: the work charged is then the same whatever implements it.

A share is work over time against the H100 SXM data sheet's 67e12 FP32
operations a second outside the tensor cores, at the full 700 W power
limit; the run prints the card's power limit beside it.
"""

from __future__ import annotations

FP32_PEAK = 67e12

# Forward path: operations per unit.
OPS_SPHERE_ROW = 24      # the sphere test and the running-minimum compare
OPS_QUAD_ROW = 45        # the quad test and the running-minimum compare
OPS_SHADE_BASE = 108     # one bounce's shading without metal or dielectric
OPS_REFLECT = 14         # the shared reflection (metal or dielectric)
OPS_METAL = 7            # fuzz and the kind select
OPS_DIELECTRIC = 49      # Schlick, refraction and the kind select
OPS_CAMERA = 62          # the camera ray and the per-sample fold

# Fused training objective: operations per live bounce. The shading with
# the light sample 235, colour 40, state update 29, the shadow test 2
# besides its closest hit; the adjoint besides its own shading 262; per
# surrogate sphere 155 (soft shadow both passes and the silhouette), per
# surrogate quad 350.
OPS_DIFF_SHADE = 235
OPS_DIFF_COLOR = 40
OPS_DIFF_ADVANCE = 29
OPS_DIFF_SHADOW = 2
OPS_DIFF_ADJ = 262
OPS_DIFF_SPH_SURR = 155
OPS_DIFF_QUAD_SURR = 350


def shade_ops(has_met: bool, has_die: bool) -> int:
    """One bounce's shading with the lobes the scene's materials use."""
    ops = OPS_SHADE_BASE
    if has_met or has_die:
        ops += OPS_REFLECT
    if has_met:
        ops += OPS_METAL
    if has_die:
        ops += OPS_DIELECTRIC
    return ops


def ops_per_camera_ray(n_sph: int, n_quad: int, segments: float, *,
                       has_met: bool = False, has_die: bool = False) -> float:
    """A forward camera ray: the camera ray, then `segments` bounces, each
    testing every real row and shading."""
    seg = n_sph * OPS_SPHERE_ROW + n_quad * OPS_QUAD_ROW + shade_ops(
        has_met, has_die)
    return OPS_CAMERA + segments * seg


def ops_per_camera_ray_diff(n_sph: int, n_quad: int, segments: float, *,
                            n_surr_sph: int, n_surr_quad: int,
                            has_met: bool = False,
                            has_die: bool = False) -> float:
    """A camera sample of the fused training objective, the adjoint
    charged once per forward segment (the cached-replay reckoning): two
    camera rays; per forward segment the trace of the bounce and its
    shadow ray, the shading, the shadow test, the update and the colour;
    then the replay's shading and update and the adjoint with the
    surrogates of the scope's rows."""
    rows = n_sph * OPS_SPHERE_ROW + n_quad * OPS_QUAD_ROW
    shade = OPS_DIFF_SHADE + (shade_ops(has_met, has_die)
                              - shade_ops(False, False))
    phase1 = 2 * rows + shade + OPS_DIFF_SHADOW + OPS_DIFF_ADVANCE \
        + OPS_DIFF_COLOR
    replay = shade + OPS_DIFF_ADVANCE
    adjoint = (shade + OPS_DIFF_ADJ + n_surr_sph * OPS_DIFF_SPH_SURR
               + n_surr_quad * OPS_DIFF_QUAD_SURR)
    return 2 * OPS_CAMERA + segments * (phase1 + replay + adjoint)


def share_pct(ops: float, seconds: float) -> float | None:
    """Percent of the FP32 peak that `ops` operations in `seconds` reach;
    None when there is no time to divide by."""
    if not ops > 0.0 or not seconds > 0.0:
        return None
    return 100.0 * ops / seconds / FP32_PEAK
