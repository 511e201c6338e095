"""The H100 roofline model (tinyraytracer_tpu_torch/utils/sol.py): counts
and bounds worked by hand, the bounds chip_smoke.py printed on the card
(PERF.md section 6) recomputed from their inputs, and the executed-bounce
estimate against the JAX package's on the same scene and seed (CPU)."""

import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models import presets as jax_presets
from tinyraytracer_tpu.utils import sol as jax_sol
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp
from tinyraytracer_tpu_torch.utils import sol

# sol.mean_executed_bounces on cornell_box 24x24 spp=1 mb=8, the port's
# (closest hits by K3's twin) against the JAX package's (dense selection),
# on the CPU: measured 4.576389 against 4.569444, |d| = 0.00694, which is
# 4 bounce segments of 576 rays (the light/ceiling z-fight moves single
# rays). Allowed: 6 segments.
MEAN_BOUNCES_ATOL = 6 / 576


def _spec(maker, surr_sph=True, surr_quad=True, **kw):
    world, camera, pkw = maker(**kw)
    _, _, _, _, spec = dkp._inputs(
        world.build(), camera, torch.zeros(camera.height, camera.width, 3),
        pkw["background"], None, True, True, surr_sph, surr_quad)
    return spec


def test_forward_counts_by_hand():
    # cornell_box: 18 quads, no metal or dielectric: 18 * 45 + 108
    assert sol.segment_ops(0, 18) == 918
    assert sol.ops_per_camera_ray(0, 18, 6.6020) == 62 + 6.6020 * 918
    # every lobe: 108 + 14 + 7 + 49
    assert sol.shade_ops(True, True) == 178
    assert sol.ops_per_camera_ray(3, 1, 2.0, has_met=True, has_die=True) == (
        62 + 2.0 * (3 * 24 + 45 + 178))
    assert sol.culled_segment_ops(4, 10.5) == 6 + 4 * 25 + 10.5 * 24 + 108


def test_cfg3_bound_from_its_inputs():
    """PERF.md section 6: K1 at cfg3 (cornell_box 600x600 spp=200) is
    bound at 6.580 ms by operations: 6.6020 segments a camera ray (the
    twin's count), 918 operations a segment."""
    rays = 600 * 600 * 200
    ms, by, ops = sol.bound(rays, 6.6020 * rays, sol.segment_ops(0, 18),
                            12 * 600 * 600, 4 * 600)
    assert (f"{ms:.3f}", by, f"{ops:.4g}") == ("6.580", "operations",
                                              "4.408e+11")
    assert ops == pytest.approx(rays * sol.ops_per_camera_ray(0, 18, 6.6020))


def test_k3_bounds_from_their_inputs():
    """PERF.md section 6: K3 on cfg5's 720 000 primary rays (2 spheres, 6
    quads) is bound by bytes at 0.0069 ms; the global route's 320 000 rays
    over 500 spheres and a lamp quad by operations at 0.0695 ms."""
    ms, by, _ = sol.k3_bound(720_000, 2, 6)
    assert (f"{ms:.4f}", by) == ("0.0069", "bytes")
    ms, by, ops = sol.k3_bound(320_000, 500, 1)
    assert (f"{ms:.4f}", by, ops) == ("0.0695", "operations",
                                      320_000 * (500 * 29 + 49))


def test_k5_bound_of_cfg5f_from_its_inputs():
    """PERF.md section 6: K5 at cfg5f (cornell_spheres, class scope: 2
    sphere surrogates, no quad's) is 2 651 operations a live bounce and
    bound at 17.497 ms at 6.0951 live bounces a camera ray."""
    spec = _spec(presets.cornell_spheres, surr_quad=False)
    assert (spec.n_sph, spec.n_quad, len(spec.surr_s), len(spec.surr_q)) == (
        2, 6, 2, 0)
    # rows 2 * 24 + 6 * 45 = 318; phase 1: 2 * 318 + 235 + 2 + 29 + 40;
    # the replay the same without the colour; the adjoint 235 + 262 +
    # 2 * 155
    assert sol.per_seg_split(spec) == (942, 902 + 807)
    pixels, spp = 600 * 600, 200
    ms, by, ops, per_seg = sol.k5_bound(spec, pixels, spp,
                                        6.0951 * pixels * spp)
    assert (f"{ms:.3f}", by, per_seg) == ("17.497", "operations", 2651)
    assert ops == 2 * pixels * spp * 62 + 6.0951 * pixels * spp * 2651


def test_k4_bounds_of_cfg4class_from_their_inputs():
    """PERF.md section 6: K4 at cfg4class (512 spheres, no light, the
    first 8 rows' silhouettes) bound at 0.3574 ms, dense at 0.9578, at
    2.8344 live bounces a camera ray."""
    pixels, spp, live = 200 * 200, 8, 2.8344 * 200 * 200 * 8
    spec = _spec(presets.random_spheres, surr_sph=tuple(range(8)),
                 surr_quad=False, width=20, height=20, n=512)
    ms, by, _, per_seg = sol.k4_bound(spec, pixels, spp, live)
    assert (f"{ms:.4f}", by, per_seg) == ("0.3574", "operations", 26354)
    dense = _spec(presets.random_spheres, surr_quad=False, width=20,
                  height=20, n=512)
    ms, by, _, per_seg = sol.k4_bound(dense, pixels, spp, live)
    assert (f"{ms:.4f}", by, per_seg) == ("0.9578", "operations", 70706)


def test_diff_model_by_hand():
    """cornell_box with every field trainable (18 quad surrogates): per
    live bounce phase 1 is 2 * 810 + 235 + 2 + 29 + 40 = 1 926, the replay
    1 886 (264 with an intersection cache: shade and advance), the adjoint
    235 + 262 + 18 * 350 = 6 797."""
    assert sol.ops_per_camera_ray_diff(0, 18, 8, cached_replay=True) == (
        124 + 8 * 1926 + 8 * (264 + 6797))
    assert sol.ops_per_camera_ray_diff(0, 18, 20, fwd_bounces=6.5) == (
        124 + 6.5 * 1926 + 20 * (1886 + 6797))
    # every stage at the same count of live bounces is K5's bound
    spec = _spec(presets.cornell_box, width=8, height=8)
    _, _, ops, _ = sol.k5_bound(spec, 1, 1, 6)
    assert sol.ops_per_camera_ray_diff(0, 18, 6) == ops


def test_shares_and_their_guard():
    rate = 1.5e9
    assert sol.pct_of_sol(rate, 0, 18, 6.6) == pytest.approx(
        rate * (62 + 6.6 * 918) / 67e12)
    assert sol.pct_of_sol_diff(3.5e7, 0, 18, 8, cached_replay=True) == (
        pytest.approx(3.5e7 * 72020 / 67e12))
    with pytest.raises(ValueError, match="outside"):
        sol.pct_of_sol(1e11, 0, 18, 6.6)
    with pytest.raises(ValueError, match="outside"):
        sol.pct_of_sol_diff(0.0, 0, 18, 8)


def test_mean_executed_bounces_matches_jax():
    """cornell_box 24x24 spp=1 mb=8, seed 0: the port's survival-curve
    estimate against the JAX package's (MEAN_BOUNCES_ATOL)."""
    world, camera, kw = presets.cornell_box(width=24, height=24)
    got = sol.mean_executed_bounces(world.build(), camera, max_bounces=8,
                                    background=kw["background"], spp=1,
                                    device="cpu")
    jworld, jcamera, jkw = jax_presets.cornell_box(width=24, height=24)
    want = jax_sol.mean_executed_bounces(jworld.build(), jcamera,
                                         max_bounces=8,
                                         background=jkw["background"], spp=1)
    assert 1.0 < got < 8.0
    assert abs(got - want) <= MEAN_BOUNCES_ATOL
    # a whole number of segments over 576 rays
    assert np.isclose((got - 1.0) * 576, round((got - 1.0) * 576))
