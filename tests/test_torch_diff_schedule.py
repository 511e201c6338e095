"""Host arithmetic of the fused kernels K5 and K4 (ops/diff_schedule.py):
the compiled variant a launch takes, the resident grid and the replay's
save slots; and the lane-use model that chip_smoke.py reports for them.
CPU only; imports neither JAX nor the JAX package."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.ops import diff_schedule as ds
from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

H100_SMS = 132

_spec_cs = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec_cs)
_spec_cs.loader.exec_module(cs)


def _spec(maker, nee=True, sil=True, surr_sph=True, surr_quad=True, **kw):
    world, camera, pkw = maker(**kw)
    _, _, _, _, spec = dkp._inputs(
        world.build(), camera,
        torch.zeros(camera.height, camera.width, 3), pkw["background"],
        None, nee, sil, surr_sph, surr_quad)
    return spec


def test_dispatch_cases_are_the_built_variants():
    """dispatch_flags (csrc/diff_common.cuh) has one case per key of
    BUILT_VARIANTS, each instantiating the Flags that variant_key names."""
    src = (_build.CSRC_DIR / "diff_common.cuh").read_text()
    body = src[src.index("cudaError_t dispatch_flags"):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"(case (\d+)|default): return l\.template run<"
                       r"Flags<(\w+), (\w+), (\w+), (\w+)>>", body)
    assert len(cases) == 16
    seen = set()
    for whole, num, *bits in cases:
        flags = tuple(b == "true" for b in bits)
        key = ds.variant_key(flags)
        if whole != "default":
            assert int(num) == key
        seen.add(key)
    assert seen == set(ds.BUILT_VARIANTS)


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("sil", [True, False])
def test_every_routed_combination_maps_to_a_built_variant(nee, sil):
    """Specs of scenes with and without lights, metal, glass and
    surrogate rows, under each NEE and silhouette switch, launch a built
    variant; a switch that changes nothing is dropped from the key."""
    specs = [
        _spec(presets.mixed_materials, nee, sil, width=8, height=6),
        _spec(presets.cornell_spheres, nee, sil, surr_quad=False,
              width=8, height=6),
        _spec(presets.three_spheres, nee, sil, width=8, height=6),
        _spec(presets.mixed_materials, nee, sil, surr_sph=False,
              surr_quad=False, width=8, height=6),
    ]
    for spec in specs:
        flags = ds.variant_flags(spec)
        assert ds.variant_key(flags) in ds.BUILT_VARIANTS
        assert flags[0] == (nee and spec.n_lights > 0)
        assert flags[1] == (sil and bool(spec.surr_s or spec.surr_q))
        assert flags[2:] == (spec.has_met, spec.has_die)
    assert specs[0].has_met and specs[0].has_die        # mixed: both lobes
    assert specs[2].n_lights == 0 and not ds.variant_flags(specs[2])[0]
    assert not ds.variant_flags(specs[3])[1]             # no surrogate rows


@pytest.mark.parametrize("per_sm", [2, 3, 4])
@pytest.mark.parametrize("npix", [1, 600, 40_000, 360_000, 2_073_600])
def test_plan_is_a_resident_grid_with_equal_shares(per_sm, npix):
    p = ds.plan(npix, per_sm, H100_SMS, 20)
    assert p.blocks <= per_sm * H100_SMS                # one wave
    assert p.blocks == min(per_sm * H100_SMS, -(-npix // ds.BLOCK))
    # every pixel has a thread, and a thread's pixels differ by at most 1
    assert p.threads * p.rounds >= npix
    assert p.threads * (p.rounds - 1) < npix
    assert p.slots == min(ds.CHUNK_SAMPLES * 20, ds.SAVES_BUDGET_BYTES
                          // (p.threads * ds.SLOT_FLOATS * 4))


def test_saves_scale_with_threads_k_and_bounces_not_pixels(monkeypatch):
    small = ds.plan(360_000, 3, H100_SMS, 20)
    large = ds.plan(3_600_000, 3, H100_SMS, 20)
    assert small.saves_floats == large.saves_floats
    assert small.saves_floats == (3 * H100_SMS * ds.BLOCK * 16 * 20
                                  * ds.SLOT_FLOATS)
    assert large.rounds == -(-3_600_000 // large.threads)
    for k in (8, 16, 32):
        monkeypatch.setattr(ds, "CHUNK_SAMPLES", k)
        p = ds.plan(360_000, 2, H100_SMS, 8)
        assert p.slots == k * 8
        assert p.saves_floats == p.threads * k * 8 * ds.SLOT_FLOATS


def test_budget_cuts_slots_then_threads_never_below_one_sample(monkeypatch):
    slot = ds.SLOT_FLOATS * 4
    monkeypatch.setattr(ds, "CHUNK_SAMPLES", 32)
    wide = ds.plan(1_000_000, 4, H100_SMS, 20)
    assert wide.slots < 32 * 20                     # 1 GiB cuts k=32 here
    assert wide.threads * wide.slots * slot <= ds.SAVES_BUDGET_BYTES
    budget = 1 << 20
    monkeypatch.setattr(ds, "SAVES_BUDGET_BYTES", budget)
    p = ds.plan(1_000_000, 4, H100_SMS, 20)
    assert p.threads * 20 * slot <= budget          # a sample per thread
    assert p.slots >= 20
    assert p.threads * p.slots * slot <= budget


def test_k4_columns_cap_the_grid():
    na = 6148
    p = ds.plan(40_000, 3, H100_SMS, 8, cols_per_thread=na,
                max_cols=1 << 30)
    assert (p.blocks, p.rounds) == (313, 1)
    tight = ds.plan(40_000, 3, H100_SMS, 8, cols_per_thread=na,
                    max_cols=na * 128 * 100)
    assert tight.blocks == 100 and tight.rounds == 4


def test_plan_rejects_empty_work():
    with pytest.raises(ValueError):
        ds.plan(0, 2, H100_SMS, 8)
    with pytest.raises(ValueError):
        ds.plan(10, 2, H100_SMS, 0)


def test_chunk_fill_follows_the_kernels_rule():
    """A chunk takes the next sample while max_bounces more slots fit:
    slots=8, mb=4 -> lengths 3,1,4 fill 3, 4 (3+1), then 4+4 = 8 fits
    too; then 2 starts a new chunk (8 + 4 > 8)."""
    lens = torch.tensor([[3, 1, 4, 2], [4, 4, 4, 4]])
    fill = cs.chunk_fill(lens, 4, 8)
    assert fill.tolist() == [[8, 2, 0, 0], [8, 8, 0, 0]]
    one = cs.chunk_fill(lens, 4, 4)         # k=1: a sample per chunk
    assert one.tolist() == [[3, 1, 4, 2], [4, 4, 4, 4]]


def test_lane_use_model():
    even = torch.full((64, 8), 3)
    u = cs.lane_use(even, 8, ks=(1, 16))
    assert u["lockstep"] == u["phase1"] == u["phase3_k16"] == 1.0
    assert u["live"] == 64 * 8 * 3
    # one lane in each warp runs 8 bounces a sample, the rest 1
    lens = torch.ones((32, 4), dtype=torch.int64)
    lens[0] = 8
    u = cs.lane_use(lens, 8, ks=(1, 4))
    live = 31 * 4 + 32
    assert u["lockstep_passes"] == 32 and u["phase1_passes"] == 32
    assert u["lockstep"] == pytest.approx(live / (32 * 32))
    assert u["phase3_k1"] == u["lockstep"]   # k=1: one sample per chunk
    # k=4: the long lane fills 32 slots in one chunk, the others 4
    assert u["phase3_k4_passes"] == 32


def test_mixed_replay_and_adjoint_loop_pays_for_both_bodies():
    """One loop of replay and adjoint passes: lane 0 runs R R A A, the
    others R A, so passes 0-1 have a replaying lane and passes 1-3 an
    adjoint lane; pass 1 pays for both bodies."""
    lens = torch.ones((32, 1), dtype=torch.int64)
    lens[0, 0] = 2
    assert cs.mixed_stage_passes(lens.view(1, 32, 1)) == (2, 3)
    u = cs.lane_use(lens, 4, ks=(1,), stage_ops=(1, 1))
    assert u["phase3_mixed"] == pytest.approx(33 * 2 / (32 * (2 + 3)))
    assert u["phase3_mixed"] < u["phase3_k1"]


def test_lane_use_from_twin_counts():
    """The twin's per-(pixel, sample) live bounces: between 1 and
    max_bounces; regeneration never loses against lockstep; a
    chunk of k=16 never loses against one sample per chunk (k=1, the
    lockstep count)."""
    world, camera, kw = presets.cornell_spheres(width=16, height=8)
    _, tab, cam, _, spec = dkp._inputs(
        world.build(), camera, torch.zeros(8, 16, 3), kw["background"],
        None, True, True, True, False)
    pid = torch.arange(128)
    lens = cs.live_bounces(dkp, tab, cam, spec, width=16, pid=pid, spp=8,
                           max_bounces=6, seed=1)
    assert lens.shape == (128, 8)
    assert int(lens.min()) >= 1 and int(lens.max()) <= 6
    again = cs.live_bounces(dkp, tab, cam, spec, width=16,
                           pid=pid[32:64], spp=4, max_bounces=6, seed=1)
    assert torch.equal(again, lens[32:64, :4])
    u = cs.lane_use(lens, 6, ks=(1, 4, 16), stage_ops=(900, 800))
    assert u["phase1"] >= u["lockstep"]
    assert u["phase3_k1"] == u["lockstep"] <= u["phase3_k16"]
    assert u["phase3_mixed"] < u["phase3_k16"]


@pytest.mark.parametrize("npix, spp, want", [
    (360_000, 200, 1),          # cfg5f: 2 813 blocks, many waves
    (40_000, 8, 8),             # cfg4class: 313 blocks under a wave of 660
    (40_000, 2, 2),             # at most spp parts
    (768, 4, 4),
    (660 * 128, 8, 1),          # exactly one wave
    (659 * 128, 8, 5),          # one block short: ceil(4 * 660 / 659)
])
def test_image_split_follows_the_forward_rule(npix, spp, want):
    """The image kernel splits each pixel's samples over threads only
    when its grid is under one wave (5 blocks per SM here), into enough
    parts for SPLIT_WAVES waves, at most spp."""
    assert ds.image_split(npix, spp, 5, 132) == want
