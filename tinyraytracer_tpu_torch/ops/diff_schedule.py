"""Host arithmetic of the fused differentiable kernels K5 and K4
(csrc/diffkernel_packed.cu, csrc/diffkernel.cu): which compiled variant a
launch takes, the grid and the replay's save slots.

Each launch first renders phase 1, the NEE image, in an image kernel: a
thread per pixel, each pixel's samples split over threads when that grid
is under one wave of the card (image_split), one bounce per pass
(csrc/diff_common.cuh, image_thread). The fused kernel then runs on a
grid that the card holds at once (plan). Each thread loops over pixels
(pixel = warp's first thread + lane + r x threads) and runs a pixel's
replay and adjoint in per-lane regeneration loops (diff_thread): stage R
replays samples into the thread's save slots, stage A walks them back
through the adjoint. A thread starts another sample in stage R while a
path of max_bounces bounces still fits in its `slots`, which are
CHUNK_SAMPLES x max_bounces unless the scratch budget cuts them.
"""

from __future__ import annotations

import dataclasses

BLOCK = 128
# A save slot: 14 words (state, winner t and index, shadow visibility),
# the sample's live-bounce count and a pad: four 128-bit accesses.
SLOT_FLOATS = 16
# k: a chunk holds the save slots of k worst-case samples per thread
# (PERF.md section 6's sweep: k=16 within 1 % of k=32 at cfg5f, 3 %
# faster than k=8, at half of k=32's scratch).
CHUNK_SAMPLES = 16
# Bytes the save slots of one launch may take.
SAVES_BUDGET_BYTES = 1 << 30
# Waves of the card the image kernel's sample split aims for.
SPLIT_WAVES = 4
# The compiled switch combinations (csrc/diff_common.cuh dispatch_flags):
# key = nee << 3 | sil << 2 | metal << 1 | dielectric.
BUILT_VARIANTS = tuple(range(16))


def variant_flags(spec) -> tuple:
    """(nee, sil, has_met, has_die) of the kernel variant a PackedSpec
    launches. A switch that changes nothing runs the variant without it:
    NEE without lights (no light sample, no shadow ray, the emission gate
    open) and the silhouette without surrogate rows (its loops run over
    no row); the results are the same bits."""
    nee = bool(spec.nee) and spec.n_lights > 0
    sil = bool(spec.sil) and bool(spec.surr_s or spec.surr_q)
    return nee, sil, bool(spec.has_met), bool(spec.has_die)


def variant_key(flags) -> int:
    nee, sil, met, die = flags
    return (nee << 3) | (sil << 2) | (met << 1) | int(die)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's grid and scratch."""

    blocks: int
    rounds: int       # pixels of the busiest thread
    slots: int        # save slots per thread

    @property
    def threads(self) -> int:
        return self.blocks * BLOCK

    @property
    def saves_floats(self) -> int:
        return self.threads * self.slots * SLOT_FLOATS


def plan(npix: int, per_sm: int, sms: int, max_bounces: int, *,
         cols_per_thread: int = 0, max_cols: int | None = None) -> Plan:
    """The grid and save slots of a launch over `npix` pixels of a kernel
    of which `per_sm` blocks fit on each of `sms` SMs.

    The blocks the card holds at once, no more than the pixels need, and
    few enough that the save slots of one worst-case sample per thread fit
    SAVES_BUDGET_BYTES and, with `cols_per_thread` accumulator floats per
    thread (K4's [na][threads] scratch), the columns fit `max_cols`
    floats. A thread then gets `rounds` or `rounds - 1` pixels. Each
    thread has CHUNK_SAMPLES x max_bounces save slots, fewer if the budget
    says so, never fewer than max_bounces."""
    if npix < 1 or max_bounces < 1:
        raise ValueError(f"need pixels and bounces >= 1; got {npix}, "
                         f"{max_bounces}")
    slot_bytes = SLOT_FLOATS * 4
    budget = SAVES_BUDGET_BYTES
    blocks = min(max(per_sm, 1) * max(sms, 1), -(-npix // BLOCK),
                 budget // (max_bounces * slot_bytes * BLOCK))
    if cols_per_thread and max_cols is not None:
        blocks = min(blocks, max_cols // (cols_per_thread * BLOCK))
    blocks = max(blocks, 1)
    threads = blocks * BLOCK
    slots = min(CHUNK_SAMPLES * max_bounces, budget // (threads * slot_bytes))
    return Plan(blocks=blocks, rounds=-(-npix // threads),
                slots=max(slots, max_bounces))


def image_split(npix: int, spp: int, per_sm: int, sms: int) -> int:
    """Sample parts per pixel of the image kernel, `per_sm` of whose blocks
    fit each of `sms` SMs: 1 when its grid of npix threads fills a wave of
    the card, else enough parts for SPLIT_WAVES waves, at most spp (the
    forward kernels' rule, csrc/common.cuh sample_split)."""
    wave = max(per_sm, 1) * max(sms, 1)
    blocks = -(-npix // BLOCK)
    if blocks >= wave:
        return 1
    return min(spp, -(-SPLIT_WAVES * wave // blocks))
