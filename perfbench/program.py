"""The system's own spans and counters, as the per-layer readers take
them: the registry of `tinyraytracer_tpu_torch.utils.profiling`, filled
while the profiler records the window (the traced run) and read after
it.

Where the system under test has no such registry, `snapshot()` is None
and every reader built on it returns None: a metric the program does not
report is left out of the result, never an error.
"""

from __future__ import annotations


def snapshot() -> dict | None:
    """The registry's snapshot, or None where the program has none."""
    try:
        from tinyraytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return None if snap is None else snap()


def per_request(ctx, total: float | None) -> float | None:
    """`total` over the window's requests."""
    if total is None or not ctx.window.attempted:
        return None
    return total / ctx.window.attempted


def self_ms(ctx, names) -> float | None:
    """The self time of the spans `names`, summed, ms a request; None
    where the program recorded none of them."""
    snap = snapshot()
    if snap is None:
        return None
    spans = snap["spans"]
    if not any(n in spans for n in names):
        return None
    return per_request(ctx, sum(spans[n]["self_ms"] for n in names
                                if n in spans))


def stage_ms(ctx, stage: str) -> float | None:
    """Device ms of a fused kernel's stage (`image`, `adjoint`, `reduce`)
    a request, K5's and K4's together; None where none was timed."""
    snap = snapshot()
    if snap is None:
        return None
    stages = snap["stages"]
    keys = [f"{k}.{stage}" for k in ("k5", "k4") if f"{k}.{stage}" in stages]
    if not keys:
        return None
    return per_request(ctx, sum(stages[k]["ms"] for k in keys))
