"""The readers of K2's walk counters (`walk_steps.render`,
`walk_efficiency.render`) on planted snapshots of the program's
registry: the ratios they report, and None where the counters are
absent (a program without them) or 0 (K1's launches leave them so)."""

import pytest

from perfbench import core, program

METRICS = ("walk_steps.render", "walk_efficiency.render")


def _read(name, monkeypatch, device):
    snap = None if device is None else {"spans": {}, "counters": {},
                                        "stages": {}, "device": device}
    monkeypatch.setattr(program, "snapshot", lambda: snap)
    reader = core.load_module(
        core.HERE / "layer_metrics" / f"{name}.py", f"walk_{name}")
    return reader.read(None)


def test_walk_metrics_read_a_planted_snapshot(monkeypatch):
    dev = {"lane_segments": 1000, "warp_passes": 40, "walk_steps": 36_500,
           "walk_iters": 51_200}
    assert _read("walk_steps.render", monkeypatch, dev) == pytest.approx(
        36.5)
    assert _read("walk_efficiency.render", monkeypatch,
                 dev) == pytest.approx(100.0 * 36_500 / 51_200)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("device", [
    None,                                           # no registry
    {},                                             # no kernel counted
    {"lane_segments": 1000, "warp_passes": 40},     # counters absent
    {"lane_segments": 1000, "warp_passes": 40, "walk_steps": 0,
     "walk_iters": 0},                              # K1's launches
])
def test_walk_metrics_are_none_without_the_counters(name, monkeypatch,
                                                    device):
    assert _read(name, monkeypatch, device) is None
