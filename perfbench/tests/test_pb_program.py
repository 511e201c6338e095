"""The per-layer metrics that read the program's own spans and counters
(perfbench/program.py), from whole traced runs on the CPU: the span
metrics are reported, the device's counters and stage times are not (the
CPU runs the kernels' plain twins), and a program without the registry
gives none of them and no error."""

import pytest

from perfbench import core
from tinyraytracer_tpu_torch.utils import profiling

TINY = {"cornell.render": dict(width=12, height=8, spp=2, max_bounces=3),
        "cornell.train": dict(width=10, height=6, spp=2, max_bounces=3)}
SPANS = {"cornell.render": ("lower_ms.render", "launch_ms.render",
                            "gamma_ms.render", "unattributed_ms.render"),
         "cornell.train": ("table_ms.train", "grads_ms.train")}
DEVICE = {"cornell.render": ("simt_efficiency.render",),
          "cornell.train": ("image_kernel_ms.train",
                            "adjoint_kernel_ms.train")}


def _traced(name):
    cell = core.find_cell(name)
    cell.params.update(TINY[name])
    profiling.reset()
    return core.run(cell, seed=2 ** 31 + 41, seconds=0.3, trace=True,
                    device="cpu")


@pytest.mark.parametrize("name", list(TINY))
def test_a_traced_cpu_run_reports_the_span_metrics(name):
    res = _traced(name)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for m in SPANS[name]:
        assert m in got, m
        if m != "unattributed_ms.render":
            assert got[m]["value"] > 0.0 and got[m]["unit"] == "ms", m
    for m in DEVICE[name]:
        assert m not in got, m
    # the host time is the render spans' self time and a remainder
    if name == "cornell.render":
        spans = profiling.snapshot()["spans"]
        named = sum(spans[n]["self_ms"] for n in spans
                    if n != "tinyrt.render.readback") / res["attempted"]
        assert got["unattributed_ms.render"]["value"] == pytest.approx(
            got["host_ms.render"]["value"] - named)


@pytest.mark.parametrize("name", list(TINY))
def test_a_program_without_the_registry_reports_none(name, monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    res = _traced(name)
    assert res["correct"]
    for m in SPANS[name] + DEVICE[name]:
        assert m not in res["metrics"], m
    assert ("host_ms.render" if name.endswith("render")
            else "host_ms.train") in res["metrics"]
