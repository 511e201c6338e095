"""The import check: what a run and the reference load, by whole
top-level module names."""

import subprocess
import sys
from pathlib import Path

from perfbench import core

ROOT = Path(core.ROOT)

RUN = """
import sys
sys.path.insert(0, {root!r})
from perfbench import core, control, scenes, tracing, workcount
for kind in ("render", "train"):
    core.traffic_class(kind)
import glob, os
for f in glob.glob(os.path.join({root!r}, "perfbench/layer_metrics/*.py")):
    core.load_module(__import__("pathlib").Path(f), "m")
cell = core.find_cell("cornell.render")
cell.params.update(width=8, height=6, spp=2, max_bounces=2)
core.run(cell, seed=1, seconds=0.05, trace=False, device="cpu")
cell = core.find_cell("cornell.train")
cell.params.update(width=8, height=6, spp=1, max_bounces=2)
core.run(cell, seed=1, seconds=0.05, trace=False, device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
from perfbench.reference import diff, forward, rng, scene, step
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True, cwd=str(ROOT))
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_not_the_jax_package():
    tops = _tops(RUN)
    assert "tinyraytracer_tpu_torch" in tops      # the system under test
    assert not set(tops) & set(core.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_system():
    tops = _tops(REFERENCE)
    assert not set(tops) & (set(core.FORBIDDEN)
                            | {"tinyraytracer_tpu_torch"})


def test_loaded_forbidden_compares_whole_top_level_names():
    assert core.loaded_forbidden(["tinyraytracer_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert core.loaded_forbidden(["jax.numpy", "tinyraytracer_tpu.ops"]) == [
        "jax", "tinyraytracer_tpu"]
