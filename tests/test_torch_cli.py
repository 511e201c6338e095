"""The port's CLI flags `--accelerator` and `--profile DIR`
(utils/profiling.py on torch.profiler) and `Renderer.render_batch_array`
on the CPU. The card's versions of these checks are in chip_smoke.py
(phases 7 and 19)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tinyraytracer_tpu_torch import Image, Renderer
from tinyraytracer_tpu_torch import renderer as renderer_mod
from tinyraytracer_tpu_torch.__main__ import main as cli_main
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.ops import bvh as bvh_ops
from tinyraytracer_tpu_torch.utils import profiling


def _args(out, *extra):
    return ["--preset", "random_spheres", "--width", "12", "--height", "8",
            "--spp", "2", "--max-bounces", "3", "--device", "cpu", "--out",
            str(out), *extra]


@pytest.mark.parametrize("acc", ["auto", "megakernel", "bvh", "none"])
def test_cli_accelerator_routes(tmp_path, capsys, monkeypatch, acc):
    """Each --accelerator value reaches the Renderer and writes the PNG;
    bvh walks the BVH, the others do not."""
    monkeypatch.setattr(bvh_ops, "walk_counts", bvh_ops.WalkCounts())
    out = tmp_path / "a.png"
    assert cli_main(_args(out, "--accelerator", acc)) == 0
    assert out.stat().st_size > 0
    assert f"accelerator={acc}" in capsys.readouterr().out
    assert (bvh_ops.walk_counts.walks > 0) == (acc == "bvh")


def test_cli_rejects_unknown_accelerator(tmp_path):
    with pytest.raises(SystemExit):
        cli_main(_args(tmp_path / "a.png", "--accelerator", "warp"))


def test_cli_profile_writes_trace(tmp_path):
    """--profile DIR writes a Chrome trace holding the render's ops beside
    the PNG."""
    out, prof = tmp_path / "p.png", tmp_path / "prof"
    assert cli_main(_args(out, "--accelerator", "bvh", "--profile",
                          str(prof))) == 0
    assert out.stat().st_size > 0
    files = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::index_select" in names


def test_profiling_annotate_spans_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("tinyrt-span"):
            torch.ones(4).sum()
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "tinyrt-span" in names


@pytest.mark.parametrize("acc", ["auto", "bvh"])
def test_render_batch_array_frames_equal_single_renders(acc):
    world, camera, kw = presets.random_spheres(width=12, height=8, n=40)
    scene = world.build()
    r = Renderer(2, max_bounces=4, background_color=kw["background"],
                 seed=9, accelerator=acc, device="cpu")
    frames = r.render_batch_array(camera, world, [4, 1, 4])
    assert frames.shape == (3, 8, 12, 3) and frames.dtype == torch.float32
    for s, f in zip([4, 1, 4], frames):
        one = Renderer(2, max_bounces=4, background_color=kw["background"],
                       seed=s, accelerator=acc, device="cpu")
        assert torch.equal(f, one.render_array(camera, scene))
    assert not torch.equal(frames[0], frames[1])
    assert r.seed == 9
    assert r.render_batch_array(camera, scene, []).shape == (0, 8, 12, 3)


def test_render_batch_goes_through_render_batch_array(monkeypatch):
    world, camera, kw = presets.sphere_ground(width=6, height=4)
    r = Renderer(1, max_bounces=2, background_color=kw["background"],
                 device="cpu")
    calls = []
    real = renderer_mod.Renderer.render_batch_array

    def spy(self, *a):
        calls.append(a[2])
        return real(self, *a)

    monkeypatch.setattr(renderer_mod.Renderer, "render_batch_array", spy)
    frames = r.render_batch(camera, world, [0, 2])
    assert calls == [[0, 2]] and len(frames) == 2
    assert all(isinstance(f, Image) for f in frames)
    np.testing.assert_array_equal(frames[1].data,
                                  Renderer(1, max_bounces=2, seed=2,
                                           background_color=kw["background"],
                                           device="cpu")
                                  .render(camera, world).data)
