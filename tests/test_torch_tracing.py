"""The port's spans and counters (utils/profiling.py).

On the CPU: with the profiler off a render and a fused train step record
nothing and `annotate` is the shared no-op; under torch.profiler the
Chrome trace holds every span of the render path and the train step,
nested as utils/profiling.py lists them, and the registry's self times
lie between 0 and their totals; `reset` and `snapshot`.

On the card (marker `cuda`): K1's and K2's lane segments equal the
segments the benchmark's plain reference counts on the same pixels, their
SIMT efficiency lies in (0, 100] %, and with the profiler off the
kernels leave the counter buffer alone and no stage event is made. This
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts= -q tests/test_torch_tracing.py
"""

import glob
import json
import os
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinyraytracer_tpu_torch import Renderer
from tinyraytracer_tpu_torch.diff import inverse
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RENDER_SPANS = ("tinyrt.render.build", "tinyrt.render.lower",
                "tinyrt.render.launch", "tinyrt.render.readback",
                "tinyrt.render.gamma")
TRAIN_SPANS = ("tinyrt.train.table", "tinyrt.train.launch",
               "tinyrt.train.grads", "tinyrt.train.adam")


def _render(device="cpu", seed=1):
    world, camera, kw = presets.cornell_box(width=8, height=6)
    return Renderer(2, max_bounces=3, background_color=kw["background"],
                    seed=seed, device=device).render(camera, world)


def _step(device="cpu"):
    world, camera, kw = presets.cornell_spheres(width=8, height=8)
    step, (p, o) = inverse.make_fused_train_step(
        world.build(), camera, torch.zeros(8, 8, 3), spp=1, max_bounces=2,
        background=kw["background"], trainable=("sph_center", "mat_albedo"),
        device=device)
    return step, p, o


def _empty():
    return {"spans": {}, "counters": {}, "stages": {}, "device": {}}


def test_profiler_off_records_nothing():
    step, p, o = _step()
    profiling.reset()
    assert not profiling.enabled()
    _render()
    step(p, o, 0)
    assert profiling.snapshot() == _empty()
    # the shared no-op: nothing is allocated per span
    assert profiling.annotate("a") is profiling.annotate("b")
    assert profiling.stage_events("k5", ("image",), "cpu") is None
    assert profiling.device_counters("cpu") is None


def _parents(path) -> dict:
    """Each tinyrt span of the Chrome trace -> the set of names of the
    innermost host span around it (None at the top)."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    out: dict = {}
    for e in ev:
        if not e["name"].startswith("tinyrt."):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        around = [x for x in ev if x is not e and x["tid"] == e["tid"]
                  and float(x["ts"]) <= a
                  and float(x["ts"]) + float(x["dur"]) >= b]
        inner = min(around, key=lambda x: float(x["dur"]), default=None)
        out.setdefault(e["name"], set()).add(
            None if inner is None else inner["name"])
    return out


def test_spans_nest_in_the_profilers_trace(tmp_path):
    step, p, o = _step()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("client"):
            _render()
        with profiling.annotate("client"):
            step(p, o, 0)
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    parents = _parents(path)
    assert parents["tinyrt.renderer.init"] == {"client"}
    assert parents["tinyrt.render"] == {"client"}
    for name in RENDER_SPANS:
        assert parents[name] == {"tinyrt.render"}, name
    assert parents["tinyrt.train.step"] == {"client"}
    for name in TRAIN_SPANS:
        assert parents[name] == {"tinyrt.train.step"}, name
    (counts,) = glob.glob(os.path.join(tmp_path, "*.counters.json"))
    with open(counts) as f:
        spans = json.load(f)["spans"]
    assert set(spans) == {"client", "tinyrt.renderer.init", "tinyrt.render",
                          "tinyrt.train.step", *RENDER_SPANS, *TRAIN_SPANS}
    for name, s in spans.items():
        assert s["count"] >= 1
        assert 0.0 <= s["self_ms"] <= s["total_ms"] + 1e-9, name
    # a parent's self time leaves its children out
    r = spans["tinyrt.render"]
    children = sum(spans[n]["total_ms"] for n in RENDER_SPANS)
    assert r["self_ms"] == pytest.approx(r["total_ms"] - children, abs=1e-6)


def test_reset_and_snapshot():
    profiling.reset()
    profiling.count("x", 2)
    profiling.count("x")
    assert profiling.counter("x") == 3 and profiling.counter("y") == 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.enabled()
        with profiling.annotate("outer"):
            time.sleep(0.01)
            for _ in range(2):
                with profiling.annotate("inner"):
                    time.sleep(0.005)
    assert not profiling.enabled()
    snap = profiling.snapshot()
    assert snap["counters"] == {"x": 3}
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert inner["self_ms"] == pytest.approx(inner["total_ms"])
    assert inner["total_ms"] >= 10.0
    assert outer["self_ms"] == pytest.approx(
        outer["total_ms"] - inner["total_ms"])
    assert outer["self_ms"] >= 10.0
    assert snap["stages"] == {} and snap["device"] == {}
    assert profiling.snapshot() == snap      # a snapshot takes nothing
    profiling.reset()
    assert profiling.snapshot() == _empty()


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reference_scene(config, w, h):
    """The benchmark's scene `config` (perfbench/configs/): the port's
    World and Camera and the plain reference's lowering and camera."""
    sys.path.insert(0, ROOT)
    from perfbench import scenes
    from perfbench.reference import scene as ref_scene

    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{config}.json")) as f:
        desc = scenes.description(json.load(f))
    world, camera = scenes.port_scene(desc, w, h)
    low = ref_scene.lower(ref_scene.arrays(desc)).to("cuda", torch.float32)
    cam = torch.from_numpy(ref_scene.camera_vector(desc, w, h)).to("cuda")
    return desc, world, camera, low, cam


@pytest.mark.cuda
@pytest.mark.parametrize("config,kernel", [("cornell", "render_packed"),
                                           ("rtiow_final", "render_flat")])
def test_lane_segments_are_the_reference_segments(cuda, config, kernel):
    w, h, spp, mb, seed = 24, 16, 3, 8, 3_000_000_019
    desc, world, camera, low, cam = _reference_scene(config, w, h)
    from perfbench.reference import forward
    r = Renderer(spp, max_bounces=mb, seed=seed, device=cuda,
                 background_color=tuple(desc["background"]))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        img = r.render_array(camera, world.build())
        torch.cuda.synchronize()
    snap = profiling.snapshot()
    assert snap["counters"] == {f"launches.{kernel}": 1}
    want, seg = forward.render_pixels(low, cam, torch.arange(w * h),
                                      width=w, spp=spp, seed=seed,
                                      max_bounces=mb)
    assert torch.equal(img.reshape(-1, 3).cpu(), want.float().cpu())
    dev = snap["device"]
    assert dev["lane_segments"] == round(seg * w * h * spp)
    eff = dev["lane_segments"] / (32.0 * dev["warp_passes"])
    assert 0.0 < eff <= 1.0
    # K1 leaves the walk counters alone; K2 (the final scene walks its
    # BVH) tests fewer nodes a segment than the scene has rows, and a
    # warp's walk loop runs its busiest lane's tests
    if kernel == "render_packed":
        assert dev["walk_steps"] == dev["walk_iters"] == 0
    else:
        assert 0 < dev["walk_steps"] < 500 * dev["lane_segments"]
        assert dev["walk_steps"] <= dev["walk_iters"]


@pytest.mark.cuda
def test_dense_k2_counts_every_row_a_segment(cuda):
    """K2's dense search counts its rows: every segment tests each of the
    scene's rows, so walk_steps is rows x lane_segments, and each warp
    pass runs the row loop once: walk_iters is 32 x rows x warp_passes."""
    from tinyraytracer_tpu_torch.ops import megakernel as mk

    w, h = 24, 16
    desc, world, camera, _, _ = _reference_scene("rtiow_final", w, h)
    r = mk.MegakernelRenderer(world.build(), camera,
                              tuple(desc["background"]), cuda, bvh=False)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        r.render(spp=3, max_bounces=8, seed=3)
        torch.cuda.synchronize()
    dev = profiling.snapshot()["device"]
    rows = r.n_sph + r.n_quad
    assert dev["walk_steps"] == rows * dev["lane_segments"]
    assert dev["walk_iters"] == 32 * rows * dev["warp_passes"]


@pytest.mark.cuda
def test_profiler_off_leaves_counters_and_events_alone(cuda):
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    step, p, o = _step(cuda)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _render(cuda)
        step(p, o, 0)
    snap = profiling.snapshot()
    assert snap["device"]["lane_segments"] > 0
    assert set(snap["stages"]) == {f"k5.{s}" for s in dkp.STAGES}
    assert all(s["count"] == 1 and s["ms"] > 0.0
               for s in snap["stages"].values())
    (buf,) = profiling._device_bufs.values()
    before = buf.clone()
    assert dkp.stage_handles("k5", cuda) == (None, None)
    _render(cuda, seed=2)
    step(p, o, 1)
    torch.cuda.synchronize()
    assert torch.equal(buf, before)
    assert profiling.snapshot()["stages"] == snap["stages"]
    assert profiling.snapshot()["device"] == snap["device"]
