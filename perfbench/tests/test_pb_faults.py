"""The correctness check against its control and against planted faults.

Each run here drives the rest of a run on the CPU (the system's plain
twins, tiny sizes, the cell's own limits) with the timed path broken
underneath, and `correct` has to come out false: a step or render that
returns its state unchanged, half of the batch left out (the mean taken
over the rest), an answer altered where it is produced. The control,
the reference in bfloat16 put in the system's place, has to fail a
limit too. The same readings at the cells' own sizes on the card are
made by perfbench/control.py."""

import numpy as np
import pytest
import torch

from perfbench import control, core

TINY = {"cornell.render": dict(width=48, height=48, spp=64, max_bounces=12),
        "rtiow_final.render": dict(width=16, height=9, spp=4, max_bounces=5),
        "cornell.train": dict(width=10, height=8, spp=2, max_bounces=3),
        "rtiow_final.train": dict(width=16, height=9, spp=2, max_bounces=3)}
RENDER = [c for c in TINY if c.endswith(".render")]
TRAIN = [c for c in TINY if c.endswith(".train")]


def _cell(name):
    cell = core.find_cell(name)
    cell.params.update(TINY[name])
    return cell


def _run(name, seed=2 ** 31 + 77):
    return core.run(_cell(name), seed=seed, seconds=0.3, trace=False,
                    device="cpu")


@pytest.mark.parametrize("name", list(TINY))
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]


def _patch_render(monkeypatch, fault):
    import tinyraytracer_tpu_torch as rt

    orig = rt.Renderer.render
    first = []

    def render(self, camera, world):
        if fault == "half":
            self.samples_per_pixel //= 2
        img = orig(self, camera, world)
        if fault == "stale":
            first.append(first[0] if first else img)
            return first[0]
        if fault == "altered":
            return rt.Image(img.data * 1.5)
        return img

    monkeypatch.setattr(rt.Renderer, "render", render)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", RENDER)
def test_render_faults_are_caught(monkeypatch, name, fault):
    _patch_render(monkeypatch, fault)
    res = _run(name)
    assert not res["correct"], res["checks"]


def _patch_train(monkeypatch, fault):
    from tinyraytracer_tpu_torch.diff import inverse
    from tinyraytracer_tpu_torch.ops import diffkernel, diffkernel_packed

    if fault == "half":
        def halve(orig):
            def fn(tab, cam, target, *, pixels=None, **kw):
                b, n = pixels
                m = n // 2
                img, *tabs = orig(tab, cam, target[:m].contiguous(),
                                  pixels=(b, m), **kw)
                full = torch.zeros((n, 3), dtype=img.dtype)
                full[:m] = img
                return (full, *[t * (n / m) for t in tabs])
            return fn

        monkeypatch.setattr(diffkernel_packed, "packed_diff",
                            halve(diffkernel_packed.packed_diff))
        monkeypatch.setattr(diffkernel, "classic_diff",
                            halve(diffkernel.classic_diff))
        return
    orig_make = inverse.make_fused_train_step

    def make(*a, **kw):
        step, state = orig_make(*a, **kw)

        def bad(params, opt, i):
            p2, o2, loss = step(params, opt, i)
            if fault == "unchanged":
                return params, opt, loss
            return p2, o2, loss * 1.01          # "altered"
        return bad, state

    monkeypatch.setattr(inverse, "make_fused_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", TRAIN)
def test_train_faults_are_caught(monkeypatch, name, fault):
    _patch_train(monkeypatch, fault)
    res = _run(name)
    assert not res["correct"], res["checks"]


def test_train_fits_restart_from_the_scene():
    cell = _cell("cornell.train")
    cell.params["fit_steps"] = 4
    tr = core.traffic_class("train")(cell.config, cell.params, seed=5,
                                     device="cpu")
    tr.setup()
    tr.request(0)
    assert int(tr.opt[0].count) == 4
    tr.request(1)           # the fifth step opens the second fit
    assert int(tr.opt[0].count) == 1
    assert tr.n == 5


@pytest.mark.parametrize("name", RENDER)
def test_the_render_control_fails(name):
    cell = _cell(name)
    got = control.render_control(cell, 11, "cpu")["png_diff_share"]
    assert got > cell.params["limits"]["png_diff_share"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_train_control_and_faults_fail(name):
    cell = _cell(name)
    lim = cell.params["limits"]
    readings = control.train_readings(cell, 11, "cpu", True)
    for kind, values in readings.items():
        assert any(values[k] > lim[k] for k in lim), (kind, values)
    assert np.isfinite(readings["control"]["loss_gap"])
