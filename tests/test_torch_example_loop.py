"""examples/torch_inverse_render.py's loop against examples/inverse_render.py
on the CPU, both run in process on the same flags.

The loop test replaces each package's `make_train_step` with the same
stand-in step: seeded gradients that depend on the step index and the
spp (so the refine swap shows), a spike every 17 steps for the geometry
clip, a signed bias on the albedos that drives them into the clamp, and
the example's own optimizer applying them. Everything else is the
examples' own code: the two-group optimizer, the refine-phase rebuild,
the albedo clamp, the Polyak tail average, the checkpoint every 50 steps
and the resume through load_checkpoint(path, opt_state). Each step's
input params (the previous step's clamped output), each loss and the
Polyak average handed to apply_params are compared within
LOOP_RTOL x the field's largest entry (losses: relative); measured
7.1e-9 on the centers (the optimizers' last bits,
tests/test_torch_optim.py), 0 on the albedos, and 7.5e-8 on the losses
(one float32 ulp of the sum).

The step test runs both examples' real modular step (--engine modular)
for three steps and compares each step's loss within STEP_LOSS_RTOL
(measured 1.9e-5, 1.1e-5 and 5.8e-5 at steps 0-2; a wrong seed, sample
offset, target or scene moves a loss by the estimator's noise, percents
at this size). It compares no params: Adam's first update is
lr x g / (|g| + eps), so a gradient component near zero (sphere b's z,
≈ 1e-7 here) moves by ±lr in either package whatever its sign, and the
two runs stand up to 0.5 apart after one step (measured 0.497).
"""

import os
import runpy
import sys

import numpy as np
import optax
import pytest
import torch

from tinyraytracer_tpu.diff import inverse as jinv
from tinyraytracer_tpu.diff import params as jparams
from tinyraytracer_tpu_torch.diff import inverse as tinv
from tinyraytracer_tpu_torch.diff import optim
from tinyraytracer_tpu_torch.diff import params as tparams
from tinyraytracer_tpu_torch.models import presets as tpresets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLE = os.path.join(REPO, "examples", "inverse_render.py")
TORCH_EXAMPLE = os.path.join(REPO, "examples", "torch_inverse_render.py")
LOOP_RTOL = 1e-6
STEP_LOSS_RTOL = 2e-4
# 60 steps: the geometry rate decays and the refine phase starts at 48,
# the Polyak window at 51 (57 in a run resumed at 50)
LOOP_FLAGS = ["--size", "8", "--spp", "2", "--target-spp", "1",
              "--refine-spp", "4", "--steps", "60", "--max-bounces", "1",
              "--engine", "modular"]
STEP_FLAGS = ["--size", "12", "--spp", "2", "--target-spp", "2",
              "--refine-spp", "0", "--steps", "3", "--max-bounces", "2",
              "--engine", "modular"]


def _grads(step_idx, spp, shapes, trainable):
    """The stand-in step's gradients, in float32, zero for untrained
    fields as the real step zeroes them."""
    rs = np.random.RandomState(1000 * int(step_idx) + spp)
    g = {}
    for k in sorted(shapes):
        v = rs.standard_normal(shapes[k]).astype(np.float32)
        if k == "mat_albedo":
            v += np.where(np.arange(shapes[k][0]) % 2 == 0, 2.0,
                          -2.0)[:, None].astype(np.float32)
        if k == "sph_center" and int(step_idx) % 17 == 5:
            v *= np.float32(50.0)
        g[k] = v if k in trainable else np.zeros_like(v)
    return g


def _loss(host_params):
    return np.float32(sum(np.abs(host_params[k]).astype(np.float64).sum()
                          for k in ("sph_center", "mat_albedo")))


def _jax_stub(record):
    def make_train_step(scene, camera, target, *, spp, optimizer, trainable,
                        **_):
        p0 = jparams.scene_params(scene)
        shapes = {k: v.shape for k, v in p0.items()}

        def step(p, o, i):
            host = {k: np.asarray(v) for k, v in p.items()}
            record.append(host)
            g = _grads(i, spp, shapes, trainable)
            upd, o = optimizer.update(g, o, p)
            return optax.apply_updates(p, upd), o, _loss(host)

        return step, (p0, optimizer.init(p0))

    return make_train_step


def _torch_stub(record):
    def make_train_step(scene, camera, target, *, spp, optimizer, trainable,
                        **_):
        p0 = tparams.scene_params(scene)
        shapes = {k: tuple(v.shape) for k, v in p0.items()}

        def step(p, o, i):
            host = {k: v.numpy().copy() for k, v in p.items()}
            record.append(host)
            g = {k: torch.from_numpy(v) for k, v in
                 _grads(i, spp, shapes, trainable).items()}
            upd, o = optimizer.update(g, o, p)
            return optim.apply_updates(p, upd), o, torch.tensor(_loss(host))

        return step, (p0, optimizer.init(p0))

    return make_train_step


def _recording_apply(mod, record, to_host):
    orig = mod.apply_params

    def apply_params(scene, params):
        record.append({k: to_host(v) for k, v in params.items()})
        return orig(scene, params)

    return apply_params


def _run_jax(monkeypatch, flags, out):
    """examples/inverse_render.py's main() on `flags`; returns what its
    losses printed and what apply_params was last handed."""
    applied = []
    monkeypatch.setattr(jparams, "apply_params", _recording_apply(
        jparams, applied, np.asarray))
    monkeypatch.setattr(sys, "argv", ["inverse_render.py", *flags,
                                      "--out", out])
    assert runpy.run_path(JAX_EXAMPLE)["main"]() == 0
    return applied[-1]


def _run_torch(monkeypatch, flags, out):
    applied = []
    monkeypatch.setattr(tparams, "apply_params", _recording_apply(
        tparams, applied, lambda v: v.detach().numpy()))
    res = runpy.run_path(TORCH_EXAMPLE)["main"]([*flags, "--device", "cpu",
                                                 "--out", out])
    return res, applied[-1]


def _close(got, want, label):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        d = float(np.abs(np.asarray(got[k]) - w).max())
        assert d <= LOOP_RTOL * scale, (label, k, d / scale)


def test_inverse_example_loop_matches_jax(monkeypatch, tmp_path):
    """Both loops on one stand-in step: 60 steps with a checkpoint, then
    a second run of each resumed at step 50."""
    flags = LOOP_FLAGS + ["--checkpoint"]
    valid = tpresets.cornell_spheres(width=8, height=8)[0].build() \
        .sph_valid.numpy()
    jrec, trec = [], []
    monkeypatch.setattr(jinv, "make_train_step", _jax_stub(jrec))
    monkeypatch.setattr(tinv, "make_train_step", _torch_stub(trec))
    for run in ("whole", "resumed"):
        del jrec[:], trec[:]
        javg = _run_jax(monkeypatch, flags + [str(tmp_path / "jax.ckpt")],
                        str(tmp_path / "jax"))
        res, tavg = _run_torch(monkeypatch,
                               flags + [str(tmp_path / "torch.ckpt")],
                               str(tmp_path / "torch"))
        assert res["start"] == (0 if run == "whole" else 50)
        assert len(jrec) == len(trec) == 60 - res["start"]
        for i, (j, t) in enumerate(zip(jrec, trec)):
            _close(t, j, f"{run} step {res['start'] + i} input")
        albedo = np.stack([j["mat_albedo"] for j in jrec])
        assert albedo.min() == 0.0 and albedo.max() == 1.0  # clamped
        np.testing.assert_allclose(res["losses"], [_loss(j) for j in jrec],
                                   rtol=LOOP_RTOL)
        _close(tavg, javg, f"{run} Polyak average")
        _close({"sph_center": res["centers"]},
               {"sph_center": javg["sph_center"][valid]}, run)


@pytest.fixture
def single_thread_torch():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_inverse_example_real_steps_match_jax(monkeypatch, tmp_path,
                                              single_thread_torch):
    """The real modular step in both examples: the same target, scene,
    seeds and sample offsets give each step's loss within
    STEP_LOSS_RTOL."""
    jlosses = []
    orig = jinv.make_train_step

    def recording(*a, **k):
        step, state = orig(*a, **k)

        def wrapped(p, o, i):
            p, o, loss = step(p, o, i)
            jlosses.append(float(loss))
            return p, o, loss

        return wrapped, state

    monkeypatch.setattr(jinv, "make_train_step", recording)
    _run_jax(monkeypatch, STEP_FLAGS, str(tmp_path / "jax"))
    res, _ = _run_torch(monkeypatch, STEP_FLAGS, str(tmp_path / "torch"))
    assert res["engine"] == "modular" and len(jlosses) == 3
    np.testing.assert_allclose(res["losses"], jlosses, rtol=STEP_LOSS_RTOL)
