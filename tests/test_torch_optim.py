"""The port's optax pieces (diff/optim.py) against optax 0.2.6, and the
checkpoint resume through `load_checkpoint(path, optimizer.init(params))`.

Inputs are made with numpy from a seed and fed to both sides.
Tolerances: the schedules are float32 on both sides and equal bit for bit
(measured: 0 ulp over counts 0-200, every case). Adam alone is within
OPT_RTOL, as tests/test_torch_diff.py holds it (its bias corrections take
powf, which rounds 1 ulp apart between XLA and torch). The inverse
example's optimizer adds adaptive_clip, whose per-field norm sums in
another order on each side: one ulp of its scale, amplified where Adam's
first moment cancels, so over 60 updates each update is held within
UPDATE_RTOL of its field's largest update (measured 2.3e-7; elementwise
up to 3e-5 on entries a thousandth of the largest) and the final params
within PARAM_RTOL (measured 5.4e-6).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinyraytracer_tpu.diff import inverse as jinv
from tinyraytracer_tpu_torch.diff import inverse as tinv
from tinyraytracer_tpu_torch.diff import optim

OPT_RTOL = 1e-6
UPDATE_RTOL = 1e-6
PARAM_RTOL = 1e-5
COUNTS = np.arange(0, 201, dtype=np.int32)

# (name, optax schedule, port schedule)
SCHEDULES = [
    ("constant", optax.constant_schedule(0.25),
     optim.constant_schedule(0.25)),
    ("decay", optax.exponential_decay(0.25, 20, 0.5),
     optim.exponential_decay(0.25, 20, 0.5)),
    ("decay begin staircase",
     optax.exponential_decay(0.1, 7, 0.9, transition_begin=15,
                             staircase=True),
     optim.exponential_decay(0.1, 7, 0.9, transition_begin=15,
                             staircase=True)),
    ("decay end_value", optax.exponential_decay(1.0, 10, 0.5, end_value=0.2),
     optim.exponential_decay(1.0, 10, 0.5, end_value=0.2)),
    ("growth end_value",
     optax.exponential_decay(0.01, 5, 1.5, transition_begin=3,
                             end_value=0.05),
     optim.exponential_decay(0.01, 5, 1.5, transition_begin=3,
                             end_value=0.05)),
    ("degenerate steps", optax.exponential_decay(0.3, 0, 0.5),
     optim.exponential_decay(0.3, 0, 0.5)),
    ("inverse example's join",
     optax.join_schedules([optax.constant_schedule(0.25),
                           optax.exponential_decay(0.25, 20, 0.5)], [160]),
     optim.join_schedules([optim.constant_schedule(0.25),
                           optim.exponential_decay(0.25, 20, 0.5)], [160])),
    ("three-way join",
     optax.join_schedules([optax.constant_schedule(0.08),
                           optax.exponential_decay(0.08, 10, 0.5),
                           optax.exponential_decay(0.02, 4, 0.9,
                                                   staircase=True)],
                          [40, 90]),
     optim.join_schedules([optim.constant_schedule(0.08),
                           optim.exponential_decay(0.08, 10, 0.5),
                           optim.exponential_decay(0.02, 4, 0.9,
                                                   staircase=True)],
                          [40, 90])),
]


@pytest.mark.parametrize("name,jsched,tsched", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_schedules_match_optax(name, jsched, tsched):
    want = np.array([np.float32(jsched(jnp.asarray(c))) for c in COUNTS])
    got = np.array([np.float32(tsched(torch.tensor(int(c),
                                                   dtype=torch.int32)))
                    for c in COUNTS])
    np.testing.assert_array_equal(got, want, err_msg=name)


# The inverse example's fields, two of each group, at small shapes.
SHAPES = {"sph_center": (16, 3), "quad_u": (8, 3), "mat_albedo": (8, 3),
          "mat_emit": (8, 3)}


def _group(k):
    return "geom" if k.startswith(("sph_", "quad_")) else "mat"


def _inverse_optimizers(steps, callable_labels):
    """examples/inverse_render.py's optimizer in optax and in the port."""
    boundary = max(40, (steps * 4) // 5)
    labels = {k: _group(k) for k in SHAPES}
    jl = (lambda p: {k: _group(k) for k in p}) if callable_labels else labels
    tl = (lambda p: {k: _group(k) for k in p}) if callable_labels else labels
    jopt = optax.multi_transform(
        {"geom": optax.chain(jinv.adaptive_clip(4.0), optax.adam(
            optax.join_schedules(
                [optax.constant_schedule(0.25),
                 optax.exponential_decay(0.25, transition_steps=20,
                                         decay_rate=0.5)],
                boundaries=[boundary]), b2=0.9)),
         "mat": optax.adam(0.02)}, jl)
    topt = optim.multi_transform(
        {"geom": optim.chain(tinv.adaptive_clip(4.0), optim.adam(
            optim.join_schedules(
                [optim.constant_schedule(0.25),
                 optim.exponential_decay(0.25, transition_steps=20,
                                         decay_rate=0.5)],
                boundaries=[boundary]), b2=0.9)),
         "mat": optim.adam(0.02)}, tl)
    return jopt, topt


def _grads(n, seed=7):
    rs = np.random.RandomState(seed)
    gs = [{k: (rs.normal(size=s) * 10 ** rs.uniform(-3, 1)).astype(
        np.float32) for k, s in SHAPES.items()} for _ in range(n)]
    gs[30]["sph_center"] *= 100.0        # a spike for adaptive_clip
    gs[31]["quad_u"] *= 50.0
    return gs


def _params(seed=3):
    rs = np.random.RandomState(seed)
    return {k: rs.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("callable_labels", [False, True])
def test_inverse_example_optimizer_matches_optax(callable_labels):
    """60 updates that cross the schedule's boundary (48) with a spike:
    every update and the final params within OPT_RTOL."""
    steps = 60
    jopt, topt = _inverse_optimizers(steps, callable_labels)
    params = _params()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js_, ts_ = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(_grads(steps)):
        ju, js_ = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              js_, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts_ = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              ts_, tp)
        tp = optim.apply_updates(tp, tu)
        assert list(tu) == list(SHAPES)
        for k in SHAPES:
            want = np.asarray(ju[k])
            np.testing.assert_allclose(
                tu[k].numpy(), want, rtol=0,
                atol=UPDATE_RTOL * np.abs(want).max(),
                err_msg=f"update {i} {k}")
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=PARAM_RTOL, err_msg=k)
    geom = ts_.inner_states["geom"]
    assert int(geom[0]["count"]) == steps            # adaptive_clip
    assert int(geom[1][0].count) == steps            # Adam's moments
    assert int(geom[1][1].count) == steps            # the schedule's own
    assert set(ts_.inner_states["mat"][0].mu) == {"mat_albedo", "mat_emit"}


def test_scheduled_adam_takes_lr_at_the_count_before_the_update():
    """A schedule of the count as Adam's rate: step 0 takes lr(0), as
    optax.adam does (the schedule's count is read before it is
    incremented)."""
    jopt = optax.adam(lambda c: 0.1 * (c.astype(jnp.float32) + 1))
    topt = optim.adam(lambda c: 0.1 * (c.to(torch.float32) + 1))
    rs = np.random.RandomState(5)
    p = rs.normal(size=(4, 3)).astype(np.float32)
    jp, tp = {"x": jnp.asarray(p)}, {"x": torch.from_numpy(p.copy())}
    js_, ts_ = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = rs.normal(size=(4, 3)).astype(np.float32)
        ju, js_ = jopt.update({"x": jnp.asarray(g)}, js_, jp)
        tu, ts_ = topt.update({"x": torch.from_numpy(g)}, ts_, tp)
        np.testing.assert_allclose(tu["x"].numpy(), np.asarray(ju["x"]),
                                   rtol=OPT_RTOL, atol=1e-12)
    assert ts_[1].count.dtype == torch.int32 and int(ts_[1].count) == 4


def test_multi_transform_rejects_missing_labels_and_transforms():
    p = {"sph_center": torch.zeros(2, 3), "mat_albedo": torch.zeros(2, 3)}
    opt = optim.multi_transform({"geom": optim.adam(0.1)},
                                {"sph_center": "geom"})
    with pytest.raises(ValueError, match="no label"):
        opt.init(p)
    opt = optim.multi_transform({"geom": optim.adam(0.1)},
                                {"sph_center": "geom", "mat_albedo": "mat"})
    with pytest.raises(ValueError, match="no transformation"):
        opt.init(p)


def test_checkpoint_resume_through_the_template_is_bit_for_bit(tmp_path):
    """save after 25 updates, load_checkpoint(path, opt.init(params)),
    and the next 25 updates, which cross the schedule's boundary (40) and
    the spike, equal the uninterrupted run's bit for bit."""
    _, topt = _inverse_optimizers(50, callable_labels=False)
    grads = _grads(50)
    p0 = {k: torch.from_numpy(v) for k, v in _params().items()}

    def run(p, s, lo, hi):
        for g in grads[lo:hi]:
            u, s = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                               s, p)
            p = optim.apply_updates(p, u)
        return p, s

    p_all, _ = run(p0, topt.init(p0), 0, 50)
    p_mid, s_mid = run(p0, topt.init(p0), 0, 25)
    path = str(tmp_path / "opt.ckpt")
    tinv.save_checkpoint(path, p_mid, s_mid, 25)
    p2, s2, n = tinv.load_checkpoint(path, topt.init(p0))
    assert n == 25
    assert type(s2) is optim.MultiTransformState
    for k in p_mid:
        assert p2[k].device.type == "cpu" and torch.equal(p2[k], p_mid[k])
    p_end, _ = run(p2, s2, 25, 50)
    for k in p_all:
        assert torch.equal(p_end[k], p_all[k]), k
    # without a template: the saved tree as tensors on the device asked
    _, raw, _ = tinv.load_checkpoint(path, device="cpu")
    assert torch.equal(raw.inner_states["geom"][1][1].count,
                       s_mid.inner_states["geom"][1][1].count)
    # a template of another optimizer does not fit
    with pytest.raises(ValueError, match="optimizer leaves"):
        tinv.load_checkpoint(path, optim.adam(0.1).init(p0))
