"""The classic-layout fused kernel K4's host side (ops/diffkernel.py:
routing, `classic_diff`) and its plain twin (`diffkernel_packed.
packed_diff_reference`, K5's twin as well) against JAX's K4 in interpret
mode, and the `trainable_rows` step.

The CUDA kernel is held to the twin on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 15). Each JAX call is made once per module; torch runs
single-threaded and keeps every tensor under its 32768-element parallel
grain (see tests/test_torch_intersect.py).

Tolerances, with what was measured (this CPU), on a lit many-sphere scene
(tests/test_diffkernel.py's `_n_sphere_world(20)`, 8x8 spp=2 mb=3 seed 0)
and on random_spheres(24x16, n=24) (sky-lit, spp=2 mb=3 seed 1), each with
the dense, an explicit-subset and the class-off scope:
  - the loss within LOSS_RTOL (measured at most 5.8e-7);
  - the image within 1e-5 on all but IMG_MAX_OFF pixels (measured: one
    pixel of the lit scene, by 3.2e-5; random_spheres bit for bit);
  - each gradient field within GRAD_RTOL, `tests/test_diffkernel.py:
    _compare`'s default, of its largest entry (measured at most 1.2e-3,
    sph_radius of the lit scene's subset scope; random_spheres at most
    9.8e-5). The estimators differ in rounding only: JAX's kernel forms
    the soft-shadow product as exp(sum(log)) and the quad planes with one
    reciprocal, and XLA fuses multiply-adds inside jit;
  - the port's own relationships, as JAX's tests state them
    (tests/test_diffkernel.py:305-363): the subset of every row equals
    the dense scope within 1e-5 of each field's largest entry (measured:
    bit for bit); on a sky-lit scene the subset rows' sph_center equals
    the dense one within 1e-6 (measured: bit for bit); the loss does not
    depend on the scope (bit for bit);
  - one SGD step (learning rate LR, so that a move spans hundreds of
    ulps) with `trainable_rows` against JAX's, cornell_spheres 12x12
    spp=2 mb=3: the loss within LOSS_RTOL (measured 2.9e-6), the moves
    within STEP_RTOL, `_compare`'s rtol on this scene, of the largest
    (measured 4.7e-3: two ulps of the coordinates), every other row
    exactly unmoved.
"""

import numpy as np
import optax
import pytest
import torch

from tinyraytracer_tpu.diff import inverse as jinv
from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.ops import diffkernel as jdk
from tinyraytracer_tpu_torch.diff import inverse as tinv
from tinyraytracer_tpu_torch.diff import optim
from tinyraytracer_tpu_torch.diff import params as tpar
from tinyraytracer_tpu_torch.ops import diffkernel as tdk
from tinyraytracer_tpu_torch.ops import diffkernel_packed as tdkp
from test_diffkernel import _n_sphere_world
from test_torch_diffkernel import to_port

FIELDS = tpar.FLOAT_FIELDS + ("background",)
LOSS_RTOL = 1e-4
IMG_MAX_OFF = 2
GRAD_RTOL = 5e-3
STEP_RTOL = 0.1
LR = 1.0
# At seed 0 one random_spheres pixel takes another path in the two
# estimators (XLA's multiply-add fusion under jit moves a discriminant by
# an ulp): it moves by 0.164 and the loss by 4.2e-4. Seeds 1-3 and 5 have
# no such pixel; the test runs seed 1 there.
SEEDS = {"lit20": 0, "rs24": 1}


def kw_of(name):
    return dict(spp=2, max_bounces=3, seed=SEEDS[name])


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_scene(name):
    """(scene, camera, background, target) of the JAX package."""
    if name == "lit20":
        js, jc = _n_sphere_world(20)
        bg = (0.05, 0.05, 0.08)
    else:
        w, jc, kw = jpresets.random_spheres(width=24, height=16, n=24)
        js, bg = w.build(), kw["background"]
    target = np.random.RandomState(4).rand(jc.height, jc.width, 3).astype(
        np.float32) * 0.5
    return js, jc, bg, target


def scope_of(name, st):
    return {"dense": None, "subset": {"sph": st.sph_rows[:3]},
            "off": {"sph": (), "quad": ()}}[name]


CASES = [(s, c) for s in ("lit20", "rs24") for c in ("dense", "subset",
                                                      "off")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def k4_pair(request):
    scene_name, scope_name = request.param
    js, jc, bg, target = jax_scene(scene_name)
    ts, tc = to_port(js, jc)
    scope = scope_of(scope_name, jdk.build_diff_static(js))
    jl, ji, jg = jdk.render_value_and_grad(
        js, jc, target, background=bg, interpret=True, packed=False,
        surr_rows=scope, **kw_of(scene_name))
    tl, ti, tg = tdk.render_value_and_grad(ts, tc, target, background=bg,
                                           surr_rows=scope,
                                           **kw_of(scene_name))
    return ((float(jl), np.asarray(ji), {k: np.asarray(v) for k, v in
                                         jg.items()}),
            (float(tl), ti.numpy(), {k: v.numpy() for k, v in tg.items()}))


def test_k4_twin_loss_matches_jax(k4_pair):
    (jl, _, _), (tl, _, _) = k4_pair
    assert abs(tl - jl) <= LOSS_RTOL * jl


def test_k4_twin_image_matches_jax(k4_pair):
    (_, ji, _), (_, ti, _) = k4_pair
    d = np.abs(ti - ji).max(-1)
    assert ti.shape == ji.shape and (d > 1e-5).sum() <= IMG_MAX_OFF


@pytest.mark.parametrize("field", FIELDS)
def test_k4_twin_gradient_matches_jax(k4_pair, field):
    (_, _, jg), (_, _, tg) = k4_pair
    a, b = jg[field], tg[field]
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-8)
    assert np.abs(a - b).max() <= GRAD_RTOL * scale


def _routes(monkeypatch, scene, camera, bg, **kw):
    """Which kernel render_value_and_grad sends the call to, and its
    loss: "K4" (classic_diff) or "K5" (the packed route)."""
    seen = []
    real4, real5 = tdk.classic_diff, tdkp.render_value_and_grad_packed

    def k4(*a, **k):
        seen.append("K4")
        return real4(*a, **k)

    def k5(*a, **k):
        seen.append("K5")
        return real5(*a, **k)

    monkeypatch.setattr(tdk, "classic_diff", k4)
    monkeypatch.setattr(tdkp, "render_value_and_grad_packed", k5)
    target = torch.zeros(camera.height, camera.width, 3)
    loss, _, _ = tdk.render_value_and_grad(scene, camera, target,
                                           background=bg, spp=1,
                                           max_bounces=2, **kw)
    monkeypatch.undo()
    assert len(seen) == 1 and np.isfinite(float(loss))
    return seen[0]


def test_routing(monkeypatch):
    """Class scopes of small scenes go to K5, `packed=False` and the lit
    20-sphere scene to K4 (row subsets, more primitives and large
    palettes: tests/test_torch_diffkernel_step.py)."""
    from tinyraytracer_tpu_torch.models import presets as tpresets

    w, c, kw = tpresets.cornell_spheres(width=4, height=4)
    small, bg = w.build(), kw["background"]
    assert _routes(monkeypatch, small, c, bg) == "K5"
    assert _routes(monkeypatch, small, c, bg,
                   surr_rows={"sph": None, "quad": ()}) == "K5"
    assert _routes(monkeypatch, small, c, bg, packed=False) == "K4"
    js, jc, jbg, _ = jax_scene("lit20")
    lit, lc = to_port(js, jc)
    assert _routes(monkeypatch, lit, lc, jbg) == "K4"


def _port_case(name, scope):
    js, jc, bg, target = jax_scene(name)
    ts, tc = to_port(js, jc)
    st = tdk.build_diff_static(ts)
    if callable(scope):
        scope = scope(st)
    loss, _, g = tdk.render_value_and_grad(ts, tc, target, background=bg,
                                           surr_rows=scope, **kw_of(name))
    return float(loss), {k: v.numpy() for k, v in g.items()}, st


def test_subset_of_all_rows_equals_dense():
    l0, g0, st = _port_case("lit20", None)
    l1, g1, _ = _port_case("lit20", lambda s: {"sph": s.sph_rows,
                                               "quad": s.quad_rows})
    assert l0 == l1
    for k in FIELDS:
        scale = max(np.abs(g0[k]).max(), 1e-8)
        assert np.abs(g0[k] - g1[k]).max() <= 1e-5 * scale, k


def test_subset_rows_exact_on_sky_scene():
    """Without lights only the silhouette surrogate runs, and it
    factorises per row: the listed rows' gradients are the dense ones."""
    l0, g0, st = _port_case("rs24", None)
    sub = list(st.sph_rows[:3])
    l1, g1, _ = _port_case("rs24", {"sph": tuple(sub)})
    a, b = g0["sph_center"][sub], g1["sph_center"][sub]
    assert np.abs(a - b).max() <= 1e-6 * max(np.abs(a).max(), 1e-8)
    assert np.isfinite(g1["sph_center"]).all() and l0 == l1


def test_loss_does_not_depend_on_the_scope():
    losses = {_port_case("lit20", lambda st, n=n: scope_of(n, st))[0]
              for n in ("dense", "subset", "off")}
    assert len(losses) == 1


# --- the trainable_rows step -------------------------------------------------

@pytest.fixture(scope="module")
def rows_step_pair():
    jw, jc, kw = jpresets.cornell_spheres(width=12, height=12)
    js = jw.build()
    ts, tc = to_port(js, jc)
    target = np.random.RandomState(5).rand(12, 12, 3).astype(np.float32) * 0.5
    sub = jdk.build_diff_static(js).sph_rows[:1]
    kws = dict(spp=2, max_bounces=3, background=kw["background"], seed=3,
               trainable=("sph_center",), trainable_rows={"sph": sub})
    jstep, (jp, jo) = jinv.make_fused_train_step(
        js, jc, target, interpret=True, optimizer=optax.sgd(LR), **kws)
    jp1, _, jl = jstep(jp, jo, 0)
    tstep, (tp, to) = tinv.make_fused_train_step(
        ts, tc, target, optimizer=optim.scale(-LR), device="cpu", **kws)
    tp1, _, tl = tstep(tp, to, 0)
    p0 = np.asarray(jp["sph_center"])
    return (sub, p0, (float(jl), np.asarray(jp1["sph_center"])),
            (float(tl), tp1["sph_center"].numpy()))


def test_trainable_rows_step_matches_jax(rows_step_pair):
    sub, p0, (jl, jp1), (tl, tp1) = rows_step_pair
    assert abs(tl - jl) <= LOSS_RTOL * jl
    want, got = jp1 - p0, tp1 - p0
    assert np.abs(got[list(sub)]).max() > 0.0
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= STEP_RTOL * scale
    rest = [r for r in range(p0.shape[0]) if r not in sub]
    assert not got[rest].any() and not want[rest].any()


def test_fit_trainable_rows_on_the_cpu():
    """fit(trainable_rows=..., engine="fused") on the twin: the listed
    row moves, every other row and every quad stays exactly."""
    from tinyraytracer_tpu_torch.models import presets as tpresets

    w, c, kw = tpresets.cornell_spheres(width=8, height=8)
    scene = w.build()
    rows = np.flatnonzero(scene.sph_valid.numpy())
    target = torch.from_numpy(np.random.RandomState(1).rand(
        8, 8, 3).astype(np.float32))
    fitted, losses = tinv.fit(
        scene, c, target, steps=2, spp=1, max_bounces=2,
        background=kw["background"], trainable=("sph_center", "quad_corner"),
        trainable_rows={"sph": (int(rows[0]),)}, engine="fused",
        device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    moved = (fitted.sph_center != scene.sph_center).any(-1)
    assert bool(moved[int(rows[0])]) and int(moved.sum()) == 1
    assert torch.equal(fitted.quad_corner, scene.quad_corner)
