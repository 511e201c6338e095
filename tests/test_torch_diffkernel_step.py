"""The fused objective's twin against JAX's classic-layout diff kernel, and
the port's fused train step against JAX's, on the CPU.

JAX's classic kernel (`ops/diffkernel.py:_make_diff_kernel`, K4) runs the
same estimator as K5 on another layout; in interpret mode it is the
cheaper JAX reference here, and it is what JAX's own
`make_fused_train_step(interpret=True)` routes to. Torch runs
single-threaded and keeps every tensor under its 32768-element parallel
grain (see tests/test_torch_intersect.py).

Tolerances, with what was measured (this CPU):
  - the twin against JAX's classic kernel on tests/test_diffkernel.py's
    `_mixed_world` (32x24, spp=2, mb=3, seed 3), full scope and the class
    scope {"sph": None, "quad": ()}: the loss within MIXED_LOSS_RTOL
    (measured 3.3e-7); the image within 1e-5 on all but 1 % of pixels
    (measured: 1 pixel of 768, by 3.8e-5); each field within MIXED_RTOL of
    its largest entry (measured at most 4.7e-5, mat_fuzz). The
    differences are XLA's multiply-add fusion inside jit, which the port
    does not do; `_compare`'s rtol for this scene, 5e-3, is the outer
    bound;
  - one fused step (SGD, learning rate LR) against JAX's on
    cornell_spheres 12x12 (spp=2, mb=3, seed 3): each trained field's move
    within STEP_RTOL, `_compare`'s rtol on this scene, of its largest move
    (measured: sph_center equal, mat_albedo 7.9e-4); the loss within 1e-4
    (measured 6.1e-7); untrained fields do not move at all.
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
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.ops import diffkernel as tdk
from tinyraytracer_tpu_torch.parallel.sharded import make_mesh
from test_diffkernel import _mixed_world
from test_torch_diffkernel import to_port

FIELDS = tpar.FLOAT_FIELDS + ("background",)
MIXED_LOSS_RTOL = 1e-5
MIXED_RTOL = 5e-4
LR = 1e-2
STEP_RTOL = 0.1
SCOPES = {"full": None, "class": {"sph": None, "quad": ()}}


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=list(SCOPES))
def classic_pair(request):
    scope = SCOPES[request.param]
    js, jc, bg = _mixed_world()
    ts, tc = to_port(js, jc)
    target = np.random.RandomState(0).rand(24, 32, 3).astype(np.float32) * 0.5
    kws = dict(spp=2, max_bounces=3, background=bg, seed=3, surr_rows=scope)
    jl, ji, jg = jdk.render_value_and_grad(js, jc, target, interpret=True,
                                           packed=False, **kws)
    tl, ti, tg = tdk.render_value_and_grad(ts, tc, target, **kws)
    return ((float(jl), np.asarray(ji), {k: np.asarray(v) for k, v in
                                         jg.items()}),
            (float(tl), ti.numpy(), {k: v.numpy() for k, v in tg.items()}))


def test_twin_loss_matches_classic(classic_pair):
    (jl, _, _), (tl, _, _) = classic_pair
    assert abs(tl - jl) <= MIXED_LOSS_RTOL * jl


def test_twin_image_matches_classic(classic_pair):
    (_, ji, _), (_, ti, _) = classic_pair
    off = np.abs(ti - ji).max(-1) > 1e-5
    assert off.mean() <= 0.01 and np.abs(ti - ji).max() <= 1e-3


@pytest.mark.parametrize("field", FIELDS)
def test_twin_gradient_matches_classic(classic_pair, field):
    (_, _, jg), (_, _, tg) = classic_pair
    a, b = jg[field], tg[field]
    scale = max(np.abs(a).max(), 1e-8)
    assert np.abs(a - b).max() <= MIXED_RTOL * scale


# --- one fused train step against JAX's ---------------------------------------

TRAINABLES = {"geometry": ("sph_center", "mat_albedo"),
              "albedo": ("mat_albedo",)}


def _cornell12():
    jw, jc, kw = jpresets.cornell_spheres(width=12, height=12)
    target = np.random.RandomState(7).rand(12, 12, 3).astype(np.float32) * 0.5
    return jw.build(), jc, kw["background"], target


@pytest.fixture(scope="module", params=list(TRAINABLES))
def step_pair(request):
    trainable = TRAINABLES[request.param]
    js, jc, bg, target = _cornell12()
    ts, tc = to_port(js, jc)
    kws = dict(spp=2, max_bounces=3, background=bg, seed=3,
               trainable=trainable)
    jstep, (jp, jo) = jinv.make_fused_train_step(
        js, jc, target, interpret=True, optimizer=optax.sgd(LR), **kws)
    jp1, _, jl = jstep(jp, jo, 0)
    tstep, (tp, to) = tinv.make_fused_train_step(
        ts, tc, target, optimizer=optim.scale(-LR), device="cpu", **kws)
    tp1, _, tl = tstep(tp, to, 0)
    p0 = {k: np.asarray(v) for k, v in jp.items()}
    return (trainable, p0, (float(jl), {k: np.asarray(v) for k, v in
                                        jp1.items()}),
            (float(tl), {k: v.numpy() for k, v in tp1.items()}))


def test_fused_step_loss_matches_jax(step_pair):
    _, _, (jl, _), (tl, _) = step_pair
    assert abs(tl - jl) <= 1e-4 * jl


@pytest.mark.parametrize("field", tpar.FLOAT_FIELDS)
def test_fused_step_params_match_jax(step_pair, field):
    trainable, p0, (_, jp1), (_, tp1) = step_pair
    want, got = jp1[field] - p0[field], tp1[field] - p0[field]
    if field not in trainable:
        assert not got.any() and not want.any()
        return
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= STEP_RTOL * scale, (
        np.abs(got - want).max() / scale)


def test_fused_step_grad_chunks_is_median_of_chunks():
    """grad_chunks=2: the chunks run samples [0, 2) and [2, 4) of the
    step; the update is the elementwise median of their gradients (the
    mean of two) and the loss the mean of their losses."""
    tw, tc, kw = tpresets.cornell_spheres(width=8, height=8)
    scene = tw.build()
    target = torch.from_numpy(np.random.RandomState(3).rand(
        8, 8, 3).astype(np.float32))
    common = dict(spp=4, max_bounces=2, background=kw["background"], seed=1,
                  optimizer=optim.scale(-LR), trainable=("mat_albedo",),
                  device="cpu")
    step, (p, o) = tinv.make_fused_train_step(scene, tc, target,
                                              grad_chunks=2, **common)
    p1, _, loss = step(p, o, 1)
    chunks = [tdk.render_value_and_grad(
        scene, tc, target, spp=2, max_bounces=2,
        background=kw["background"], seed=1, spp_offset=4 + 2 * c,
        silhouette=False, surr_rows={"sph": (), "quad": ()})
        for c in range(2)]
    g = tinv._median0(torch.stack([c[2]["mat_albedo"] for c in chunks]))
    assert torch.equal(loss, (chunks[0][0] + chunks[1][0]) / 2)
    assert torch.equal(p1["mat_albedo"], p["mat_albedo"] + (-LR) * g)
    assert torch.equal(p1["sph_center"], p["sph_center"])
    with pytest.raises(ValueError, match="divide"):
        tinv.make_fused_train_step(scene, tc, target, grad_chunks=3,
                                   **common)


def _n_prims(n_sph, n_quad=0, n_mat=1):
    from tinyraytracer_tpu_torch.models.geometry import Quad, Sphere
    from tinyraytracer_tpu_torch.models.materials import Lambertian
    from tinyraytracer_tpu_torch.models.world import World

    w = World()
    w.add_material("white", Lambertian((0.7, 0.7, 0.7)))
    for m in range(1, n_mat):
        w.add_material(f"unused{m}", Lambertian((0.5, 0.5, 0.5)))
    for i in range(n_sph):
        w.add_geometry(Sphere((float(i), 0.0, -4.0), 0.3, "white"))
    for j in range(n_quad):
        w.add_geometry(Quad((float(j), 1.0, -4.0), (0.5, 0.0, 0.0),
                            (0.0, 0.5, 0.0), "white"))
    return w.build()


@pytest.mark.parametrize("case", ["rows", "prims", "spheres", "palette",
                                  "mesh"])
def test_classic_kernel_cases_raise_not_implemented(case, monkeypatch):
    """What the JAX package sends to its classic kernel K4 (an explicit
    surrogate row subset, more than 48 primitives, more than 16 spheres)
    runs on the port's K4 (`classic_diff`; its twin on the CPU), and so
    does a scene whose gradients overflow the CUDA K5's accumulator (131
    materials: 1 100 floats), on every device; each gives a finite
    result. The sharded route runs too: a row subset over a two-cell CPU
    mesh launches K4 once per cell and gives the one-device result (the
    loss within 1e-6, the image bit for bit, each field within 1e-5 of
    its largest entry: tests/test_diffkernel.py's mesh tolerances)."""
    tw, tc, kw = tpresets.cornell_spheres(width=4, height=4)
    scene, kwargs = tw.build(), {}
    rows = {"sph": (int(np.flatnonzero(scene.sph_valid.numpy())[0]),),
            "quad": ()}
    if case == "rows":
        kwargs = dict(surr_rows=rows)
    elif case == "prims":
        scene = _n_prims(2, 47)
    elif case == "spheres":
        scene = _n_prims(17)
    elif case == "palette":
        scene = _n_prims(2, n_mat=131)
    else:
        kwargs = dict(surr_rows=rows, mesh=make_mesh(["cpu", "cpu"]))
    call = lambda **o: tdk.render_value_and_grad(  # noqa: E731
        scene, tc, torch.zeros(4, 4, 3), spp=1, max_bounces=1,
        background=kw["background"], **{**kwargs, **o})
    calls = []
    real = tdk.classic_diff
    monkeypatch.setattr(tdk, "classic_diff",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, img, grads = call()
    assert calls == [1] * (2 if case == "mesh" else 1)
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(img).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    if case == "mesh":
        one_loss, one_img, one = call(mesh=None)
        assert abs(float(loss) - float(one_loss)) <= 1e-6 * float(one_loss)
        assert torch.equal(img, one_img)
        for k, g in one.items():
            scale = max(float(g.abs().max()), 1e-8)
            assert float((grads[k] - g).abs().max()) <= 1e-5 * scale, k


def test_fused_step_unported_options_and_sky_raise():
    tw, tc, kw = tpresets.cornell_spheres(width=4, height=4)
    scene, target = tw.build(), torch.zeros(4, 4, 3)
    common = dict(spp=1, max_bounces=1, background=kw["background"],
                  device="cpu")
    # the sharded step is ported: over a (1 x 2) CPU mesh it takes the
    # one-device step's loss and params (tests/test_diff.py's mesh
    # tolerances)
    mstep, (mp, mo) = tinv.make_fused_train_step(
        scene, tc, target, mesh=make_mesh(["cpu", "cpu"], sample_parallel=2),
        **{k: v for k, v in common.items() if k != "device"})
    mp, mo, mloss = mstep(mp, mo, 0)
    ostep, (op_, oo) = tinv.make_fused_train_step(scene, tc, target,
                                                  **common)
    op_, oo, oloss = ostep(op_, oo, 0)
    assert mloss.device.type == "cpu"
    assert abs(float(mloss) - float(oloss)) <= 1e-6 * float(oloss)
    for k in op_:
        torch.testing.assert_close(mp[k], op_[k], rtol=1e-3, atol=1e-6)
    sky = ((0.5, 0.7, 1.0), (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="constant backgrounds"):
        tdk.render_value_and_grad(scene, tc, target, spp=1, max_bounces=1,
                                  background=sky)
    step, (p, o) = tinv.make_fused_train_step(
        scene, tc, target, **{**common, "background": sky})
    with pytest.raises(ValueError, match="constant backgrounds"):
        step(p, o, 0)


def test_fit_auto_engine_routes(monkeypatch):
    """`routes_packed` is the packed route's one rule; fit(engine="auto")
    takes the modular step on the CPU, and engine="fused" runs the fused
    step there on the twin."""
    tw, tc, kw = tpresets.cornell_spheres(width=4, height=4)
    st = tdk.build_diff_static(tw.build())
    assert tdk.routes_packed(st, kw["background"])
    assert not tdk.routes_packed(st, ((0.5, 0.7, 1.0), (1.0, 1.0, 1.0)))
    for scene in (_n_prims(17), _n_prims(2, 47), _n_prims(2, n_mat=131)):
        assert not tdk.routes_packed(tdk.build_diff_static(scene),
                                     kw["background"])
    # the most primitives K5 takes: 16 spheres and 32 quads (420 floats)
    assert tdk.routes_packed(tdk.build_diff_static(_n_prims(16, 32)),
                             kw["background"])
    kws = dict(steps=1, spp=1, max_bounces=2, background=kw["background"],
               trainable=("mat_albedo",), device="cpu")
    _, losses = tinv.fit(tw.build(), tc, torch.zeros(4, 4, 3),
                         engine="fused", **kws)
    assert len(losses) == 1 and np.isfinite(losses[0])

    def refuse(*a, **k):
        raise AssertionError("auto chose the fused step on the CPU")

    monkeypatch.setattr(tinv, "make_fused_train_step", refuse)
    _, losses = tinv.fit(tw.build(), tc, torch.zeros(4, 4, 3),
                         engine="auto", **kws)
    assert len(losses) == 1 and np.isfinite(losses[0])
