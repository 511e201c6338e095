"""The PyTorch port's differentiable path (diff/) against the JAX package:
the training loss and its gradients, three Adam steps of the modular
train step, the optimizer, checkpoints and `fit`.

Scene: cornell_spheres (BASELINE config 5) at 8x8, spp=2, max_bounces=4,
NEE and the silhouette surrogate on. Inputs (targets, perturbations,
gradients) are made with numpy from a seed. Torch runs single-threaded
here (see tests/test_torch_intersect.py).

Tolerances, with what was measured:
  - loss: LOSS_RTOL (9e-8);
  - gradients, per field, max |d| <= GRAD_RTOL[field] x max |g|
    (geometry 1.2e-5, materials 6e-7: sums over every ray in another
    order, and ulps of the transcendentals);
  - three steps at learning rate LR: each parameter's move within
    STEP_ATOL (1.9e-6; a gradient element near zero could flip Adam's
    first step by 2 LR, which this seed does not have);
  - optimizer: OPT_RTOL (bias corrections use powf: 1 ulp).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinyraytracer_tpu.diff import inverse as jinv
from tinyraytracer_tpu.diff import params as jpar
from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu_torch.diff import inverse as tinv
from tinyraytracer_tpu_torch.diff import optim
from tinyraytracer_tpu_torch.diff import params as tpar
from tinyraytracer_tpu_torch.models import presets as tpresets

W = H = 8
SPP, MB, LR = 2, 4, 1e-2
TRAINABLE = ("sph_center", "mat_albedo")
LOSS_RTOL = 1e-5
GRAD_RTOL = {"sph_center": 5e-5, "sph_radius": 5e-5, "quad_corner": 5e-5,
             "quad_u": 5e-5, "quad_v": 5e-5, "mat_albedo": 5e-6,
             "mat_fuzz": 5e-6, "mat_ior": 5e-6, "mat_emit": 5e-6}
STEP_ATOL = 1e-4
OPT_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cornell():
    jw, jc, kw = jpresets.cornell_spheres(width=W, height=H)
    tw, tc, _ = tpresets.cornell_spheres(width=W, height=H)
    target = np.random.RandomState(0).uniform(0, 0.3, (H, W, 3)).astype(
        np.float32)
    return jw.build(), jc, tw.build(), tc, kw["background"], target


def test_params_from_numpy_keeps_bits_and_checks(cornell):
    js = cornell[0]
    arrays = {k: np.array(v) for k, v in jpar.scene_params(js).items()}
    p = tpar.params_from_numpy(arrays, "cpu")
    assert tuple(p) == tpar.FLOAT_FIELDS
    for k in tpar.FLOAT_FIELDS:
        np.testing.assert_array_equal(p[k].numpy().view(np.int32),
                                      arrays[k].view(np.int32))
    arrays["sph_center"][0, 0] = 123.0        # an own copy was taken
    assert float(p["sph_center"][0, 0]) != 123.0
    with pytest.raises(KeyError):
        tpar.params_from_numpy({k: v for k, v in arrays.items()
                                if k != "mat_ior"}, "cpu")
    with pytest.raises(TypeError):
        tpar.params_from_numpy({**arrays, "mat_fuzz":
                                arrays["mat_fuzz"].astype(np.float64)}, "cpu")


def test_render_loss_value_and_gradients_match_jax(cornell):
    """jax.value_and_grad(inverse.render_loss) against the port's
    two-pass autograd function, every field, spheres moved off their
    rest positions."""
    js, jc, ts, tc, bg, target = cornell
    move = np.random.RandomState(1).normal(0, 2, (2, 3)).astype(np.float32)
    jp = dict(jpar.scene_params(js))
    jp["sph_center"] = jp["sph_center"].at[:2].add(jnp.asarray(move))
    jl, jg = jax.value_and_grad(jinv.render_loss)(
        jp, js, jc, jnp.asarray(target), spp=SPP, max_bounces=MB,
        background=jnp.asarray(bg), seed=jnp.uint32(3))
    tp = tpar.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                "cpu")
    tl, tg = tinv.value_and_grad(
        lambda p: tinv.render_loss(p, ts, tc, target, spp=SPP,
                                   max_bounces=MB, background=bg, seed=3),
        tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for k in tpar.FLOAT_FIELDS:
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(tg[k].numpy() - want).max() <= GRAD_RTOL[k] * scale, k
    assert np.abs(np.asarray(jg["sph_center"])).max() > 0


def test_backward_in_ray_slices_gives_the_same_gradient(cornell,
                                                       monkeypatch):
    """Above the memory budget the backward pass rebuilds a round in
    slices of rays; each ray's cotangent is its own, so only the order of
    the sums changes (to 1e-6 of each field's largest entry)."""
    _, _, ts, tc, bg, target = cornell
    p = tpar.scene_params(ts)

    def grads():
        return tinv.value_and_grad(
            lambda q: tinv.render_loss(q, ts, tc, target, spp=SPP,
                                       max_bounces=MB, background=bg,
                                       seed=5), p)[1]

    whole = grads()
    # 3 slices of the round's 128 rays
    monkeypatch.setattr(tinv, "_GRAD_BYTES_BUDGET",
                        50 * MB * tinv._GRAD_BYTES_PER_RAY_BOUNCE)
    sliced = grads()
    for k in tpar.FLOAT_FIELDS:
        scale = float(whole[k].abs().max())
        assert float((whole[k] - sliced[k]).abs().max()) <= 1e-6 * scale, k
    assert float(whole["sph_center"].abs().max()) > 0


@pytest.fixture(scope="module")
def jax_three_steps(cornell):
    js, jc, _, _, bg, target = cornell
    step, (p, o) = jinv.make_train_step(
        js, jc, jnp.asarray(target), spp=SPP, max_bounces=MB, background=bg,
        seed=1, trainable=TRAINABLE, use_kernel=False, learning_rate=LR)
    p0 = {k: np.asarray(v) for k, v in p.items()}
    losses = []
    for i in range(3):
        p, o, loss = step(p, o, i)
        losses.append(float(loss))
    return p0, {k: np.asarray(v) for k, v in p.items()}, losses


@pytest.mark.parametrize("selection", ["dense", "k3_twin"])
def test_three_train_steps_match_jax(cornell, jax_three_steps, selection):
    """make_train_step against JAX's with use_kernel=False. The K3-twin
    run gets a fresh compaction each step (fit's refresh at every step),
    so both select on the live geometry."""
    _, _, ts, tc, bg, target = cornell
    p0, want, want_losses = jax_three_steps
    step, (p, o) = tinv.make_train_step(
        ts, tc, target, spp=SPP, max_bounces=MB, background=bg, seed=1,
        trainable=TRAINABLE, use_kernel=selection == "k3_twin",
        learning_rate=LR, device="cpu")
    for i in range(3):
        if selection == "k3_twin":
            p, o, loss = step(p, o, i, tinv.refresh_compact(ts, p))
        else:
            p, o, loss = step(p, o, i)
        np.testing.assert_allclose(float(loss), want_losses[i],
                                   rtol=LOSS_RTOL)
    for k in tpar.FLOAT_FIELDS:
        np.testing.assert_allclose(p[k].numpy() - p0[k], want[k] - p0[k],
                                   rtol=0, atol=STEP_ATOL, err_msg=k)
    moved = np.abs(p["sph_center"].numpy() - p0["sph_center"]).max()
    assert moved > 2 * LR            # three steps did move the spheres


def test_adam_and_adaptive_clip_match_optax():
    rs = np.random.RandomState(4)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rs.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rs.normal(size=s) * 10 ** rs.uniform(-3, 2)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(5)]
    grads[4]["a"] *= 100.0                        # a spike to clip
    jopt = optax.chain(jinv.adaptive_clip(), optax.adam(LR))
    topt = optim.chain(tinv.adaptive_clip(), optim.adam(LR))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js_, ts_ = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js_ = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js_,
                              jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts_ = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              ts_, tp)
        tp = optim.apply_updates(tp, tu)
        for k in shapes:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=OPT_RTOL, atol=1e-12)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=OPT_RTOL)
    clip_state = ts_[0]
    assert int(clip_state["count"]) == 5


@pytest.mark.parametrize("n", [3, 4])
def test_grad_chunk_median_is_jnp_median(n):
    x = np.random.RandomState(n).normal(size=(n, 6, 3)).astype(np.float32)
    x[0, 0, 0] = np.nan
    want = np.asarray(jnp.median(jnp.asarray(x), axis=0))
    got = tinv._median0(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_checkpoint_round_trip(cornell, tmp_path):
    _, _, ts, tc, bg, target = cornell
    step, (p, o) = tinv.make_train_step(
        ts, tc, target, spp=SPP, max_bounces=2, background=bg,
        trainable=TRAINABLE, device="cpu")
    p, o, _ = step(p, o, 0)
    path = str(tmp_path / "fit.ckpt")
    tinv.save_checkpoint(path, p, o, 1)
    p2, o2, n = tinv.load_checkpoint(path, device="cpu")
    assert n == 1 and not os.path.exists(path + ".tmp")
    for k in p:
        assert torch.equal(p[k], p2[k])
    assert type(o2[0]) is type(o[0]) and int(o2[0].count) == 1
    for k in p:
        assert torch.equal(o[0].mu[k], o2[0].mu[k])
        assert torch.equal(o[0].nu[k], o2[0].nu[k])


def test_fit_engines_devices_and_resume(cornell, tmp_path, monkeypatch):
    _, _, ts, tc, bg, target = cornell
    kw = dict(spp=SPP, max_bounces=2, background=bg, trainable=TRAINABLE)
    row = int(np.flatnonzero(ts.sph_valid.numpy())[0])
    pinned, losses = tinv.fit(ts, tc, target, steps=1, engine="fused",
                              device="cpu", trainable_rows={"sph": (row,)},
                              **kw)
    assert len(losses) == 1 and np.isfinite(losses[0])
    others = torch.arange(ts.sph_center.shape[0]) != row
    assert torch.equal(pinned.sph_center[others], ts.sph_center[others])
    with pytest.raises(NotImplementedError, match="sharded"):
        tinv.fit(ts, tc, target, steps=1, mesh=object(), device="cpu", **kw)
    with pytest.raises(ValueError):
        tinv.fit(ts, tc, target, steps=1, engine="warp", device="cpu", **kw)
    path = str(tmp_path / "fit.ckpt")
    scene, losses = tinv.fit(ts, tc, target, steps=2, device="cpu",
                             checkpoint_path=path, checkpoint_every=2, **kw)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert not torch.equal(scene.sph_center, ts.sph_center)
    assert torch.equal(scene.quad_corner, ts.quad_corner)     # not trained
    _, more = tinv.fit(ts, tc, target, steps=3, device="cpu",
                       checkpoint_path=path, **kw)
    assert len(more) == 1                     # resumed at step 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinv.make_train_step(ts, tc, target, **kw)


def test_train_step_imports_no_jax_or_optax():
    """With jax and optax unimportable, the port's training path imports
    and takes a step on the CPU, and no JAX module gets loaded."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['optax'] = None\n"
        "import torch\n"
        "from tinyraytracer_tpu_torch.diff import inverse, optim, params\n"
        "from tinyraytracer_tpu_torch.models import presets\n"
        "from tinyraytracer_tpu_torch.ops import intersect_kernel, trace\n"
        "w, c, kw = presets.cornell_spheres(width=4, height=4)\n"
        "step, (p, o) = inverse.make_train_step(w.build(), c,\n"
        "    torch.zeros(4, 4, 3), spp=1, max_bounces=2,\n"
        "    background=kw['background'], use_kernel=True, device='cpu')\n"
        "p, o, loss = step(p, o, 0)\n"
        "assert torch.isfinite(loss)\n"
        "bad = [m for m in sys.modules if m == 'tinyraytracer_tpu' or "
        "m.startswith(('tinyraytracer_tpu.', 'jax.', 'jaxlib', 'optax.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
