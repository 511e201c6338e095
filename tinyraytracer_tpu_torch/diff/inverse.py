"""Inverse rendering: gradient-descent recovery of scene parameters (port
of the modular half of diff/inverse.py).

BASELINE config 5: recover Cornell sphere positions and albedos from a
target image. The loss renders with the modular differentiable tracer
(ops/trace.py) with NEE and the silhouette surrogate on, a fresh sample
round per step; on a CUDA device the closest-hit selections run on kernel
K3 (ops/intersect_kernel.py) over a host-compacted snapshot of the scene.

How the gradient is taken. Eager autograd over every sample round of a
step would keep each round's graph (hundreds of (R,) tensors per bounce,
R = 720 000 rays at config 5) until the loss is known. `render_loss` is
instead an autograd function with two passes: its forward renders every
round without a graph and records each round's detached selections; its
backward forms the image cotangent 2 (img - target) / (3 npix), then
rebuilds one round's graph at a time, replaying that round's selections,
and backpropagates cotangent / spp into the parameters. The forward
values of the replay are those of the first pass, so the gradient is the
single-pass gradient up to summation order, and K3 runs twice per bounce
per round, as in the JAX step that saves only the selections.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional, Tuple

import torch

from tinyraytracer_tpu_torch.diff import optim
from tinyraytracer_tpu_torch.diff.params import (
    FLOAT_FIELDS,
    Params,
    apply_params,
    scene_params,
)
from tinyraytracer_tpu_torch.models.camera import Camera, generate_rays
from tinyraytracer_tpu_torch.ops import trace as trace_ops
from tinyraytracer_tpu_torch.ops.intersect_kernel import compact_rows
from tinyraytracer_tpu_torch.renderer import resolve_device

_MASK = 0xFFFFFFFF

# The backward pass rebuilds a round's graph in slices of rays small
# enough that one slice's saved tensors fit this budget. Saved bytes per
# ray and bounce, with NEE and the silhouette surrogate on a config-5
# scene (2 spheres, 6 quads), measured on the CPU with
# saved_tensors_hooks: 1 906.
_GRAD_BYTES_BUDGET = 32 << 30
_GRAD_BYTES_PER_RAY_BOUNCE = 2048


def image_mse(img, target):
    """Mean squared error in linear radiance."""
    return torch.mean((img - target) ** 2)


def adaptive_clip(threshold: float = 4.0, decay: float = 0.9,
                  eps: float = 1e-12) -> optim.GradientTransformation:
    """Clip each gradient leaf to `threshold` x its own running RMS norm.

    An EMA of each leaf's gradient norm is tracked (the first three
    updates only track), and a leaf is rescaled whenever its norm exceeds
    threshold x EMA; the EMA updates with the clipped norm, so one spike
    cannot ratchet the gate open. Chain it in front of Adam."""

    def init(params):
        dev = next(iter(params.values())).device
        return {"ema": {k: torch.zeros((), dtype=torch.float32, device=dev)
                        for k in params},
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(updates, state, params=None):
        del params
        count = state["count"] + 1
        warm = count <= 3  # track-only warmup: no trusted scale yet
        new_updates, new_ema = {}, {}
        for k, g in updates.items():
            ema = state["ema"][k]
            n = torch.sqrt(torch.sum(g.to(torch.float32) ** 2) + eps)
            limit = threshold * ema
            trust = warm | (ema <= eps)
            scale = torch.where(trust | (n <= limit), 1.0, limit / n)
            new_updates[k] = g * scale
            n_clip = torch.minimum(n, torch.where(trust, n, limit))
            new_ema[k] = torch.where(count == 1, n_clip,
                                     decay * ema + (1.0 - decay) * n_clip)
        return new_updates, {"ema": new_ema, "count": count}

    return optim.GradientTransformation(init, update)


class _LossRun:
    """One render_loss call's settings, shared by its two passes."""

    def __init__(self, scene, camera, target, spp, max_bounces, background,
                 seed, spp_offset, exact, nee, silhouette, compact):
        self.dev = scene.sph_center.device
        self.scene, self.camera = scene, camera.to(self.dev)
        self.target = torch.as_tensor(target, dtype=torch.float32,
                                      device=self.dev).reshape(-1, 3)
        self.background = torch.as_tensor(background, dtype=torch.float32,
                                          device=self.dev)
        self.kw = dict(max_bounces=max_bounces, exact=exact, nee=nee,
                       silhouette=silhouette, compact=compact)
        self.spp, self.seed = spp, seed
        self.spp_offset = int(spp_offset) & _MASK
        w, h = self.camera.width, self.camera.height
        self.pixel_id = torch.arange(w * h, dtype=torch.int64,
                                     device=self.dev)
        self.rows = (trace_ops.scene_rows(scene) if nee or silhouette
                     else None)

    def render(self, values, tapes):
        s = apply_params(self.scene, dict(zip(FLOAT_FIELDS, values)))
        return trace_ops.render_pixels(
            s, self.camera, self.pixel_id, spp=self.spp,
            background=self.background, seed=self.seed,
            spp_offset=self.spp_offset, fuse_spp=True, tapes=tapes,
            rows=self.rows, **self.kw)

    def backprop(self, values, tapes, cot_pixel):
        """Rebuild each round's graph from its replayed selections and
        backpropagate the per-ray cotangent; returns the gradients."""
        leaves = [v.detach().requires_grad_(True) for v in values]
        s = apply_params(self.scene, dict(zip(FLOAT_FIELDS, leaves)))
        npix = self.pixel_id.shape[0]
        chunk, rounds = trace_ops.sample_rounds(npix, self.spp, True)
        cot = cot_pixel.repeat(chunk, 1) if chunk > 1 else cot_pixel
        kw = dict(self.kw)
        max_bounces = kw.pop("max_bounces")
        n_rays = npix * chunk
        per_ray = max(max_bounces, 1) * _GRAD_BYTES_PER_RAY_BOUNCE
        pieces = -(-n_rays * per_ray // _GRAD_BYTES_BUDGET)
        step = -(-n_rays // pieces)
        with torch.enable_grad():
            for k in range(rounds):
                pid, sid = trace_ops.round_ids(
                    self.pixel_id, chunk, k * chunk + self.spp_offset)
                for a in range(0, n_rays, step):
                    rays = slice(a, a + step)
                    p, q = pid[rays], sid
                    if isinstance(sid, torch.Tensor):
                        q = sid[rays]
                    o, d = generate_rays(self.camera, p, q, self.seed)
                    c = trace_ops.trace(
                        s, o, d, p, q, self.seed, max_bounces,
                        self.background, remat=False,
                        tape=tapes[k].replay(rays), rows=self.rows, **kw)
                    torch.autograd.backward(c, cot[rays])
        return [torch.zeros_like(v) if v.grad is None else v.grad
                for v in leaves]


class _RenderLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _LossRun, *values):
        tapes: list = []
        img = run.render(values, tapes)
        ctx.run, ctx.tapes, ctx.img = run, tapes, img
        ctx.save_for_backward(*values)
        return image_mse(img, run.target)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        run = ctx.run
        n = ctx.img.numel()
        # d mean((img - t)^2) / d img, then / spp for each sample's ray
        cot = (g / n) * (2.0 * (ctx.img - run.target)) / float(run.spp)
        grads = run.backprop(ctx.saved_tensors, ctx.tapes, cot)
        ctx.tapes = ctx.img = None
        return (None, *grads)


def render_loss(params: Params, scene, camera: Camera, target, *, spp: int,
                max_bounces: int, background, seed, spp_offset=0,
                exact: bool = False, nee: bool = True,
                silhouette: bool = True, compact=None) -> torch.Tensor:
    """Single-device MSE between a fresh render and the target image, on
    the device of the scene; differentiable in `params` (see the module
    docstring for how). NEE is on by default: without explicit light
    sampling the pathwise gradient w.r.t. geometry is zero almost
    everywhere. `compact` (intersect_kernel.CompactRows) moves the
    closest-hit selections onto K3."""
    run = _LossRun(scene, camera, target, spp, max_bounces, background,
                   seed, spp_offset, exact, nee, silhouette, compact)
    return _RenderLoss.apply(run, *(params[f] for f in FLOAT_FIELDS))


def value_and_grad(loss_fn: Callable, params: Params, *args, wrt=None):
    """(loss, grads) of `loss_fn(params, *args)`, like jax.value_and_grad;
    the loss is a detached 0-dim tensor. Gradients are taken w.r.t. the
    fields named in `wrt` (default: all); the other fields, and a field
    the loss does not reach, get zeros. Leaving a field out prunes the
    backward branches that lead only to it, as XLA drops the gradients a
    JAX step discards."""
    wrt = set(params) if wrt is None else set(wrt)
    leaves = {k: v.detach().requires_grad_(k in wrt)
              for k, v in params.items()}
    free = [k for k in leaves if k in wrt]
    with torch.enable_grad():
        loss = loss_fn(leaves, *args)
        gs = torch.autograd.grad(loss, [leaves[k] for k in free],
                                 allow_unused=True)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for k, g in zip(free, gs):
        if g is not None:
            grads[k] = g
    return loss.detach(), grads


def _median0(x: torch.Tensor) -> torch.Tensor:
    """jnp.median(x, axis=0): the mean of the two middle values (method
    'midpoint'); NaN wherever a value along axis 0 is NaN."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(dim=0), float("nan"), med)


def make_train_step(
    scene_template,
    camera: Camera,
    target,
    *,
    spp: int,
    max_bounces: int,
    background,
    seed: int = 0,
    optimizer: Optional[optim.GradientTransformation] = None,
    learning_rate: float = 1e-2,
    mesh=None,
    advance_samples: bool = True,
    trainable: Optional[Tuple[str, ...]] = None,
    nee: bool = True,
    silhouette: bool = True,
    use_kernel: Optional[bool] = None,
    grad_chunks: int = 1,
    device="cuda",
):
    """Build an Adam step over the scene params, on `device`.

    Returns (step, (params0, opt_state0)); step(params, opt_state,
    step_idx, compact=compact0) -> (params, opt_state, loss), the loss a
    0-dim device tensor (reading it is the step's only synchronisation).

    `use_kernel` (default: the device is CUDA) selects the closest hits
    with K3 over a compacted snapshot of the scene, passed as the step's
    `compact` argument: selection is detached and t is recomputed from
    the live params, so callers fitting geometry refresh it every few
    steps (`refresh_compact`). `advance_samples` draws a fresh sample
    round each step (true SGD over the expected loss). `trainable` names
    the free fields; the others' gradients are zeroed. `grad_chunks` > 1
    splits spp into chunks and takes the elementwise median of the chunk
    gradients. Non-finite gradient entries are zeroed before the update.
    `mesh` (sharded training) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (parallel/sharded.py) is not ported yet")
    dev = resolve_device(device)
    optimizer = optimizer or optim.adam(learning_rate)
    scene = scene_template.to(dev)
    camera = camera.to(dev)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    background = torch.as_tensor(background, dtype=torch.float32).to(dev)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    compact0 = compact_rows(scene, dev) if use_kernel else None

    if grad_chunks < 1:
        raise ValueError("grad_chunks must be >= 1")
    if spp % grad_chunks:
        raise ValueError(f"grad_chunks={grad_chunks} must divide spp={spp}")
    stride = spp if advance_samples else 0
    trainset = None if trainable is None else frozenset(trainable)

    def loss_fn(params, spp_eff, offset, compact):
        return render_loss(params, scene, camera, target, spp=spp_eff,
                           max_bounces=max_bounces, background=background,
                           seed=seed, spp_offset=offset, nee=nee,
                           silhouette=silhouette, compact=compact)

    def step(params, opt_state, step_idx, compact=compact0):
        base = int(step_idx) * stride
        if grad_chunks == 1:
            loss, grads = value_and_grad(loss_fn, params, spp, base & _MASK,
                                         compact, wrt=trainset)
        else:
            cspp = spp // grad_chunks
            losses, gs = [], []
            for c in range(grad_chunks):
                cl, cg = value_and_grad(loss_fn, params, cspp,
                                        (base + c * cspp) & _MASK, compact,
                                        wrt=trainset)
                losses.append(cl)
                gs.append(cg)
            loss = sum(losses) / grad_chunks
            grads = {k: _median0(torch.stack([g[k] for g in gs]))
                     for k in gs[0]}
        # a rare degenerate sample must not poison the optimizer state
        grads = {k: torch.where(torch.isfinite(g), g, 0.0)
                 for k, g in grads.items()}
        if trainset is not None:
            grads = {k: g if k in trainset else torch.zeros_like(g)
                     for k, g in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, loss

    params0 = scene_params(scene)
    return step, (params0, optimizer.init(params0))


def refresh_compact(scene_template, params: Params):
    """Host compaction snapshot of the current fit state, for passing back
    into a kernel-selected train step (see make_train_step), on the
    params' device."""
    return compact_rows(apply_params(scene_template, params),
                        next(iter(params.values())).device)


# --- checkpoint / resume --------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def save_checkpoint(path: str, params: Params, opt_state, step: int) -> None:
    """Persist optimizer progress as numpy arrays; an atomic rename keeps
    a crash from corrupting the file."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    state = {"params": _tree_map(host, params),
             "opt_state": _tree_map(host, opt_state), "step": int(step)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda"):
    """(params, opt_state, step) with every array as a tensor on
    `device`."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (_tree_map(put, state["params"]),
            _tree_map(put, state["opt_state"]), state["step"])


_GEOMETRY_FIELDS = frozenset(
    ("sph_center", "sph_radius", "quad_corner", "quad_u", "quad_v"))


def fit(
    scene_template,
    camera: Camera,
    target,
    *,
    steps: int,
    spp: int,
    max_bounces: int,
    background,
    seed: int = 0,
    learning_rate: float = 1e-2,
    optimizer: Optional[optim.GradientTransformation] = None,
    trainable: Optional[Tuple[str, ...]] = None,
    trainable_rows: Optional[dict] = None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    refresh_compact_every: int = 10,
    log_every: int = 0,
    average_last: int = 0,
    engine: str = "auto",
    device="cuda",
):
    """Run `steps` of Adam on the scene params; returns (scene, losses).

    `engine`: "modular" (and "auto", which picks it) runs the autodiff
    step of `make_train_step`; "fused" needs kernel K5
    (ops/diffkernel_packed.py), which is not ported. With K3 in use and
    geometry trainable, the compacted selection snapshot is refreshed
    every `refresh_compact_every` steps. Resumes from `checkpoint_path`
    if it exists. `average_last` > 0 returns the mean of the last N
    iterates."""
    if engine not in ("auto", "fused", "modular"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "fused":
        raise NotImplementedError(
            "engine='fused' needs the fused differentiable kernel K5 "
            "(ops/diffkernel_packed.py), which is not ported yet")
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (parallel/sharded.py) is not ported yet")
    if trainable_rows is not None:
        raise ValueError(
            "trainable_rows requires the fused engine (the modular path "
            "has no row-subset surrogate mode)")
    dev = resolve_device(device)
    step_fn, (params, opt_state) = make_train_step(
        scene_template, camera, target, spp=spp, max_bounces=max_bounces,
        background=background, seed=seed, learning_rate=learning_rate,
        optimizer=optimizer, trainable=trainable, device=dev)
    scene_template = scene_template.to(dev)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        params, opt_state, start = load_checkpoint(checkpoint_path, dev)
    fits_geometry = trainable is None or bool(
        _GEOMETRY_FIELDS & set(trainable))
    use_kernel = dev.type == "cuda"
    compact = refresh_compact(scene_template, params) if use_kernel else None
    losses = []
    avg_from = max(start, steps - average_last) if average_last else steps
    avg_params, avg_n = None, 0
    for i in range(start, steps):
        if (use_kernel and fits_geometry and i > start
                and refresh_compact_every
                and i % refresh_compact_every == 0):
            compact = refresh_compact(scene_template, params)
        params, opt_state, loss = step_fn(params, opt_state, i, compact)
        # keep the device scalar: reading it here would synchronise
        losses.append(loss)
        if i >= avg_from:
            avg_n += 1
            if avg_params is None:
                avg_params = dict(params)
            else:
                avg_params = {k: v + (params[k] - v) / avg_n
                              for k, v in avg_params.items()}
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps}  loss {float(loss):.6f}")
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, opt_state, i + 1)
    if avg_params is not None:
        params = avg_params
    return apply_params(scene_template, params), [float(x) for x in losses]
