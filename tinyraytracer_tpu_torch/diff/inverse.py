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
`make_train_step` runs the same two passes through `mesh_value_and_grad`
(over a device mesh, or the one-cell mesh of one device), which forms the
cotangent itself; `render_loss` is the autograd form of the same loss.

`make_fused_train_step` is the other engine: the loss and every gradient
come out of one launch of a fused kernel per step, with the same
estimator and sample streams: K5 (ops/diffkernel_packed.py) for small
scenes, K4 (ops/diffkernel.classic_diff) for the rest and for
`trainable_rows`.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tinyraytracer_tpu_torch.diff import optim
from tinyraytracer_tpu_torch.diff.params import (
    FLOAT_FIELDS,
    Params,
    apply_params,
    scene_params,
)
from tinyraytracer_tpu_torch.models.camera import Camera, generate_rays
from tinyraytracer_tpu_torch.ops import diffkernel
from tinyraytracer_tpu_torch.ops import trace as trace_ops
from tinyraytracer_tpu_torch.ops.intersect_kernel import compact_rows
from tinyraytracer_tpu_torch.ops.scene_table import host_background
from tinyraytracer_tpu_torch.renderer import resolve_device
from tinyraytracer_tpu_torch.utils import profiling

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
    """One render_loss call's settings, shared by its two passes. With
    `pixels` (begin, count), a mesh shard's range of flat pixel ids, the
    run renders those pixels only, against those rows of the target."""

    def __init__(self, scene, camera, target, spp, max_bounces, background,
                 seed, spp_offset, exact, nee, silhouette, compact,
                 pixels=None):
        self.dev = scene.sph_center.device
        self.scene, self.camera = scene, camera.to(self.dev)
        w, h = self.camera.width, self.camera.height
        begin, count = (0, w * h) if pixels is None else pixels
        self.target = torch.as_tensor(target, dtype=torch.float32,
                                      device=self.dev).reshape(-1, 3)[
                                          begin:begin + count]
        self.background = torch.as_tensor(background, dtype=torch.float32,
                                          device=self.dev)
        self.kw = dict(max_bounces=max_bounces, exact=exact, nee=nee,
                       silhouette=silhouette, compact=compact)
        self.spp, self.seed = spp, seed
        self.spp_offset = int(spp_offset) & _MASK
        self.pixel_id = torch.arange(begin, begin + count, dtype=torch.int64,
                                     device=self.dev)
        self.rows = (trace_ops.scene_rows(scene) if nee or silhouette
                     else None)

    def render(self, values, tapes):
        """Pass 1: the image, with no graph (and so no per-bounce
        checkpointing), recording each round's selections in `tapes`."""
        s = apply_params(self.scene, dict(zip(FLOAT_FIELDS, values)))
        with torch.no_grad():
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


def _image_cotangent(img, target, n, spp, g=1.0):
    """g x d mean((img - target)^2) / d img over an image of n elements,
    then / spp for each sample's ray: the per-ray cotangent both passes
    backpropagate (a mesh cell's rows take the whole image's n)."""
    return (g / n) * (2.0 * (img - target)) / float(spp)


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
        cot = _image_cotangent(ctx.img, run.target, ctx.img.numel(),
                               run.spp, g)
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


def _compact_on(compact, dev):
    """The compaction snapshot `compact` (or None) with its tensors on
    `dev`."""
    if compact is None or compact.sph.device == dev:
        return compact
    return dataclasses.replace(compact, sph=compact.sph.to(dev),
                               quad=compact.quad.to(dev),
                               index_map=compact.index_map.to(dev))


def mesh_value_and_grad(mesh, params: Params, scene, camera: Camera,
                        target, *, spp: int, max_bounces: int, background,
                        seed, spp_offset=0, nee: bool = True,
                        silhouette: bool = True, compact=None):
    """(loss, grads) of the training MSE rendered over a (tile x sample)
    mesh (parallel/sharded.Mesh), on `mesh.device`; the same bits on every
    rank of a process group. The JAX package takes this gradient with
    jax.grad through shard_map (inverse.py:217-270); here the explicit
    cotangent does it, so no autograd passes through a collective:

    1. each cell renders its tile's pixel range (its sample shard: spp /
       n_sample samples from spp_offset + s * spp / n_sample) without a
       graph and records its selections (render_loss's pass 1);
    2. the cells' images are combined: each tile's sample shards summed
       in mesh order and divided by n_sample, the tiles gathered. The loss
       is the MSE of that image, Ī;
    3. each cell backpropagates 2 (Ī - target) / (N 3 spp) over its own
       rays (N the image's pixels: render_loss's cotangent with the whole
       image's counts), replaying its selections (pass 2);
    4. the cells' gradients are summed in mesh order.
    """
    from tinyraytracer_tpu_torch.parallel import sharded

    w, h = camera.width, camera.height
    n_sample = mesh.n_sample
    if spp % n_sample:
        raise ValueError(f"spp={spp} not divisible by sample axis "
                         f"{n_sample}")
    spp_local = spp // n_sample
    ranges = sharded.split_pixels(w * h, mesh.n_tile)
    runs, imgs = [], []
    for c in mesh.cells:
        dev = c.device
        run = _LossRun(scene.to(dev), camera, target, spp_local,
                       max_bounces, background, seed,
                       spp_offset + c.sample * spp_local, False, nee,
                       silhouette, _compact_on(compact, dev),
                       pixels=ranges[c.tile])
        values = [params[f].detach().to(dev) for f in FLOAT_FIELDS]
        tapes: list = []
        imgs.append(run.render(values, tapes))
        runs.append((run, values, tapes))
    img = mesh.image(imgs, ranges)
    tgt = torch.as_tensor(target, dtype=torch.float32,
                          device=img.device).reshape(-1, 3)
    loss = image_mse(img, tgt)
    n = img.numel()
    flats = []
    for c, (run, values, tapes) in zip(mesh.cells, runs):
        b, count = ranges[c.tile]
        rows = img[b:b + count].to(c.device)
        cot = _image_cotangent(rows, run.target, n, spp)
        grads = run.backprop(values, tapes, cot)
        flats.append(torch.cat([g.reshape(-1) for g in grads]))
    flat = mesh.sum(flats)
    sizes = [params[f].numel() for f in FLOAT_FIELDS]
    grads = {f: g.view(params[f].shape).to(params[f].device)
             for f, g in zip(FLOAT_FIELDS, torch.split(flat, sizes))}
    return loss.to(params[FLOAT_FIELDS[0]].device), grads


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

    The loss and gradients come from `mesh_value_and_grad` over `mesh`
    (parallel/sharded.Mesh): pixels shard over its tile axis and samples
    over its sample axis; the params and optimizer state live on the
    mesh's first device, which replaces `device`, and the gradients of
    all cells are summed before the sanitising and the update run once.
    Without a mesh the step runs on the one-cell mesh of `device`.
    `grad_chunks` > 1 with a mesh raises, as in the JAX package.
    """
    from tinyraytracer_tpu_torch.parallel import sharded

    if mesh is not None:
        if grad_chunks != 1:
            raise ValueError("grad_chunks needs the single-device path")
        device = mesh.device
    dev = resolve_device(device)
    if mesh is None:
        mesh = sharded.one_cell(dev)
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

    def loss_and_grads(params, spp_eff, offset, compact):
        return mesh_value_and_grad(
            mesh, params, scene, camera, target, spp=spp_eff,
            max_bounces=max_bounces, background=background, seed=seed,
            spp_offset=offset & _MASK, nee=nee, silhouette=silhouette,
            compact=compact)

    def step(params, opt_state, step_idx, compact=compact0):
        base = int(step_idx) * stride
        if grad_chunks == 1:
            loss, grads = loss_and_grads(params, spp, base, compact)
        else:
            cspp = spp // grad_chunks
            losses, gs = [], []
            for c in range(grad_chunks):
                cl, cg = loss_and_grads(params, cspp, base + c * cspp,
                                        compact)
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


def _surrogate_scope(trainset):
    """make_fused_train_step's class-level surrogate scope and silhouette
    switch from the trained fields. The silhouette feeds only geometry
    rows, so it is off when no geometry field trains; a class none of
    whose geometry fields train has its soft-shadow and silhouette chains
    dropped (they feed only rows the step zeroes, plus surrogate terms in
    the shared ray chain). This changes the gradients against the dense
    scope, as in the JAX package."""
    if trainset is None:
        return True, None
    sil = bool(_GEOMETRY_FIELDS & trainset)
    sph_geo = bool({"sph_center", "sph_radius"} & trainset)
    quad_geo = bool({"quad_corner", "quad_u", "quad_v"} & trainset)
    if sph_geo and quad_geo:
        return sil, None
    return sil, {"sph": None if sph_geo else (),
                 "quad": None if quad_geo else ()}


def make_fused_train_step(
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
    advance_samples: bool = True,
    trainable: Optional[Tuple[str, ...]] = None,
    trainable_rows: Optional[dict] = None,
    mesh=None,
    tile=None,
    grad_chunks: int = 1,
    static=None,
    device="cuda",
):
    """Adam step on the fused differentiable kernels, on `device`.

    Returns (step, (params0, opt_state0)); step(params, opt_state,
    step_idx) -> (params, opt_state, loss), the loss a 0-dim device
    tensor. The same estimator, sample streams and gradients as
    make_train_step(nee=True, silhouette=True), but render, loss and
    backward are one launch of K5 or K4 per step (per chunk with
    `grad_chunks`; diffkernel.render_value_and_grad routes); the scene
    table is rebuilt from the live params each step, so no compaction
    snapshot is needed.

    `trainable` names the free fields and also sets the surrogate scope
    (`_surrogate_scope`). `trainable_rows` ({"sph": scene rows, "quad":
    scene rows}) restricts geometry training to those rows: their
    surrogates run as an explicit subset on K4 (a class without listed
    rows is dropped), and every other row's geometry gradient is masked
    to zero, so the optimizer cannot move it. The soft-shadow ratio clamp
    then sees only the listed rows' visibility product, as in the JAX
    package (its inverse.py:385-391). `grad_chunks` > 1 splits spp into
    chunks run one after the other and takes the elementwise median of
    their gradients; the loss is then the mean of the chunk losses.
    Non-finite gradient entries are zeroed, the background gradient
    dropped, and untrained fields' gradients zeroed before the update.
    `static` is a precomputed diffkernel.build_diff_static(scene_template);
    `tile` is accepted and ignored. `mesh` (parallel/sharded.Mesh) splits
    each launch's pixels over every cell of the mesh and sums the
    gradient tables (diffkernel.render_value_and_grad); the params and
    optimizer state live on the mesh's first device, which replaces
    `device`.
    """
    if mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    optimizer = optimizer or optim.adam(learning_rate)
    scene = scene_template.to(dev)
    camera = camera.to(dev)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    background = host_background(background)    # read once, not per step
    if static is None:
        static = diffkernel.build_diff_static(scene)
    if grad_chunks < 1 or spp % grad_chunks:
        raise ValueError(f"grad_chunks={grad_chunks} must divide spp={spp}")
    cspp = spp // grad_chunks
    stride = spp if advance_samples else 0
    trainset = None if trainable is None else frozenset(trainable)
    sil, surr_rows = _surrogate_scope(trainset)
    row_mask = None
    if trainable_rows is not None:
        surr_rows = {k: tuple(int(r) for r in trainable_rows.get(k, ()))
                     for k in ("sph", "quad")}
        row_mask = _row_masks(scene, surr_rows, dev)

    def chunk(s, chunk_spp, offset):
        loss, _img, grads = diffkernel.render_value_and_grad(
            s, camera, target, spp=chunk_spp, max_bounces=max_bounces,
            background=background, seed=seed, spp_offset=offset & _MASK,
            silhouette=sil, static=static, tile=tile, surr_rows=surr_rows,
            mesh=mesh)
        return loss, grads

    def step(params, opt_state, step_idx):
        with profiling.annotate("tinyrt.train.step"):
            return _step(params, opt_state, step_idx)

    def _step(params, opt_state, step_idx):
        with profiling.annotate("tinyrt.train.table"):
            s = apply_params(scene, params)
        base = int(step_idx) * stride
        if grad_chunks == 1:
            loss, grads = chunk(s, spp, base)
        else:
            losses, gs = [], []
            for c in range(grad_chunks):
                cl, cg = chunk(s, cspp, base + c * cspp)
                losses.append(cl)
                gs.append(cg)
            loss = sum(losses) / grad_chunks
            grads = {k: _median0(torch.stack([g[k] for g in gs]))
                     for k in gs[0]}
        with profiling.annotate("tinyrt.train.grads"):
            grads = {k: torch.where(torch.isfinite(g), g, 0.0)
                     for k, g in grads.items() if k != "background"}
            if trainset is not None:
                grads = {k: g if k in trainset else torch.zeros_like(g)
                         for k, g in grads.items()}
            if row_mask is not None:
                grads = {k: g * row_mask[k] if k in row_mask else g
                         for k, g in grads.items()}
        with profiling.annotate("tinyrt.train.adam"):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optim.apply_updates(params, updates)
        return params, opt_state, loss

    params0 = scene_params(scene)
    return step, (params0, optimizer.init(params0))


def _row_masks(scene, rows: dict, dev) -> dict:
    """Per-row update masks over the scene's full row axes: 1 on the
    listed sphere / quad rows, 0 elsewhere, shaped to broadcast against
    each geometry field."""
    sm = torch.zeros(scene.sph_center.shape[0], dtype=torch.float32,
                     device=dev)
    sm[list(rows["sph"])] = 1.0
    qm = torch.zeros(scene.quad_corner.shape[0], dtype=torch.float32,
                     device=dev)
    qm[list(rows["quad"])] = 1.0
    return {"sph_center": sm[:, None], "sph_radius": sm,
            "quad_corner": qm[:, None], "quad_u": qm[:, None],
            "quad_v": qm[:, None]}


def refresh_compact(scene_template, params: Params):
    """Host compaction snapshot of the current fit state, for passing back
    into a kernel-selected train step (see make_train_step), on the
    params' device."""
    return compact_rows(apply_params(scene_template, params),
                        next(iter(params.values())).device)


# --- checkpoint / resume --------------------------------------------------

def _tree_map(fn, tree):
    """fn over the leaves of a tree of dicts, tuples and lists, called in
    jax.tree's leaf order (dict keys sorted); each dict keeps its key
    order."""
    if isinstance(tree, dict):
        mapped = {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: mapped[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


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


def load_checkpoint(path: str, opt_state_template=None, *, device=None):
    """(params, opt_state, step) from a `save_checkpoint` file.

    With `opt_state_template` (`optimizer.init(params)`), the optimizer
    state is rebuilt in the template's structure from the saved leaves in
    leaf order, each on its template leaf's device, as the JAX package
    does with `tree.unflatten`; a different leaf count raises ValueError.
    Without one, the saved tree comes back as tensors on `device`. The
    params go to `device`, which defaults to the template's device, or to
    the card when there is no template."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    slots = ([] if opt_state_template is None
             else _leaves(opt_state_template))
    if device is None:
        device = slots[0].device if slots else "cuda"
    dev = resolve_device(device)

    def put(a, d=dev):
        return torch.from_numpy(np.asarray(a)).to(d)

    opt_state = state["opt_state"]
    if opt_state_template is None:
        opt_state = _tree_map(put, opt_state)
    else:
        saved = _leaves(opt_state)
        if len(saved) != len(slots):
            raise ValueError(
                f"checkpoint holds {len(saved)} optimizer leaves, the "
                f"template {len(slots)}: not the same optimizer")
        it = iter(put(a, t.device) for a, t in zip(saved, slots))
        opt_state = _tree_map(lambda _: next(it), opt_state_template)
    return _tree_map(put, state["params"]), opt_state, state["step"]


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

    `engine`: "fused" runs `make_fused_train_step` (kernel K5 or K4, one
    launch per step; the table is rebuilt from the live params every step,
    so no compaction refresh), "modular" the autodiff step of
    `make_train_step`, and "auto" picks fused on a CUDA device for every
    scene with a constant background (K5 or K4, as
    `diffkernel.render_value_and_grad` routes) and modular otherwise (a
    gradient sky, or the CPU). `trainable_rows` ({"sph": rows, "quad":
    rows}, fused engine only) restricts geometry training to those rows
    (make_fused_train_step). With the modular step on K3 and geometry
    trainable, the compacted selection snapshot is refreshed every
    `refresh_compact_every` steps. Resumes from `checkpoint_path` if it
    exists. `average_last` > 0 returns the mean of the last N iterates.
    `mesh` (parallel/sharded.Mesh) shards either engine's step over it
    (make_train_step, make_fused_train_step); the fit then runs on the
    mesh's first device, which replaces `device`."""
    if engine not in ("auto", "fused", "modular"):
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None:
        device = mesh.device
    if trainable_rows is not None and engine == "modular":
        raise ValueError(
            "trainable_rows requires the fused engine (the modular path "
            "has no row-subset surrogate mode)")
    dev = resolve_device(device)
    scene_template = scene_template.to(dev)
    fused_static = None
    if engine == "auto":
        use_fused = (dev.type == "cuda"
                     and host_background(background).ndim == 1)
        engine = "fused" if use_fused else "modular"
        if use_fused:
            fused_static = diffkernel.build_diff_static(scene_template)
    if trainable_rows is not None and engine == "modular":
        raise ValueError(
            "trainable_rows requires the fused engine, but auto selected "
            "modular for this scene and device")
    kw = dict(spp=spp, max_bounces=max_bounces, background=background,
              seed=seed, learning_rate=learning_rate, optimizer=optimizer,
              trainable=trainable, mesh=mesh, device=dev)
    if engine == "fused":
        step_fn, (params, opt_state) = make_fused_train_step(
            scene_template, camera, target, static=fused_static,
            trainable_rows=trainable_rows, **kw)
    else:
        step_fn, (params, opt_state) = make_train_step(
            scene_template, camera, target, **kw)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        params, opt_state, start = load_checkpoint(
            checkpoint_path, opt_state, device=dev)
    fits_geometry = trainable is None or bool(
        _GEOMETRY_FIELDS & set(trainable))
    use_kernel = engine == "modular" and dev.type == "cuda"
    compact = refresh_compact(scene_template, params) if use_kernel else None
    losses = []
    avg_from = max(start, steps - average_last) if average_last else steps
    avg_params, avg_n = None, 0
    for i in range(start, steps):
        if (use_kernel and fits_geometry and i > start
                and refresh_compact_every
                and i % refresh_compact_every == 0):
            compact = refresh_compact(scene_template, params)
        if engine == "fused":
            params, opt_state, loss = step_fn(params, opt_state, i)
        else:
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
