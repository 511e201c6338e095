"""The plain training step: the fused objective's loss and gradient
(perfbench/reference/diff.py) and Adam, from a scene description.

What one step of inverse rendering does: the flat table from the live
parameters, the objective and its gradient tables, the tables scattered
back onto the scene's fields, non-finite entries zeroed, the background's
gradient dropped, the untrained fields' zeroed and, with
`trainable_rows`, every other row's geometry gradient masked; then Adam
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected; Kingma & Ba 2015, in
optax's order of operations) at a constant learning rate.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import diff
from perfbench.reference.scene import Arrays, arrays, camera_vector

FIELDS = ("sph_center", "sph_radius", "quad_corner", "quad_u", "quad_v",
          "mat_albedo", "mat_fuzz", "mat_ior", "mat_emit")
_GEOMETRY = frozenset({"sph_center", "sph_radius", "quad_corner", "quad_u",
                       "quad_v"})
B1, B2, EPS = 0.9, 0.999, 1e-8


def surrogate_scope(trainset):
    """(silhouette on, per-class surrogate rows): the silhouette feeds
    only geometry rows; a class none of whose geometry trains drops its
    soft-shadow and silhouette chains."""
    if trainset is None:
        return True, None
    sil = bool(_GEOMETRY & trainset)
    sph_geo = bool({"sph_center", "sph_radius"} & trainset)
    quad_geo = bool({"quad_corner", "quad_u", "quad_v"} & trainset)
    if sph_geo and quad_geo:
        return sil, None
    return sil, {"sph": None if sph_geo else (),
                 "quad": None if quad_geo else ()}


class Step:
    """Builds the scene and the objective's static parts once; `grads`
    and `adam` make one step. Runs on `device` in `dtype`."""

    def __init__(self, desc: dict, target: torch.Tensor, *, width: int,
                 height: int, spp: int, max_bounces: int, seed: int,
                 trainable=None, trainable_rows=None,
                 learning_rate: float = 1e-2, device="cpu",
                 dtype=torch.float32, pixel_chunk: int = 0,
                 half_image: bool = False):
        self.width, self.height = width, height
        self.spp, self.max_bounces, self.seed = spp, max_bounces, seed
        self.lr, self.dev, self.dt = learning_rate, device, dtype
        self.pixel_chunk = pixel_chunk
        self.half_image = half_image
        self.scene = arrays(desc).to(device)
        self.st = diff.build_diff_static(self.scene)
        self.trainset = None if trainable is None else frozenset(trainable)
        self.sil, surr = surrogate_scope(self.trainset)
        self.row_mask = None
        if trainable_rows is not None:
            surr = {k: tuple(int(r) for r in trainable_rows.get(k, ()))
                    for k in ("sph", "quad")}
            self.row_mask = self._row_masks(surr)
        self.surr_s, self.surr_q, _ = diff._surrogate_rows(self.st, surr)
        self.cam = torch.from_numpy(camera_vector(desc, width, height)).to(
            device, dtype)
        self.target = target.to(device, dtype).reshape(height, width, 3)

    def _row_masks(self, rows):
        sm = torch.zeros(self.scene.sph_center.shape[0], device=self.dev)
        sm[list(rows["sph"])] = 1.0
        qm = torch.zeros(self.scene.quad_corner.shape[0], device=self.dev)
        qm[list(rows["quad"])] = 1.0
        return {"sph_center": sm[:, None], "sph_radius": sm,
                "quad_corner": qm[:, None], "quad_u": qm[:, None],
                "quad_v": qm[:, None]}

    def params0(self) -> dict:
        return {f: getattr(self.scene, f).clone() for f in FIELDS}

    def grads(self, params: dict, step_idx: int, stats=None):
        """(loss, gradient as the optimizer gets it) at `params`, the
        samples [step_idx * spp, (step_idx + 1) * spp) of the stream."""
        scene: Arrays = self.scene.replace(**params)
        tab, _prims, light_off = diff.packed_flat_table(scene, self.st)
        spec = diff.packed_spec(self.st, light_off, nee=True, sil=self.sil,
                                surr_sph=self.surr_s, surr_quad=self.surr_q)
        w, h = self.width, self.height
        pixels, tgt, cam = None, self.target, self.cam
        if self.half_image:
            # a fault for the correctness test: the first half of the
            # rows, the mean taken over them alone
            n = (h // 2) * w
            pixels, tgt = (0, n), self.target.reshape(-1, 3)[:n]
            cam = cam.clone()
            cam[23] = float(n)
        tables = diff.packed_diff_reference(
            tab.view(-1).to(self.dt), cam, tgt.contiguous(), spec=spec,
            width=w, height=h, spp=self.spp, max_bounces=self.max_bounces,
            seed=self.seed, spp_offset=(step_idx * self.spp) & 0xFFFFFFFF,
            pixel_chunk=self.pixel_chunk, pixels=pixels, stats=stats)[1:]
        tables = [t.to(torch.float32) for t in tables]
        loss = tables[4][0, 3]
        g = diff._grads_to_scene(scene, self.st, *tables)
        g = {k: torch.where(torch.isfinite(v), v, 0.0) for k, v in g.items() if k != "background"}
        if self.trainset is not None:
            g = {k: v if k in self.trainset else torch.zeros_like(v)
                 for k, v in g.items()}
        if self.row_mask is not None:
            g = {k: v * self.row_mask[k] if k in self.row_mask else v
                 for k, v in g.items()}
        return loss, g

    def adam(self, params, grads, state):
        """One Adam update; `state` (count, mu, nu) or None at the start."""
        if state is None:
            state = (0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})
        count, mu, nu = state
        mu = {k: (1 - B1) * g + B1 * mu[k] for k, g in grads.items()}
        nu = {k: (1 - B2) * (g * g) + B2 * nu[k] for k, g in grads.items()}
        count += 1
        c = torch.tensor(float(count), dtype=torch.float32, device=self.dev)
        bc1 = 1 - torch.pow(torch.full_like(c, B1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, B2), c)
        upd = {k: ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS))
               * -self.lr for k in grads}
        params = {k: (p + upd[k]).to(p.dtype) for k, p in params.items()}
        return params, (count, mu, nu)

    def run(self, steps: int):
        """`steps` steps from the scene's parameters: (losses, the first
        gradient, the parameters' change after the last step, the mean
        segments a camera ray's forward path executed in the first)."""
        params = p0 = self.params0()
        state, losses, first, stats = None, [], None, {}
        for i in range(steps):
            loss, g = self.grads(params, i, stats if i == 0 else None)
            losses.append(float(loss))
            if first is None:
                first = g
            params, state = self.adam(params, g, state)
        change = {k: params[k] - p0[k] for k in p0}
        rays = self.width * self.height * self.spp
        if self.half_image:
            rays //= 2
        return losses, first, change, stats.get("segments", 0) / rays


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf (over the leaves the reference moves), whichever is larger.
    `keep` names the leaves compared (default: every leaf)."""
    gaps = _leaf_gaps(prog, ref, keep)
    return max(gaps) if gaps else 0.0


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    keys = [k for k in ref if keep is None or k in keep]
    nz = [ref[k] for k in keys if ref[k] > 0.0]
    med = float(np.median(nz)) if nz else 0.0
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys
            if max(ref[k], med) > 0.0]


def median_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The median over the leaves of `worst_leaf_gap`'s per-leaf gap."""
    gaps = _leaf_gaps(prog, ref, keep)
    return float(np.median(gaps)) if gaps else 0.0


def moved_leaves(grad_norms: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's (over the leaves with any gradient): the others
    move under Adam by round-off alone."""
    nz = [v for v in grad_norms.values() if v > 0.0]
    if not nz:
        return set()
    med = float(np.median(nz))
    return {k for k, v in grad_norms.items() if v >= 1e-3 * med}
