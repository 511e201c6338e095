"""BVH: host-side threaded build + wavefront traversal (port of ops/bvh.py).

The build runs once per scene on the host, in numpy: a top-down median
split on the longest axis of each node's box, one primitive per leaf,
boxes padded by 1e-4 in total per axis, flattened to arrays in DFS
preorder with *threaded* links. `hit_link` is the DFS next node and
`miss_link` the escape node, so a ray walks a single node pointer and
needs no stack. The arrays equal the JAX package's bit for bit.

The walk is plain PyTorch on detached tensors. Every ray moves one node
a step: a leaf tests its primitive over [t_min, t_max) (not against the
running best, so an exact tie still reaches the lowest-index tie-break),
an inner node's box is slab-tested over [t_min, best_t). Selection is
discrete, so nothing flows back through the walk; `intersect_scene_bvh`
recomputes the winner's t differentiably (ops/intersect.py), and its
gradients are those of the dense path.

The JAX package walks every ray in one `lax.while_loop` until all have
parked at the sentinel M; a parked ray reads node M-1 (a leaf) and keeps
testing that leaf while any other ray walks. `traverse` gives the same
(t, j) with less work. A ray's walk depends on no other ray, so the
walking rays are packed together as others park, and the exit condition
(one host sync) is read every CHECK_EVERY steps, parked rays reading a
sentinel node in between. The parked rays' extra test is idempotent (the
same ray, the same leaf), so it is applied once at the end to every ray
that parked before the slowest one did: exactly the rays the loop tests
again.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from tinyraytracer_tpu_torch.models import world as _world
from tinyraytracer_tpu_torch.ops.intersect import (
    MISS_T,
    T_MIN,
    HitRecord,
    maximum,
    quad_t,
    select_to_record,
    sphere_t,
)

# AABB padding: 5e-5 per side (aabb.rs:13-19), shared with models/world.py's
# reference visit order, as a Python float (the JAX package's value).
AABB_PAD = float(_world.REF_AABB_PAD)

# Steps between reads of the exit condition (one host sync each).
CHECK_EVERY = 8

_FIELDS = {"node_min": np.float32, "node_max": np.float32,
           "hit_link": np.int32, "miss_link": np.int32,
           "leaf_prim": np.int32}


@dataclasses.dataclass
class BVHArrays:
    """Flattened threaded BVH (DFS preorder). M = 2N-1 nodes for N
    primitives.

    leaf_prim >= 0 is a *global* primitive index (spheres then quads);
    -1 marks an inner node. hit_link is the node visited when this node's
    box is hit (the DFS next), miss_link the escape node; M is the "done"
    sentinel.
    """

    node_min: torch.Tensor   # (M, 3) f32
    node_max: torch.Tensor   # (M, 3) f32
    hit_link: torch.Tensor   # (M,)   i32
    miss_link: torch.Tensor  # (M,)   i32
    leaf_prim: torch.Tensor  # (M,)   i32

    def numpy(self) -> dict:
        """Host copies of every field, keyed by field name."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}

    def to(self, device) -> "BVHArrays":
        """The same BVH with every field on `device`."""
        return BVHArrays(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


def bvh_from_numpy(arrays: Mapping[str, np.ndarray], device) -> BVHArrays:
    """A `BVHArrays` on `device` from numpy arrays keyed by field name (the
    JAX package's `BVHArrays` leaves, say), every value kept bit for bit;
    a missing field or a wrong dtype raises."""
    missing = set(_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"BVH arrays lack fields {sorted(missing)}")
    out = {}
    for name, dt in _FIELDS.items():
        a = np.asarray(arrays[name])
        if a.dtype != dt:
            raise TypeError(f"{name}: expected {np.dtype(dt)}, got {a.dtype}")
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return BVHArrays(**out)


def primitive_aabbs(scene) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host AABBs and global ids of the *valid* primitives of a scene.

    Sphere: center ± radius (sphere.rs:16-25). Quad: the merge of its four
    corners. Both padded as aabb.rs:13-19.
    """
    def host(t, dt):
        return np.asarray(t.detach().cpu().numpy(), dt)

    c = host(scene.sph_center, np.float32)
    r = host(scene.sph_radius, np.float32)[:, None]
    sv = host(scene.sph_valid, bool)
    s_min = c - np.abs(r)
    s_max = c + np.abs(r)

    corner = host(scene.quad_corner, np.float32)
    u = host(scene.quad_u, np.float32)
    v = host(scene.quad_v, np.float32)
    qv = host(scene.quad_valid, bool)
    pts = np.stack([corner, corner + u, corner + v, corner + u + v], axis=0)
    q_min = pts.min(axis=0)
    q_max = pts.max(axis=0)

    ns = c.shape[0]
    ids = np.concatenate([np.arange(ns), ns + np.arange(corner.shape[0])])
    bb_min = np.concatenate([s_min, q_min], axis=0) - AABB_PAD
    bb_max = np.concatenate([s_max, q_max], axis=0) + AABB_PAD
    valid = np.concatenate([sv, qv])
    return bb_min[valid], bb_max[valid], ids[valid].astype(np.int32)


def _build_host(bb_min: np.ndarray, bb_max: np.ndarray, prim_ids: np.ndarray):
    """Iterative median-split build -> threaded DFS arrays (bvh.rs:42-84).

    Node box = merge of the members' boxes; split axis = the longest axis
    of the node box (aabb.rs:63-78); members sorted (stably) by box min on
    that axis, split at n/2; a two-member node splits without a sort
    (bvh.rs:58-67); leaves hold one primitive.
    """
    n = bb_min.shape[0]
    m = 2 * n - 1
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    hit_link = np.empty((m,), np.int32)
    miss_link = np.empty((m,), np.int32)
    leaf_prim = np.full((m,), -1, np.int32)

    next_idx = 0
    # (member index array, escape node); DFS preorder assigns indices
    stack = [(np.arange(n), m)]
    while stack:
        members, escape = stack.pop()
        idx = next_idx
        next_idx += 1
        mn = bb_min[members].min(axis=0)
        mx = bb_max[members].max(axis=0)
        node_min[idx] = mn
        node_max[idx] = mx
        miss_link[idx] = escape
        k = members.shape[0]
        if k == 1:
            leaf_prim[idx] = prim_ids[members[0]]
            hit_link[idx] = escape  # unused for leaves; keep well-defined
            continue
        hit_link[idx] = idx + 1
        axis = _world.ref_longest_axis(mn, mx)
        if k == 2:
            left, right = members[:1], members[1:]  # bvh.rs:58-67 (no sort)
        else:
            srt = members[np.argsort(bb_min[members, axis], kind="stable")]
            half = k // 2
            left, right = srt[:half], srt[half:]
        # left occupies idx+1 .. idx+2*len(left)-1, then right starts: the
        # left subtree's escape
        right_start = idx + 1 + (2 * left.shape[0] - 1)
        stack.append((right, escape))           # popped after left
        stack.append((left, right_start))
    return node_min, node_max, hit_link, miss_link, leaf_prim


def medium_aabbs(scene) -> Tuple[np.ndarray, np.ndarray]:
    """Host AABBs of a scene's ConstantMedium boundaries, in their order:
    centre ± radius, padded as a sphere's (K2's walk; the accelerator
    here renders no media)."""
    c = np.asarray(scene.med_center.detach().cpu().numpy(), np.float32)
    r = np.asarray(scene.med_radius.detach().cpu().numpy(),
                   np.float32)[:, None]
    return c - np.abs(r) - AABB_PAD, c + np.abs(r) + AABB_PAD


def build_tree(bb_min: np.ndarray, bb_max: np.ndarray, prim_ids: np.ndarray,
               use_native: bool = True) -> tuple:
    """(node_min, node_max, hit_link, miss_link, leaf_prim) of the boxes,
    a leaf's prim its box's entry of `prim_ids`: by the port's C++
    builder (native/, compiled at first use; a failed build raises), or
    with `use_native=False` by the numpy `_build_host`. Both give the
    same arrays, bit for bit."""
    if bb_min.shape[0] == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    if not use_native:
        return _build_host(bb_min, bb_max, prim_ids)
    from tinyraytracer_tpu_torch.native import runtime

    nm, nx, hl, ml, lp = runtime.bvh_build(bb_min, bb_max)
    # the native builder works in local prim order: map to prim_ids
    lp = np.where(lp >= 0, prim_ids[np.maximum(lp, 0)], -1).astype(np.int32)
    return nm, nx, hl, ml, lp


def build_bvh(scene, use_native: bool = True) -> BVHArrays:
    """The flattened BVH of a scene, built on the host (`build_tree`), on
    the device of the scene's tensors. The walk here renders no media: a
    scene with a ConstantMedium raises."""
    _world.require_no_media(scene, "the BVH accelerator (ops/bvh.py)")
    built = build_tree(*primitive_aabbs(scene), use_native=use_native)
    return bvh_from_numpy(dict(zip(_FIELDS, built)),
                          scene.sph_center.device)


def _safe_inv(d):
    """1/d with zero components nudged off zero (slab test stays NaN-free)."""
    tiny = torch.tensor(1.0e-24, dtype=d.dtype, device=d.device)
    return 1.0 / torch.where(torch.abs(d) < tiny, tiny, d)


def _tables(scene, bvh, dev):
    """The walk's tables: per node its box and, for a leaf, its
    primitive's rows (`tab`, (M + 1, F) f32: box min and max, then the
    sphere's center and radius and/or the quad's corner, u and v, as the
    scene holds valid ones), its links (`link`, (M + 1, 3) int64: hit,
    miss, leaf primitive), and a leaf test over rows of `tab`. Row M is
    the sentinel a parked ray reads: no leaf, both links M, so the ray
    stays parked and changes nothing."""
    m = bvh.node_min.shape[0]
    ns = scene.sph_center.shape[0]
    link = torch.stack([bvh.hit_link, bvh.miss_link, bvh.leaf_prim],
                       dim=1).to(dev, torch.int64)
    link = torch.cat([link, torch.tensor([[m, m, -1]], device=dev)])
    has_sph, has_quad = torch.stack([scene.sph_valid.any(),
                                     scene.quad_valid.any()]).tolist()
    lp = link[:m, 2]
    cols = [bvh.node_min, bvh.node_max]
    if has_sph:
        sj = torch.clamp(lp, 0, ns - 1)
        cols += [scene.sph_center.detach().index_select(0, sj),
                 scene.sph_radius.detach().index_select(0, sj)[:, None]]
    if has_quad:
        qj = torch.clamp(lp - ns, 0, scene.quad_corner.shape[0] - 1)
        cols += [getattr(scene, f).detach().index_select(0, qj)
                 for f in ("quad_corner", "quad_u", "quad_v")]
    tab = torch.cat([c.to(dev, torch.float32) for c in cols], dim=1)
    tab = torch.cat([tab, torch.zeros_like(tab[:1])])

    def leaf_t(row, lp, o, d, t_min, t_max):
        """prim_t of rays against the leaves whose `tab` rows are `row`
        (`lp` their primitives); garbage where `lp` < 0."""
        if has_sph:
            pt = sphere_t(row[:, 6:9], row[:, 9], o, d, t_min, t_max)
        if has_quad:
            q = 10 if has_sph else 6
            tq = quad_t(row[:, q:q + 3], row[:, q + 3:q + 6],
                        row[:, q + 6:q + 9], o, d, t_min, t_max)
            pt = torch.where(lp >= ns, tq, pt) if has_sph else tq
        return pt

    return tab, link, leaf_t


def traverse(scene, bvh: BVHArrays, o, d, t_min=T_MIN, t_max=MISS_T):
    """Walk the threaded BVH for a ray wavefront. Returns detached (t (R,)
    f32, j (R,) int64); j = -1 and t = t_max where nothing is hit.

    Each step moves every walking ray one node; the slab test narrows to
    [t_min, best_t) as BVH::hit does (bvh.rs:96-101, aabb.rs:36-61). The
    walking rays are packed together whenever some have parked. Counts
    the walk in `walk_counts`.
    """
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        dev = o.device
        r = o.shape[0]
        best_t = torch.full((r,), t_max, dtype=torch.float32, device=dev)
        best_j = torch.full((r,), -1, dtype=torch.int64, device=dev)
        steps = torch.zeros((r,), dtype=torch.int64, device=dev)
        if r == 0:
            return best_t, best_j
        tab, link, leaf_t = _tables(scene, bvh, dev)
        m = bvh.node_min.shape[0]

        ids = torch.arange(r, device=dev)
        wo, wd, winv = o, d, _safe_inv(d)
        node = torch.zeros((r,), dtype=torch.int64, device=dev)
        bt, bj, st = best_t.clone(), best_j.clone(), steps.clone()
        while True:
            n = node.shape[0]
            for _ in range(CHECK_EVERY):
                walking = node < m
                row = tab.index_select(0, node)
                nl = link.index_select(0, node)
                near, far = torch.aminmax(
                    (row[:, :6].view(n, 2, 3) - wo[:, None, :])
                    * winv[:, None, :], dim=1)
                lo = maximum(torch.amax(near, dim=-1), t_min)
                hi = torch.minimum(torch.amin(far, dim=-1), bt)
                lp = nl[:, 2]
                pt = leaf_t(row, lp, wo, wd, t_min, t_max)
                is_leaf = lp >= 0
                better = (is_leaf & (pt < MISS_T)
                          & ((pt < bt) | ((pt == bt) & (lp < bj))))
                bt = torch.where(better, pt, bt)
                bj = torch.where(better, lp, bj)
                node = torch.where(is_leaf | ~(lo < hi), nl[:, 1], nl[:, 0])
                st = st + walking
            walking = node < m
            n_walk = int(walking.sum())
            if n_walk == n:
                continue
            best_t.index_copy_(0, ids, bt)
            best_j.index_copy_(0, ids, bj)
            steps.index_copy_(0, ids, st)
            if not n_walk:
                break
            keep = torch.nonzero(walking).squeeze(1)
            ids, wo, wd, winv, node, bt, bj, st = (
                x.index_select(0, keep)
                for x in (ids, wo, wd, winv, node, bt, bj, st))

        # the JAX loop's parked rays test leaf M-1 once more for as long
        # as any ray walks: every ray that parked before the slowest one
        last = steps.max()
        again = steps < last
        jl = link[m - 1, 2].expand(r)
        pt = leaf_t(tab[m - 1].expand(r, -1), jl, o, d, t_min, t_max)
        better = (again & (pt < MISS_T)
                  & ((pt < best_t) | ((pt == best_t) & (jl < best_j))))
        best_t = torch.where(better, pt, best_t)
        best_j = torch.where(better, jl, best_j)

        walk_counts.add(*torch.stack([last, steps.sum()]).tolist())
    return best_t, best_j


@dataclasses.dataclass
class WalkCounts:
    """What the walks did: `walks` (traverse calls), `iterations` (steps
    of each call's slowest ray, summed: the JAX loop's trip counts),
    `max_iterations` (the most in one call) and `ray_steps` (every ray's
    steps)."""

    walks: int = 0
    iterations: int = 0
    max_iterations: int = 0
    ray_steps: int = 0

    def add(self, iterations: int, ray_steps: int):
        self.walks += 1
        self.iterations += iterations
        self.max_iterations = max(self.max_iterations, iterations)
        self.ray_steps += ray_steps

    def reset(self):
        self.walks = self.iterations = self.max_iterations = 0
        self.ray_steps = 0


walk_counts = WalkCounts()


def intersect_scene_bvh(scene, bvh: BVHArrays, o, d, t_min=T_MIN,
                        t_max=MISS_T) -> HitRecord:
    """BVH-accelerated closest hit with the dense path's gradients: the
    walk only selects the winner (detached); its t is recomputed
    differentiably by prim_t through select_to_record, the record
    assembly every selection path shares."""
    t_sel, j = traverse(scene, bvh, o, d, t_min, t_max)
    t_sel = torch.where(j >= 0, t_sel, MISS_T)
    return select_to_record(scene, o, d, t_sel, j, t_min, t_max)
