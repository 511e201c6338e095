"""Batched ray-scene intersection (port of ops/intersect.py).

A batch of R rays is tested against every primitive at once; the closest
hit is a detached *selection* (which primitive wins), and the winner's t
is recomputed differentiably by `prim_t`, so gradients flow through R
winners instead of R x N candidates and are the same whichever selection
ran (the dense argmin here, or the closest-hit kernel of
ops/intersect_kernel.py).

Semantics kept from the reference (and the JAX package):
  - t range is half-open [t_min, t_max);
  - sphere: near root, then far root fallback;
  - quad: planar coords in half-open [0, 1);
  - HitRecord normal flipped to face the ray, front_face = d.n_out < 0.

Gradients follow JAX's where JAX applies `maximum`/`minimum`/`clip` to a
differentiable value: `maximum`, `minimum` and `clip` below split the
cotangent at a tie as jnp's do (torch.clamp would give all of it to the
value). Every NaN-safe guard of the JAX code (`where` before `sqrt`,
`denom_safe`, floored norms) is kept as written.
"""

from __future__ import annotations

import dataclasses

import torch

# t for "no hit": large but finite, so downstream arithmetic never makes
# NaNs. Both are rounded to f32 where they meet a tensor, as in JAX.
MISS_T = 3.0e38
T_MIN = 1.0e-3

_CONSTS: dict = {}


def const(c: float, like: torch.Tensor) -> torch.Tensor:
    """A cached 0-dim tensor holding `c` in the dtype and on the device of
    `like` (no host copy per call)."""
    key = (c, like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(c, dtype=like.dtype,
                                        device=like.device)
    return t


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c): at x == c, x gets half the cotangent."""
    return torch.maximum(x, const(c, x))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.minimum(x, c): at x == c, x gets half the cotangent."""
    return torch.minimum(x, const(c, x))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi); `lo` and `hi`
    are floats or tensors (a tensor bound may be attached)."""
    lo = const(lo, x) if not isinstance(lo, torch.Tensor) else lo
    hi = const(hi, x) if not isinstance(hi, torch.Tensor) else hi
    return torch.minimum(torch.maximum(x, lo), hi)


def _matmul_full_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32: TF32 off for the call, whatever the caller set."""
    prec = torch.get_float32_matmul_precision()
    if prec == "highest":
        return a @ b
    torch.set_float32_matmul_precision("highest")
    try:
        return a @ b
    finally:
        torch.set_float32_matmul_precision(prec)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 root on every device. The card's f32
    torch.sqrt is; the CPU's vectorised one is not always, so on the CPU
    the root is taken in f64 and rounded once."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


class _RootSqrt(torch.autograd.Function):
    """sqrt whose derivative at exactly 0 is 0 instead of infinite.

    prim_t takes sqrt(where(disc >= 0, max(disc, 0), 1)): at disc == 0
    exactly (a ray tangent to the sphere, or a masked-out branch whose
    cotangent is 0) the JAX package's derivative is inf or 0 * inf = NaN,
    which poisons the whole parameter's gradient until the train step
    zeroes it. At config 5's 18 M rays x 20 bounces per step some ray
    always lands there, so the port drops that one ray's term instead.
    Everywhere else this is jnp.sqrt's derivative, g * (0.5 / sqrt(x))."""

    @staticmethod
    def forward(ctx, x):
        y = sqrt_rn(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0.0, g * (0.5 / y), const(0.0, g))


class _TakeRows(torch.autograd.Function):
    """`table[j]` whose backward is a one-hot product, as JAX's
    take_rows: ct_table = onehot(j)^T @ ct, an (N, R) @ (R, K) matmul.
    Every product is 1.0 * x, so it is exact up to summation order, and
    unlike index_add_ (atomics on CUDA) it gives the same bits on every
    run."""

    @staticmethod
    def forward(ctx, table, j):
        ctx.save_for_backward(j)
        ctx.n = table.shape[0]
        ctx.ndim = table.dim()
        return table.index_select(0, j)

    @staticmethod
    def backward(ctx, ct):
        (j,) = ctx.saved_tensors
        oh_t = (torch.arange(ctx.n, dtype=j.dtype, device=j.device)[:, None]
                == j[None, :]).to(ct.dtype)                    # (N, R)
        if ctx.ndim == 1:
            return _matmul_full_f32(oh_t, ct[:, None])[:, 0], None
        return _matmul_full_f32(oh_t, ct), None


def take_rows(table: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Differentiable `table[j]` for (N,) / (N, K) tables, (R,) indices,
    with a deterministic backward."""
    return _TakeRows.apply(table, j.to(torch.int64))


@dataclasses.dataclass
class HitRecord:
    """SoA hit record for a ray batch."""

    t: torch.Tensor          # (R,)  f32, MISS_T when no hit
    hit: torch.Tensor        # (R,)  bool
    point: torch.Tensor      # (R,3) f32
    normal: torch.Tensor     # (R,3) f32, unit, flipped toward the ray
    front_face: torch.Tensor  # (R,) bool
    mat_kind: torch.Tensor   # (R,)  i32
    albedo: torch.Tensor     # (R,3) f32
    fuzz: torch.Tensor       # (R,)  f32
    ior: torch.Tensor        # (R,)  f32
    emit: torch.Tensor       # (R,3) f32
    is_quad: torch.Tensor    # (R,)  bool: the winner is a quad


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _dot3(a, b):
    """a . b over the last axis of (..., 3) rows, added left to right: the
    CPU's torch.sum order, which the card's reduction does not keep."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def cross(a, b):
    """jnp.cross over the last axis, component by component."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _where_miss(cond, t):
    return torch.where(cond, t, const(MISS_T, t))


def sphere_ts(scene, o, d, t_min=T_MIN, t_max=MISS_T, exact: bool = False):
    """Per-(ray, sphere) hit parameter t, MISS_T where no valid hit.

    o, d: (R,3); returns (R, Ns). `exact` uses the oc = o - c form (the
    test oracle); the default expands the quadratic so the heavy terms
    are products against the sphere table."""
    c = scene.sph_center
    r = scene.sph_radius
    if exact:
        oc = o[:, None, :] - c[None, :, :]              # (R,Ns,3)
        half_b = torch.sum(oc * d[:, None, :], dim=-1)
        c_term = torch.sum(oc * oc, dim=-1) - (r * r)[None, :]
    else:
        d_dot_c = _matmul_full_f32(d, c.T)               # (R,Ns)
        o_dot_c = _matmul_full_f32(o, c.T)
        half_b = _dot(d, o)[:, None] - d_dot_c
        c_term = (_dot(o, o)[:, None] - 2.0 * o_dot_c
                  + torch.sum(c * c, dim=-1)[None, :] - (r * r)[None, :])
    disc = half_b * half_b - c_term
    has_root = disc >= 0.0
    # sqrt's unselected branch must stay finite in the backward pass
    sqrtd = torch.sqrt(torch.where(has_root, maximum(disc, 0.0),
                                   const(1.0, disc)))
    t0 = -half_b - sqrtd
    t1 = -half_b + sqrtd
    in0 = (t0 >= t_min) & (t0 < t_max)
    in1 = (t1 >= t_min) & (t1 < t_max)
    t = torch.where(in0, t0, _where_miss(in1, t1))
    valid = has_root & scene.sph_valid[None, :]
    return _where_miss(valid, t)


def quad_ts(scene, o, d, t_min=T_MIN, t_max=MISS_T):
    """Per-(ray, quad) hit parameter t, MISS_T where no valid hit: the
    plane t, then planar coordinates alpha = p.(v x n)/(n.n) and
    beta = p.(n x u)/(n.n), both linear in p."""
    corner, u, v = scene.quad_corner, scene.quad_u, scene.quad_v
    n = cross(u, v)                                      # (Nq,3)
    nn = _dot(n, n)
    inv_nn = 1.0 / maximum(nn, 1e-30)
    d_plane = _dot(n, corner)
    a_vec = cross(v, n) * inv_nn[:, None]
    b_vec = cross(n, u) * inv_nn[:, None]

    denom = _matmul_full_f32(d, n.T)                     # (R,Nq)
    denom_safe = torch.where(torch.abs(denom) < 1e-12, const(1e-12, denom),
                             denom)
    t = (d_plane[None, :] - _matmul_full_f32(o, n.T)) / denom_safe
    in_range = (t >= t_min) & (t < t_max) & (torch.abs(denom) >= 1e-12)

    o_a = _matmul_full_f32(o, a_vec.T)
    d_a = _matmul_full_f32(d, a_vec.T)
    c_a = _dot(corner, a_vec)
    alpha = o_a + t * d_a - c_a[None, :]
    o_b = _matmul_full_f32(o, b_vec.T)
    d_b = _matmul_full_f32(d, b_vec.T)
    c_b = _dot(corner, b_vec)
    beta = o_b + t * d_b - c_b[None, :]

    inside = (alpha >= 0.0) & (alpha < 1.0) & (beta >= 0.0) & (beta < 1.0)
    valid = in_range & inside & scene.quad_valid[None, :] & torch.isfinite(t)
    return _where_miss(valid, t)


def sphere_t(c, r, o, d, t_min=T_MIN, t_max=MISS_T):
    """t of each ray against its own sphere (center c (R, 3), radius r
    (R,)): the near root, else the far one, in [t_min, t_max); MISS_T
    where neither. Every dot adds left to right and the root is correctly
    rounded, so the card and the CPU give the same bits."""
    oc = o - c
    half_b = _dot3(oc, d)
    c_term = _dot3(oc, oc) - r * r
    disc = half_b * half_b - c_term
    has_root = disc >= 0.0
    sqrtd = _RootSqrt.apply(torch.where(has_root, maximum(disc, 0.0),
                                        const(1.0, disc)))
    t0 = -half_b - sqrtd
    t1 = -half_b + sqrtd
    in0 = (t0 >= t_min) & (t0 < t_max)
    in1 = (t1 >= t_min) & (t1 < t_max)
    ts = torch.where(in0, t0, _where_miss(in1, t1))
    return _where_miss(has_root, ts)


def quad_t(corner, u, v, o, d, t_min=T_MIN, t_max=MISS_T):
    """t of each ray against its own quad (rows (R, 3)): the plane t in
    [t_min, t_max) with planar coordinates in [0, 1); MISS_T elsewhere.
    Dots as in `sphere_t`."""
    n = cross(u, v)
    nn = maximum(_dot3(n, n), 1e-30)
    denom = _dot3(d, n)
    denom_safe = torch.where(torch.abs(denom) < 1e-12, const(1e-12, denom),
                             denom)
    tq = (_dot3(n, corner) - _dot3(o, n)) / denom_safe
    p = o + tq[:, None] * d - corner
    alpha = _dot3(p, cross(v, n)) / nn
    beta = _dot3(p, cross(n, u)) / nn
    ok = ((tq >= t_min) & (tq < t_max) & (alpha >= 0.0) & (alpha < 1.0)
          & (beta >= 0.0) & (beta < 1.0) & (torch.abs(denom) >= 1e-12)
          & torch.isfinite(tq))
    return _where_miss(ok, tq)


def prim_t(scene, o, d, j, t_min=T_MIN, t_max=MISS_T):
    """t of each ray against its single global primitive j (spheres then
    quads), in [t_min, t_max). The one differentiable t formula: whichever
    path selected the winner, its t and every gradient through it come
    from here (`sphere_t` and `quad_t`, which the BVH walk's leaf test
    calls too)."""
    ns = scene.sph_center.shape[0]
    nq = scene.quad_corner.shape[0]
    sj = torch.clamp(j, 0, ns - 1)
    qj = torch.clamp(j - ns, 0, nq - 1)
    ts = sphere_t(take_rows(scene.sph_center, sj),
                  take_rows(scene.sph_radius, sj), o, d, t_min, t_max)
    tq = quad_t(take_rows(scene.quad_corner, qj),
                take_rows(scene.quad_u, qj), take_rows(scene.quad_v, qj),
                o, d, t_min, t_max)
    return torch.where(j >= ns, tq, ts)


def _gather_materials(scene, mat_id):
    return (
        scene.mat_kind.index_select(0, mat_id),          # i32: no backward
        take_rows(scene.mat_albedo, mat_id),
        take_rows(scene.mat_fuzz, mat_id),
        take_rows(scene.mat_ior, mat_id),
        take_rows(scene.mat_emit, mat_id),
    )


def closest_select(scene, o, d, t_min=T_MIN, t_max=MISS_T,
                   exact: bool = False):
    """Detached closest-hit selection over every primitive: (t_sel (R,),
    j (R,) int64). The first minimum wins (jnp.argmin's tie rule)."""
    with torch.no_grad():
        ts = sphere_ts(scene, o.detach(), d.detach(), t_min, t_max,
                       exact=exact)
        tq = quad_ts(scene, o.detach(), d.detach(), t_min, t_max)
        t_all = torch.cat([ts, tq], dim=1)               # (R, Ns+Nq)
        t_sel = t_all.min(dim=1).values
        # the lowest index at the minimum, spelled out (argmin's tie rule
        # is documented, but this is the form every path shares)
        col = torch.arange(t_all.shape[1], device=t_all.device)
        j = torch.where(t_all == t_sel[:, None], col,
                        t_all.shape[1]).min(dim=1).values
    return t_sel, j


def select_to_record(scene, o, d, t_sel, j, t_min=T_MIN,
                     t_max=MISS_T) -> HitRecord:
    """Differentiable HitRecord from a detached selection (t_sel, j). The
    winner's t is recomputed by `prim_t`; where the screening formula and
    prim_t disagree about validity (a grazing ray), the screened t is
    kept."""
    hit = t_sel < MISS_T
    j = torch.clamp(j.to(torch.int64), min=0)   # miss sentinels -> any row
    t_re = prim_t(scene, o, d, j, t_min, t_max)
    t = _where_miss(hit, torch.where(t_re < MISS_T, t_re, t_sel))
    return hit_record_from(scene, o, d, t, j)


def hit_record_from(scene, o, d, t, j) -> HitRecord:
    """A HitRecord from the winning t and global primitive index j (j >= Ns
    is quad j - Ns; t == MISS_T is no hit)."""
    ns = scene.sph_center.shape[0]
    nq = scene.quad_corner.shape[0]
    hit = t < MISS_T
    t_safe = torch.where(hit, t, const(1.0, t))
    point = o + t_safe[:, None] * d

    is_quad = j >= ns
    sph_j = torch.clamp(j, max=ns - 1)
    quad_j = torch.clamp(j - ns, 0, nq - 1)

    center = take_rows(scene.sph_center, sph_j)
    sph_out = point - center
    qn = cross(take_rows(scene.quad_u, quad_j),
               take_rows(scene.quad_v, quad_j))
    outward = torch.where(is_quad[:, None], qn, sph_out)
    # sqrt(max(.)): a fitted center may land exactly on a shading point
    norm = torch.sqrt(maximum(torch.sum(outward * outward, dim=-1,
                                        keepdim=True), 1e-24))
    outward_unit = outward / norm

    front_face = _dot(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward_unit, -outward_unit)

    mat_id = torch.where(is_quad, scene.quad_mat.index_select(0, quad_j),
                         scene.sph_mat.index_select(0, sph_j)).to(torch.int64)
    kind, albedo, fuzz, ior, emit = _gather_materials(scene, mat_id)
    return HitRecord(t=t, hit=hit, point=point, normal=normal,
                     front_face=front_face, mat_kind=kind, albedo=albedo,
                     fuzz=fuzz, ior=ior, emit=emit, is_quad=is_quad)
