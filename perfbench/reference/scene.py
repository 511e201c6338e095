"""The benchmark's scene lowering, from its own scene description.

A scene description is plain data (perfbench/scenes.py makes it from a
configuration file): materials by name, a geometry list of spheres,
quads and axis-aligned boxes, a thin-lens camera and a constant
background. This module works out from it, with numpy and torch on the
host, what a path tracer reads:

- `arrays`: the scene as padded struct-of-arrays fields (sphere centres
  and radii, quad corners and edges, the material table), primitives in
  the reference binary's BVH visit order, which decides exact ties
  between coplanar primitives (the Cornell light lies in the ceiling's
  plane);
- `camera_vector`: the 32-word camera and background row;
- `Lowered`: the real rows' intersection tables and winner payloads.

Each quantity is computed in f32 with the formulas of the reference
binary (cheolwanpark/tiny-raytracer: camera.rs, quad.rs, sphere.rs,
bvh.rs), in the operation order that keeps every value bit for bit the
same as any f32 implementation that follows them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

KINDS = {"lambertian": 0, "metal": 1, "dielectric": 2, "light": 3}
_AABB_PAD = np.float32(0.0001 / 2.0)     # aabb.rs: 1e-4 in all per axis
_FAR = 1.0e30
_PRIM_PAD = 128
_MAT_PAD = 8


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def box_quads(a, b, material: str) -> list:
    """An axis-aligned box as six quads (src/main.rs `new_box`): front,
    right, back, left, top, bottom."""
    mn = np.minimum(np.asarray(a, np.float32), np.asarray(b, np.float32))
    mx = np.maximum(np.asarray(a, np.float32), np.asarray(b, np.float32))
    dx = (float(mx[0] - mn[0]), 0.0, 0.0)
    dy = (0.0, float(mx[1] - mn[1]), 0.0)
    dz = (0.0, 0.0, float(mx[2] - mn[2]))
    ndx = (-dx[0], 0.0, 0.0)
    ndz = (0.0, 0.0, -dz[2])
    x0, y0, z0 = (float(v) for v in mn)
    x1, y1, z1 = (float(v) for v in mx)
    q = lambda c, u, v: {"quad": {"corner": c, "u": u, "v": v,  # noqa: E731
                                  "material": material}}
    return [q((x0, y0, z1), dx, dy), q((x1, y0, z1), ndz, dy),
            q((x1, y0, z0), ndx, dy), q((x0, y0, z0), dz, dy),
            q((x0, y1, z1), dx, ndz), q((x0, y0, z0), dx, dz)]


def _members(item) -> list:
    return box_quads(**item["box"]) if "box" in item else [item]


def _bbox(item):
    if "sphere" in item:
        s = item["sphere"]
        c = np.asarray(s["center"], np.float32)
        r = np.float32(abs(s["radius"]))
        return c - r - _AABB_PAD, c + r + _AABB_PAD
    if "quad" in item:
        q = item["quad"]
        c, u, v = (np.asarray(q[k], np.float32) for k in ("corner", "u", "v"))
        pts = np.stack([c, c + u + v, c + u, c + v])
        return pts.min(0) - _AABB_PAD, pts.max(0) + _AABB_PAD
    boxes = [_bbox(m) for m in _members(item)]
    return (np.min([b[0] for b in boxes], axis=0),
            np.max([b[1] for b in boxes], axis=0))


def _longest_axis(mn, mx) -> int:
    """aabb.rs: equal extents resolve to z."""
    s = mx - mn
    if s[0] > s[1]:
        return 0 if s[0] > s[2] else 2
    return 1 if s[1] > s[2] else 2


def visit_order(geometry: list) -> list:
    """The primitives (sphere and quad items) in the reference binary's
    BVH depth-first order (bvh.rs Node::new over the top-level list: a
    box is one leaf; longest axis of the merged box, stable sort on the
    box minimum, median split, two members unsorted)."""
    order: list = []

    def visit(objs):
        if len(objs) == 1:
            order.extend(_members(objs[0][2]))
            return
        if len(objs) == 2:
            visit(objs[:1])
            visit(objs[1:])
            return
        mn = np.min([o[0] for o in objs], axis=0)
        mx = np.max([o[1] for o in objs], axis=0)
        axis = _longest_axis(mn, mx)
        objs = sorted(objs, key=lambda o: o[0][axis])
        mid = len(objs) // 2
        visit(objs[:mid])
        visit(objs[mid:])

    objs = [(*_bbox(g), g) for g in geometry]
    if objs:
        visit(objs)
    return order


@dataclasses.dataclass
class Arrays:
    """The scene's fields, padded (primitives to 128 rows, materials to
    8), as f32 / int tensors on the host."""

    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    sph_valid: torch.Tensor
    quad_corner: torch.Tensor
    quad_u: torch.Tensor
    quad_v: torch.Tensor
    quad_mat: torch.Tensor
    quad_valid: torch.Tensor
    mat_kind: torch.Tensor
    mat_albedo: torch.Tensor
    mat_fuzz: torch.Tensor
    mat_ior: torch.Tensor
    mat_emit: torch.Tensor

    def numpy(self) -> dict:
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}

    def to(self, device) -> "Arrays":
        return Arrays(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})

    def replace(self, **kw) -> "Arrays":
        return dataclasses.replace(self, **kw)


def arrays(desc: dict) -> Arrays:
    """The description's scene as padded fields, primitives in visit
    order, materials in the order the description lists them."""
    prims = visit_order(desc["geometry"])
    spheres = [p["sphere"] for p in prims if "sphere" in p]
    quads = [p["quad"] for p in prims if "quad" in p]
    mats = desc["materials"]
    mid = {m["name"]: i for i, m in enumerate(mats)}
    ns = _round_up(len(spheres), _PRIM_PAD)
    nq = _round_up(len(quads), _PRIM_PAD)
    nm = _round_up(len(mats), _MAT_PAD)
    a = {
        "sph_center": np.zeros((ns, 3), np.float32),
        "sph_radius": np.zeros((ns,), np.float32),
        "sph_mat": np.zeros((ns,), np.int32),
        "sph_valid": np.zeros((ns,), bool),
        "quad_corner": np.zeros((nq, 3), np.float32),
        "quad_u": np.zeros((nq, 3), np.float32),
        "quad_v": np.zeros((nq, 3), np.float32),
        "quad_mat": np.zeros((nq,), np.int32),
        "quad_valid": np.zeros((nq,), bool),
        "mat_kind": np.zeros((nm,), np.int32),
        "mat_albedo": np.zeros((nm, 3), np.float32),
        "mat_fuzz": np.zeros((nm,), np.float32),
        "mat_ior": np.ones((nm,), np.float32),
        "mat_emit": np.zeros((nm, 3), np.float32),
    }
    for i, s in enumerate(spheres):
        a["sph_center"][i] = s["center"]
        a["sph_radius"][i] = s["radius"]
        a["sph_mat"][i] = mid[s["material"]]
        a["sph_valid"][i] = True
    a["quad_u"][:, 0] = 1.0
    a["quad_v"][:, 1] = 1.0
    for i, q in enumerate(quads):
        a["quad_corner"][i] = q["corner"]
        a["quad_u"][i] = q["u"]
        a["quad_v"][i] = q["v"]
        a["quad_mat"][i] = mid[q["material"]]
        a["quad_valid"][i] = True
    for i, m in enumerate(mats):
        a["mat_kind"][i] = KINDS[m["kind"]]
        a["mat_albedo"][i] = m.get("albedo", (0.0, 0.0, 0.0))
        a["mat_fuzz"][i] = min(max(float(m.get("fuzz", 0.0)), 0.0), 1.0)
        a["mat_ior"][i] = m.get("ior", 1.0)
        a["mat_emit"][i] = m.get("emission", (0.0, 0.0, 0.0))
    return Arrays(**{k: torch.from_numpy(v) for k, v in a.items()})


def _normalize(v):
    return v / torch.sqrt((v * v).sum())


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def camera_vector(desc: dict, width: int, height: int) -> np.ndarray:
    """(32,) f32: 0:3 position, 3:6 viewport upper-left, 6:9 horizontal,
    9:12 vertical, 12:15 / 15:18 defocus disk u / v, 18 1/(w-1),
    19 1/(h-1), 20:23 and 24:27 the background, 23 the pixel count
    (camera.rs: the viewport from the vertical fov and the focus
    distance, w = position - look_at, u = up x w, v = w x u)."""
    c = desc["camera"]
    pos = torch.tensor(c["position"], dtype=torch.float32)
    look = torch.tensor(c["look_at"], dtype=torch.float32)
    up = torch.tensor(c["up"], dtype=torch.float32)
    fd = float(c["focus_distance"])
    vh = 2.0 * fd * math.tan(math.radians(c["vertical_fov"]) / 2.0)
    vw = (width / height) * vh
    w = _normalize(pos - look)
    u = _normalize(_cross(up, w))
    v = _normalize(_cross(w, u))
    fwd = w * fd
    hor = u * vw
    ver = v * vh
    ul = pos - hor / 2.0 + ver / 2.0 - fwd
    rad = fd * math.tan(math.radians(c["defocus_angle"]) / 2.0)
    cam = np.zeros((32,), np.float32)
    for k, vec in enumerate((pos, ul, hor, ver, u * rad, v * rad)):
        cam[3 * k:3 * k + 3] = vec.numpy()
    cam[18] = 1.0 / (width - 1)
    cam[19] = 1.0 / (height - 1)
    bg = np.asarray(desc["background"], np.float32)
    cam[20:23] = bg
    cam[24:27] = bg
    cam[23] = float(width * height)
    return cam


@dataclasses.dataclass
class Lowered:
    """The real rows: spheres (S, 4) centre and r^2, quads (Q, 12) plane
    normal n = u x v, n.corner, av, corner.av, bv, corner.bv, and their
    (S + Q, 13) winner payloads: is_quad, normal source (the sphere
    centre or the quad's unit normal), kind, albedo (3), fuzz, ior,
    emission (3)."""

    sph: torch.Tensor
    quad: torch.Tensor
    pay: torch.Tensor
    has_met: bool
    has_die: bool

    @property
    def n_sph(self) -> int:
        return int(self.sph.shape[0])

    @property
    def n_quad(self) -> int:
        return int(self.quad.shape[0])

    def to(self, device, dtype=torch.float32) -> "Lowered":
        return dataclasses.replace(
            self, sph=self.sph.to(device, dtype),
            quad=self.quad.to(device, dtype), pay=self.pay.to(device, dtype))


def lower(sc: Arrays) -> Lowered:
    """The intersection tables and payloads of the scene's real rows
    (quad.rs: n = u x v, w = n / n.n, av = v x n / n.n, bv = n x u / n.n),
    in f32 with numpy."""
    a = sc.numpy()
    s_idx = np.nonzero(a["sph_valid"])[0]
    q_idx = np.nonzero(a["quad_valid"])[0]
    c = a["sph_center"][s_idx]
    r2 = (a["sph_radius"][s_idx] ** 2)[:, None]
    corner, u, v = (a[k][q_idx] for k in ("quad_corner", "quad_u", "quad_v"))
    n = np.cross(u, v)
    nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
    av = np.cross(v, n) / nn
    bv = np.cross(n, u) / nn
    dp = (n * corner).sum(-1, keepdims=True)
    ca = (corner * av).sum(-1, keepdims=True)
    cb = (corner * bv).sum(-1, keepdims=True)
    nhat = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    mats = np.concatenate([a["sph_mat"][s_idx], a["quad_mat"][q_idx]])
    kinds = a["mat_kind"][mats].astype(np.float32)
    mblock = np.concatenate([kinds[:, None], a["mat_albedo"][mats],
                             a["mat_fuzz"][mats, None],
                             a["mat_ior"][mats, None],
                             a["mat_emit"][mats]], 1)
    src = np.concatenate([c, nhat], 0)
    isq = np.concatenate([np.zeros(len(s_idx)), np.ones(len(q_idx))])
    pay = np.concatenate([isq[:, None], src, mblock], 1).astype(np.float32)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        x, np.float32))
    return Lowered(
        sph=f(np.concatenate([c, r2], 1).reshape(-1, 4)),
        quad=f(np.concatenate([n, dp, av, ca, bv, cb], 1).reshape(-1, 12)),
        pay=f(pay), has_met=bool((kinds == KINDS["metal"]).any()),
        has_die=bool((kinds == KINDS["dielectric"]).any()))
