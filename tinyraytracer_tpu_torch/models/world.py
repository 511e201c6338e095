"""World: scene container + lowering to SoA tensors (port of models/world.py).

`World` is the user-facing container of the reference (hittable/world.rs:
10-78): a geometry list and a named material registry. `build()` lowers it
on the host into a `SceneArrays` dataclass of CPU tensors, padded exactly
as the JAX package pads them, so the two packages give the same arrays bit
for bit. `scene_from_numpy` takes a scene over from numpy arrays keyed by
field name (for example the JAX package's leaves) onto any device.

A world's `ConstantMedium`s (the port's own, models/geometry.py) lower to
four more fields, `med_*`, one unpadded row a medium in the order they
were added; a scene without media leaves them None, so its arrays stay
the JAX package's. `require_no_media` is the check of every entry point
that cannot render media.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tinyraytracer_tpu_torch.models.geometry import (
    ConstantMedium,
    Geometry,
    Group,
    Quad,
    Sphere,
    flatten_geometry,
)
from tinyraytracer_tpu_torch.models.materials import Material

# Padding of the primitive and material axes, kept from the JAX package so
# that the lowered arrays compare equal field by field.
_PRIM_PAD = 128
_MAT_PAD = 8


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclasses.dataclass
class SceneArrays:
    """Scene as struct-of-arrays tensors; padded slots are masked by
    `*_valid`."""

    sph_center: torch.Tensor  # (Ns, 3) f32
    sph_radius: torch.Tensor  # (Ns,)   f32
    sph_mat: torch.Tensor     # (Ns,)   i32 — row in the material table
    sph_valid: torch.Tensor   # (Ns,)   bool

    quad_corner: torch.Tensor  # (Nq, 3) f32
    quad_u: torch.Tensor       # (Nq, 3) f32
    quad_v: torch.Tensor       # (Nq, 3) f32
    quad_mat: torch.Tensor     # (Nq,)   i32
    quad_valid: torch.Tensor   # (Nq,)   bool

    mat_kind: torch.Tensor    # (M,)   i32 — materials.LAMBERTIAN/METAL/...
    mat_albedo: torch.Tensor  # (M, 3) f32
    mat_fuzz: torch.Tensor    # (M,)   f32
    mat_ior: torch.Tensor     # (M,)   f32
    mat_emit: torch.Tensor    # (M, 3) f32

    # ConstantMedium rows, None in a scene without media
    med_center: Optional[torch.Tensor] = None   # (Nd, 3) f32 boundary centre
    med_radius: Optional[torch.Tensor] = None   # (Nd,)   f32 boundary radius
    med_density: Optional[torch.Tensor] = None  # (Nd,)   f32
    med_albedo: Optional[torch.Tensor] = None   # (Nd, 3) f32 isotropic albedo

    @property
    def num_media(self) -> int:
        """ConstantMedium rows (all real)."""
        return 0 if self.med_center is None else int(self.med_center.shape[0])

    @property
    def num_spheres(self) -> int:
        """Sphere rows, padding included (not the valid count)."""
        return int(self.sph_center.shape[0])

    @property
    def num_quads(self) -> int:
        """Quad rows, padding included (not the valid count)."""
        return int(self.quad_corner.shape[0])

    def replace(self, **kw) -> "SceneArrays":
        """The scene with the fields in `kw` swapped in; no tensor is
        copied."""
        return dataclasses.replace(self, **kw)

    def numpy(self) -> Dict[str, np.ndarray]:
        """Host copies of every field that is set, keyed by field name."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def to(self, device) -> "SceneArrays":
        """The same scene with every field on `device`."""
        return SceneArrays(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)
                              if getattr(self, f.name) is not None})


_FIELD_DTYPES = {
    "sph_center": np.float32, "sph_radius": np.float32,
    "sph_mat": np.int32, "sph_valid": np.bool_,
    "quad_corner": np.float32, "quad_u": np.float32, "quad_v": np.float32,
    "quad_mat": np.int32, "quad_valid": np.bool_,
    "mat_kind": np.int32, "mat_albedo": np.float32, "mat_fuzz": np.float32,
    "mat_ior": np.float32, "mat_emit": np.float32,
}
_MEDIUM_FIELDS = ("med_center", "med_radius", "med_density", "med_albedo")


def require_no_media(scene, what: str) -> None:
    """Raises ValueError when `scene` (SceneArrays) holds a ConstantMedium:
    only K2, `Renderer.render`'s default megakernel route, renders media;
    `what` names the entry point that cannot."""
    if getattr(scene, "num_media", 0):
        raise ValueError(f"{what} cannot render participating media (the "
                         f"scene has {scene.num_media} ConstantMedium): "
                         "render it with Renderer(accelerator='auto'), "
                         "whose megakernel K2 does")


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device) -> SceneArrays:
    """A `SceneArrays` on `device` from numpy arrays keyed by field name.

    Carries a scene lowered elsewhere (the JAX package's `SceneArrays`
    leaves, a saved scene) into the port unchanged: every value is kept bit
    for bit, and a missing field or a wrong dtype raises. The `med_*`
    fields are taken where all four are given (f32).
    """
    missing = set(_FIELD_DTYPES) - set(arrays)
    if missing:
        raise KeyError(f"scene arrays lack fields {sorted(missing)}")
    given = [k for k in _MEDIUM_FIELDS if k in arrays]
    if given and len(given) != len(_MEDIUM_FIELDS):
        raise KeyError(f"scene arrays give {given} of the medium fields "
                       f"{list(_MEDIUM_FIELDS)}")
    fields = dict(_FIELD_DTYPES, **{k: np.float32 for k in given})
    out = {}
    for name, dt in fields.items():
        a = np.asarray(arrays[name])
        if a.dtype != dt:
            raise TypeError(f"{name}: expected {np.dtype(dt)}, got {a.dtype}")
        out[name] = torch.from_numpy(np.array(a)).to(device)   # own copy
    return SceneArrays(**out)


# --- reference BVH visit order -------------------------------------------
#
# Winner ties between coplanar primitives (the Cornell light is embedded in
# the ceiling plane, src/main.rs:42-59) are resolved by every intersector as
# "first minimum = lowest storage index". The reference resolves them by its
# BVH traversal: left subtree first, right child needs a *strictly* smaller
# t (bvh.rs:96-101), composite HittableList members in insertion order —
# first-visited-in-DFS wins. Storing primitives in that DFS order makes the
# two tie rules identical, which is what keeps the Cornell light from
# winning more z-fights than in the reference (and brightening the image).

REF_AABB_PAD = np.float32(0.0001 / 2.0)  # aabb.rs:14-17 (1e-4 total/axis)


def ref_longest_axis(mn: np.ndarray, mx: np.ndarray) -> int:
    """aabb.rs:63-78 longest axis; equal extents resolve to z (the
    reference's if/else chain requires strictly greater extent for x/y)."""
    s = mx - mn
    if s[0] > s[1]:
        return 0 if s[0] > s[2] else 2
    return 1 if s[1] > s[2] else 2


def _ref_bbox(g) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(g, Sphere):
        c = np.asarray(g.center, np.float32)
        r = np.float32(abs(g.radius))
        return c - r - REF_AABB_PAD, c + r + REF_AABB_PAD  # sphere.rs:16-25
    if isinstance(g, Quad):
        c = np.asarray(g.corner, np.float32)
        u = np.asarray(g.u, np.float32)
        v = np.asarray(g.v, np.float32)
        pts = np.stack([c, c + u + v, c + u, c + v])  # quad.rs:21-23
        return pts.min(0) - REF_AABB_PAD, pts.max(0) + REF_AABB_PAD
    if isinstance(g, Group):
        mns, mxs = zip(*(_ref_bbox(m) for m in g.members))
        return np.min(mns, axis=0), np.max(mxs, axis=0)
    raise TypeError(type(g))


def _reference_visit_order(geometries) -> Tuple[List[int], List[int]]:
    """(sphere_perm, quad_perm): flat indices in reference BVH DFS order.

    Emulates Node::new over the *top-level* geometry list (Groups are single
    composite leaves, as the reference's boxed HittableList objects are) with
    the exact split policy of bvh.rs:42-84: merged-bbox longest axis, stable
    sort by bbox.min[axis], median split, two-member nodes unsorted.
    """
    s_count = [0]
    q_count = [0]

    def prims(g):
        # Assign flat ids in the same DFS order flatten_geometry uses.
        if isinstance(g, Sphere):
            i = s_count[0]
            s_count[0] += 1
            return [("s", i)]
        if isinstance(g, Quad):
            i = q_count[0]
            q_count[0] += 1
            return [("q", i)]
        out = []
        for m in g.members:
            out.extend(prims(m))
        return out

    objs = []
    for g in geometries:
        mn, mx = _ref_bbox(g)
        objs.append((mn, mx, prims(g)))

    order: List[Tuple[str, int]] = []

    def visit(objs):
        if len(objs) == 1:
            order.extend(objs[0][2])
            return
        if len(objs) == 2:  # bvh.rs:58-67: no sort
            visit(objs[:1])
            visit(objs[1:])
            return
        mn = np.min([o[0] for o in objs], axis=0)
        mx = np.max([o[1] for o in objs], axis=0)
        axis = ref_longest_axis(mn, mx)
        objs = sorted(objs, key=lambda o: o[0][axis])  # stable, like sort_by
        mid = len(objs) // 2
        visit(objs[:mid])
        visit(objs[mid:])

    if objs:
        visit(objs)
    s_perm = [i for k, i in order if k == "s"]
    q_perm = [i for k, i in order if k == "q"]
    return s_perm, q_perm


class World:
    """Scene container mirroring hittable/world.rs: geometry list + named
    material registry. `add_material` rejects duplicate names the way the
    reference panics (world.rs:27-33)."""

    def __init__(self):
        self._materials: Dict[str, Material] = {}
        self._geometries: List[Geometry] = []
        self._media: List[ConstantMedium] = []
        # mutation counter: build() caches its lowering per version, so
        # repeated renders of an unmodified world reuse one SceneArrays
        self._version = 0
        self._build_cache: Dict[tuple, SceneArrays] = {}

    def add_material(self, name: str, material: Material) -> None:
        if name in self._materials:
            raise ValueError(f"material {name!r} already registered")
        self._materials[name] = material
        self._version += 1

    def get_material(self, name: str) -> Optional[Material]:
        return self._materials.get(name)

    def add_geometry(self, geometry) -> None:
        """Adds a Sphere, Quad or Group, or a ConstantMedium (kept apart
        from the surfaces: its boundary is no surface unless added as
        one)."""
        if isinstance(geometry, ConstantMedium):
            self._media.append(geometry)
        else:
            self._geometries.append(geometry)
        self._version += 1

    @property
    def geometries(self) -> Sequence[Geometry]:
        """The surfaces, in the order they were added."""
        return tuple(self._geometries)

    @property
    def media(self) -> Sequence[ConstantMedium]:
        """The ConstantMediums, in the order they were added."""
        return tuple(self._media)

    @property
    def material_names(self) -> Sequence[str]:
        return tuple(self._materials.keys())

    def get_geometries(self, kind: type) -> List[Geometry]:
        """Typed extraction of flattened primitives (world.rs:47-56)."""
        spheres, quads = flatten_geometry(self._geometries)
        if kind is Sphere:
            return list(spheres)
        if kind is Quad:
            return list(quads)
        raise TypeError(f"unknown geometry kind {kind!r}")

    def get_materials(self, kind: int) -> Dict[str, Material]:
        """Materials of one kind code (world.rs:58-65)."""
        return {n: m for n, m in self._materials.items() if m.kind == kind}

    def build(self, prim_pad: int = _PRIM_PAD) -> SceneArrays:
        """Lower on the host to padded SoA CPU tensors, in reference visit
        order.

        Cached per (mutation version, prim_pad): calling build() twice on
        an unmodified world returns the SAME SceneArrays object."""
        key = (self._version, prim_pad)
        cached = self._build_cache.get(key)
        if cached is not None:
            return cached
        scene = self._build_uncached(prim_pad)
        self._build_cache = {key: scene}   # keep only the latest version
        return scene

    def _build_uncached(self, prim_pad: int) -> SceneArrays:
        spheres, quads = flatten_geometry(self._geometries)
        s_perm, q_perm = _reference_visit_order(self._geometries)
        spheres = [spheres[i] for i in s_perm]
        quads = [quads[i] for i in q_perm]
        mat_index = {name: i for i, name in enumerate(self._materials)}
        mats = list(self._materials.values())
        if not mats:
            raise ValueError("world has no materials")

        def mat_id(name: str) -> int:
            if name not in mat_index:
                raise KeyError(f"geometry references unknown material {name!r}")
            return mat_index[name]

        ns = _round_up(len(spheres), prim_pad) if spheres else prim_pad
        nq = _round_up(len(quads), prim_pad) if quads else prim_pad
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
            a["sph_center"][i] = s.center
            a["sph_radius"][i] = s.radius
            a["sph_mat"][i] = mat_id(s.material)
            a["sph_valid"][i] = True
        # Padded quads get unit edges (masked by quad_valid anyway).
        a["quad_u"][:, 0] = 1.0
        a["quad_v"][:, 1] = 1.0
        for i, q in enumerate(quads):
            a["quad_corner"][i] = q.corner
            a["quad_u"][i] = q.u
            a["quad_v"][i] = q.v
            a["quad_mat"][i] = mat_id(q.material)
            a["quad_valid"][i] = True
        for i, m in enumerate(mats):
            a["mat_kind"][i] = m.kind
            a["mat_albedo"][i] = m.albedo
            a["mat_fuzz"][i] = m.fuzz
            a["mat_ior"][i] = m.ior
            a["mat_emit"][i] = m.emission
        if self._media:
            a["med_center"] = np.asarray(
                [m.boundary.center for m in self._media], np.float32)
            a["med_radius"] = np.asarray(
                [m.boundary.radius for m in self._media], np.float32)
            a["med_density"] = np.asarray(
                [m.density for m in self._media], np.float32)
            a["med_albedo"] = np.asarray(
                [m.albedo for m in self._media], np.float32)
        return scene_from_numpy(a, "cpu")
