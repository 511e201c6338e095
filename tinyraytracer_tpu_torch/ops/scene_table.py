"""Host lowering of a scene and camera into what the kernels read.

One module holds every scene constant the megakernel sees, all computed
with numpy on the host so that they equal the JAX package's arrays bit for
bit:

- `compact_scene`: valid primitives only, quad plane quantities
  precomputed (intersect_pallas.compact_scene).
- `payload_matrix`: the (16, N) winner payload (megakernel._payload_matrix).
- `scene_table`: one flat f32 row, each primitive's geometry followed by
  its material (megakernel_packed.scene_table).
- `camera_vector`: the (1, 32) camera/background row
  (megakernel._camera_vector).
- `used_kind_flags`: which scatter lobes the scene can reach.
- `morton_order`, `build_chunk_aabbs`: the spatial sphere order and the
  per-block AABBs of the culled row sweep (megakernel._morton_order,
  megakernel._build_chunk_aabbs).

`lower` runs them for the packed kernel (K1), `lower_flat` for the
classic-layout kernel (K2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tinyraytracer_tpu_torch.models import materials as mat
from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.world import SceneArrays

_FAR = 1.0e30  # inert-primitive displacement: never intersected

SPH_FIELDS = 4      # cx cy cz r2
QUAD_FIELDS = 15    # n(3) dp av(3) ca bv(3) cb nhat(3)
MAT_FIELDS = 9      # kind albedo(3) fuzz ior emit(3)
SPH_STRIDE = SPH_FIELDS + MAT_FIELDS     # 13 floats per sphere
QUAD_STRIDE = QUAD_FIELDS + MAT_FIELDS   # 24 floats per quad


@dataclasses.dataclass
class CompactScene:
    """Valid primitives only, SoA columns (N, 1), padded to multiples of 8.

    Sphere block first (ns rows), then quads (nq rows); `index_map` sends a
    compacted row to its global (spheres-then-quads) primitive id.
    """

    sph_c: np.ndarray      # (Ns, 3)
    sph_r2: np.ndarray     # (Ns, 1) radius^2
    quad_n: np.ndarray     # (Nq, 3) plane normal u x v
    quad_dp: np.ndarray    # (Nq, 1) n . corner
    quad_av: np.ndarray    # (Nq, 3) (v x n) / (n.n)
    quad_ca: np.ndarray    # (Nq, 1) corner . av
    quad_bv: np.ndarray    # (Nq, 3) (n x u) / (n.n)
    quad_cb: np.ndarray    # (Nq, 1) corner . bv
    index_map: np.ndarray  # (Ns+Nq,) i32
    n_sph_real: int = 0
    n_quad_real: int = 0

    @property
    def ns(self) -> int:
        return int(self.sph_c.shape[0])

    @property
    def nq(self) -> int:
        return int(self.quad_n.shape[0])


def pad8(n: int) -> int:
    """Rows a block of n primitives takes: a multiple of 8, at least 8."""
    return max(8, ((n + 7) // 8) * 8)


def compact_scene(scene: SceneArrays, sphere_order=None) -> CompactScene:
    """Drop padded slots, re-pad to 8 with inert rows, precompute quad
    planes. Order is preserved, so a first-minimum tie-break over the
    compacted rows equals one over the full arrays. `sphere_order`, a
    permutation of range(n_valid_spheres), reorders the sphere rows
    (`morton_order` for the culled sweep); `index_map` follows it."""
    a = scene.numpy()
    sc = a["sph_center"].astype(np.float32)
    sr = a["sph_radius"].astype(np.float32)
    sv = a["sph_valid"].astype(bool)
    qc = a["quad_corner"].astype(np.float32)
    qu = a["quad_u"].astype(np.float32)
    qv = a["quad_v"].astype(np.float32)
    qvl = a["quad_valid"].astype(bool)

    s_idx = np.nonzero(sv)[0]
    if sphere_order is not None:
        s_idx = s_idx[np.asarray(sphere_order)]
    q_idx = np.nonzero(qvl)[0]
    ns, nq = pad8(len(s_idx)), pad8(len(q_idx))

    sph_c = np.full((ns, 3), _FAR, np.float32)
    sph_r2 = np.zeros((ns, 1), np.float32)
    sph_c[: len(s_idx)] = sc[s_idx]
    sph_r2[: len(s_idx), 0] = sr[s_idx] ** 2

    # Padded quad rows keep u = v = 0: the zero normal fails the
    # |n.d| >= 1e-12 guard, so pad rows are inert.
    corner = np.full((nq, 3), _FAR, np.float32)
    u = np.zeros((nq, 3), np.float32)
    v = np.zeros((nq, 3), np.float32)
    corner[: len(q_idx)] = qc[q_idx]
    u[: len(q_idx)] = qu[q_idx]
    v[: len(q_idx)] = qv[q_idx]
    n = np.cross(u, v)
    nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
    av = np.cross(v, n) / nn
    bv = np.cross(n, u) / nn
    dp = (n * corner).sum(-1, keepdims=True)
    ca = (corner * av).sum(-1, keepdims=True)
    cb = (corner * bv).sum(-1, keepdims=True)

    index_map = np.zeros((ns + nq,), np.int32)
    index_map[: len(s_idx)] = s_idx
    index_map[ns: ns + len(q_idx)] = sc.shape[0] + q_idx

    return CompactScene(
        sph_c=sph_c,
        sph_r2=sph_r2,
        quad_n=n.astype(np.float32),
        quad_dp=dp.astype(np.float32),
        quad_av=av.astype(np.float32),
        quad_ca=ca.astype(np.float32),
        quad_bv=bv.astype(np.float32),
        quad_cb=cb.astype(np.float32),
        index_map=index_map,
        n_sph_real=len(s_idx),
        n_quad_real=len(q_idx),
    )


def used_kind_flags(scene: SceneArrays) -> tuple:
    """(has_met, has_die): does any VALID primitive use a Metal /
    Dielectric material? A kernel may drop an absent kind's scatter lobe:
    its result is only ever taken through that kind's winner select."""
    a = scene.numpy()
    kinds = a["mat_kind"]
    sv, qv = a["sph_valid"], a["quad_valid"]
    used = [kinds[a["sph_mat"][sv]], kinds[a["quad_mat"][qv]]]
    uk = np.concatenate(used)
    return bool((uk == mat.METAL).any()), bool((uk == mat.DIELECTRIC).any())


def payload_matrix(scene: SceneArrays, cs: CompactScene) -> np.ndarray:
    """(16, N) winner-payload rows for the compacted scene: [is_quad, cx,
    cy, cz, nhat_x, nhat_y, nhat_z, mat_kind, albedo r/g/b, fuzz, ior,
    emit r/g/b]. Padded rows keep material 0 (they are never hit)."""
    a = scene.numpy()
    ns, nq = cs.ns, cs.nq
    pay = np.zeros((16, ns + nq), np.float32)
    idx = cs.index_map
    sph_n_total = a["sph_center"].shape[0]

    pay[1, :ns] = cs.sph_c[:, 0]
    pay[2, :ns] = cs.sph_c[:, 1]
    pay[3, :ns] = cs.sph_c[:, 2]

    qlen = np.maximum(np.linalg.norm(cs.quad_n, axis=1, keepdims=True), 1e-30)
    nhat = cs.quad_n / qlen
    pay[0, ns:] = 1.0
    pay[4, ns:] = nhat[:, 0]
    pay[5, ns:] = nhat[:, 1]
    pay[6, ns:] = nhat[:, 2]

    for row in range(ns + nq):
        g = idx[row]
        if row < ns:
            m = int(a["sph_mat"][g]) if row < cs.n_sph_real else 0
        else:
            m = (int(a["quad_mat"][g - sph_n_total])
                 if row - ns < cs.n_quad_real else 0)
        pay[7, row] = a["mat_kind"][m]
        pay[8:11, row] = a["mat_albedo"][m]
        pay[11, row] = a["mat_fuzz"][m]
        pay[12, row] = a["mat_ior"][m]
        pay[13:16, row] = a["mat_emit"][m]
    return pay


def scene_table(cs: CompactScene, pay: np.ndarray) -> tuple:
    """Flatten the compacted scene into one f32 row.

    Spheres first, SPH_STRIDE floats each (center, r^2, material block),
    then quads, QUAD_STRIDE floats each (n, n.corner, av, ca, bv, cb,
    nhat, material block); material block = kind, albedo(3), fuzz, ior,
    emit(3). Zero-padded to a multiple of 8. Returns (table (1, NW) f32,
    prims) with prims a tuple of ("s"|"q", offset) in table order.
    """
    vals: list = []
    prims: list = []

    def mat_block(row):
        return [pay[k, row] for k in range(7, 16)]

    for r in range(cs.n_sph_real):
        prims.append(("s", len(vals)))
        vals += [cs.sph_c[r, 0], cs.sph_c[r, 1], cs.sph_c[r, 2],
                 cs.sph_r2[r, 0]]
        vals += mat_block(r)
    for j in range(cs.n_quad_real):
        row = cs.ns + j
        prims.append(("q", len(vals)))
        vals += [cs.quad_n[j, 0], cs.quad_n[j, 1], cs.quad_n[j, 2],
                 cs.quad_dp[j, 0],
                 cs.quad_av[j, 0], cs.quad_av[j, 1], cs.quad_av[j, 2],
                 cs.quad_ca[j, 0],
                 cs.quad_bv[j, 0], cs.quad_bv[j, 1], cs.quad_bv[j, 2],
                 cs.quad_cb[j, 0],
                 pay[4, row], pay[5, row], pay[6, row]]
        vals += mat_block(row)

    nw = max(8, ((len(vals) + 7) // 8) * 8)
    tab = np.zeros((1, nw), np.float32)
    tab[0, : len(vals)] = np.asarray(vals, np.float32)
    return tab, tuple(prims)


def camera_vector(camera: Camera, background) -> np.ndarray:
    """(1, 32) f32 camera/background row: 0:3 position, 3:6 viewport
    upper-left, 6:9 horizontal, 9:12 vertical, 12:15 / 15:18 defocus
    u / v, 18 1/(w-1), 19 1/(h-1), 20:23 background (bottom of a gradient
    sky), 24:27 sky top. A constant background stores top == bottom."""
    cam = np.zeros((1, 32), np.float32)
    cam[0, 0:3] = camera.position.cpu().numpy()
    cam[0, 3:6] = camera.viewport_upper_left.cpu().numpy()
    cam[0, 6:9] = camera.horizontal.cpu().numpy()
    cam[0, 9:12] = camera.vertical.cpu().numpy()
    cam[0, 12:15] = camera.defocus_disk_u.cpu().numpy()
    cam[0, 15:18] = camera.defocus_disk_v.cpu().numpy()
    cam[0, 18] = 1.0 / (camera.width - 1)
    cam[0, 19] = 1.0 / (camera.height - 1)
    bg = np.asarray(background, np.float32)
    if bg.shape == (2, 3):
        cam[0, 20:23] = bg[0]
        cam[0, 24:27] = bg[1]
    else:
        cam[0, 20:23] = bg
        cam[0, 24:27] = bg
    return cam


@dataclasses.dataclass(frozen=True)
class LoweredScene:
    """Everything the packed megakernel reads, on the host."""

    table: np.ndarray   # (NW,) f32
    cam: np.ndarray     # (32,) f32
    n_sph: int
    n_quad: int
    has_met: bool
    has_die: bool
    sky: bool


def _is_sky(background) -> bool:
    return np.asarray(background, np.float32).shape == (2, 3)


def lower(scene: SceneArrays, camera: Camera, background) -> LoweredScene:
    cs = compact_scene(scene)
    tab, _ = scene_table(cs, payload_matrix(scene, cs))
    has_met, has_die = used_kind_flags(scene)
    return LoweredScene(
        table=tab[0],
        cam=camera_vector(camera, background)[0],
        n_sph=cs.n_sph_real,
        n_quad=cs.n_quad_real,
        has_met=has_met,
        has_die=has_die,
        sky=_is_sky(background),
    )


# Sphere rows per block of the culled sweep: one AABB per block. The JAX
# package's default row-streaming width (TINYRT_ROW_CHUNK).
ROW_CHUNK = 256


def morton_order(centers: np.ndarray) -> np.ndarray:
    """Stable argsort of the spheres' Morton (Z-order) codes, 10 bits per
    axis over the centers' bounding box: spheres near each other land in
    the same block of the culled sweep."""
    lo = centers.min(axis=0)
    span = np.maximum(centers.max(axis=0) - lo, 1e-12)
    q = np.clip(((centers - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def build_chunk_aabbs(cs: CompactScene, chunk: int) -> tuple:
    """(cmin (K, 3), cmax (K, 3)) f32 AABBs of the sphere row blocks.

    Block i covers compacted sphere rows [min(i*c, ns-c), +c) with
    c = min(chunk, ns): the tail block's base is clamped, so it re-covers
    rows of the block before it. Each AABB spans the real members'
    center +- |r|, widened by 5e-5. A block with no real member keeps
    (1, -1); the slab test orders each corner pair, so that box is the
    cube [-1, 1]^3, not an empty one, and it is never reached: padding
    adds at most 7 inert rows."""
    ns = cs.ns
    c = min(chunk, ns)
    k = -(-ns // c)
    r = np.sqrt(cs.sph_r2[:, 0])
    real = cs.sph_c[:, 0] < 1e29
    cmin = np.full((k, 3), 1.0, np.float32)
    cmax = np.full((k, 3), -1.0, np.float32)
    for i in range(k):
        base = min(i * c, ns - c)
        m = real[base:base + c]
        if not m.any():
            continue
        cb = cs.sph_c[base:base + c][m]
        rb = r[base:base + c][m][:, None]
        cmin[i] = (cb - rb).min(axis=0) - 5e-5
        cmax[i] = (cb + rb).max(axis=0) + 5e-5
    return cmin, cmax


@dataclasses.dataclass(frozen=True)
class FlatScene:
    """Everything the classic-layout megakernel (K2) reads, on the host.

    Rows are AoS so that one thread reads a whole row with float4 loads;
    every thread of a warp reads the same row, so each load is a
    broadcast. Inert pad rows (to multiples of 8) are kept, so row
    numbers equal the JAX package's; the kernel walks real rows only.
    """

    sph: np.ndarray      # (ns, 4) f32: cx cy cz r^2
    quad: np.ndarray     # (nq, 12) f32: n(3) dp av(3) ca bv(3) cb
    pay: np.ndarray      # (NA, 16) f32: the sphere block's payload rows
                         # (when there are spheres), then the quad block's
    aabbs: Optional[np.ndarray]  # (K, 8) f32: min xyz, 0, max xyz, 0
    cam: np.ndarray      # (32,) f32 camera vector
    n_sph: int           # real spheres (rows [0, n_sph) of `sph`)
    n_quad: int          # real quads (rows [0, n_quad) of `quad`)
    has_met: bool
    has_die: bool
    sky: bool


def lower_flat(scene: SceneArrays, camera: Camera, background, *,
               chunk_cull: bool) -> FlatScene:
    """K2's inputs. With `chunk_cull` the spheres are Morton-ordered and
    each ROW_CHUNK block gets an AABB, as the JAX package lowers a scene
    it culls; without it the rows keep scene order and `aabbs` is None.
    The payload is megakernel._active_payload's (16, NA), transposed."""
    order = None
    if chunk_cull:
        a = scene.numpy()
        order = morton_order(
            a["sph_center"].astype(np.float32)[a["sph_valid"].astype(bool)])
    cs = compact_scene(scene, sphere_order=order)
    if cs.n_sph_real + cs.n_quad_real == 0:
        raise ValueError("scene has no primitives")
    pay = payload_matrix(scene, cs)
    lo = 0 if cs.n_sph_real else cs.ns
    hi = cs.ns + cs.nq if cs.n_quad_real else cs.ns
    aabbs = None
    if chunk_cull:
        cmin, cmax = build_chunk_aabbs(cs, ROW_CHUNK)
        aabbs = np.zeros((cmin.shape[0], 8), np.float32)
        aabbs[:, 0:3] = cmin
        aabbs[:, 4:7] = cmax
    has_met, has_die = used_kind_flags(scene)
    return FlatScene(
        sph=np.ascontiguousarray(
            np.concatenate([cs.sph_c, cs.sph_r2], 1), np.float32),
        quad=np.ascontiguousarray(np.concatenate(
            [cs.quad_n, cs.quad_dp, cs.quad_av, cs.quad_ca, cs.quad_bv,
             cs.quad_cb], 1), np.float32),
        pay=np.ascontiguousarray(pay[:, lo:hi].T),
        aabbs=aabbs,
        cam=camera_vector(camera, background)[0],
        n_sph=cs.n_sph_real,
        n_quad=cs.n_quad_real,
        has_met=has_met,
        has_die=has_die,
        sky=_is_sky(background),
    )
