"""Packed fused differentiable kernel K5: forward NEE render, MSE loss and
hand-derived reverse sweep in one launch.

Port of the JAX package's `_make_packed_diff_kernel`
(ops/diffkernel_packed.py:240), the fused training objective of scenes
with at most 48 real primitives and 16 real spheres. It computes, per
pixel:

1. the forward NEE image over the samples (closest hit with a strict `<`
   first minimum over spheres then quads, shading, a light sample and its
   shadow ray, the emission-skip rule);
2. the loss cotangent 2 (img - target) / (npix * 3 * spp) and the pixel's
   MSE term;
3. for each sample, a replay of its bounces that saves 14 values per
   bounce (ray state, winner t and row, shadow visibility), then a walk
   back over them through each bounce's vector-Jacobian product: scatter,
   NEE with the sphere and quad soft shadows, emission and background,
   the sphere and quad silhouettes, and t -> point -> geometry. The
   products land in gradient tables of sphere center and radius, quad
   corner/u/v, material albedo/fuzz/ior/emission, lights, background.

`packed_diff` is the kernel's wrapper: on a CPU tensor it runs
`packed_diff_reference`, the plain PyTorch twin; on a CUDA tensor it
launches csrc/diffkernel_packed.cu (an image kernel for step 1, then the
fused kernel), built at first use, and raises if the launch fails. Each
launch adds one to the host counter `launches.packed_diff`
(utils/profiling.py); while a profiler records, the launcher times its
three stages (`STAGES`) as `k5.<stage>`.
`render_value_and_grad_packed` takes a scene to (loss, image, grads)
through the wrapper; `render_value_and_grad_packed_reference` does the
same through the twin. The flat table (`packed_flat_table`), the spec
and the twin serve the classic-layout kernel K4 as well
(ops/diffkernel.classic_diff), which runs the same estimator with any
surrogate scope: the spec's per-class row lists (every row, none, or a
subset) say which rows' surrogates run.

The twin is vectorised over pixels and runs samples and bounces in
lockstep, in the kernels' operation order; the surrogate chains run as
(rows, pixels) matrices over the scope's rows, in pixel chunks. Its image
equals the kernels' bit for bit: a lane whose path ended is frozen where
a kernel's thread leaves the bounce loop. Its gradient tables are sums
over pixels and rows in another order than the kernels', so they agree
to reassociation.

The TPU kernel's (S, L) tiling, its relayout and its phase-1 intersection
cache are not carried over: the RNG keys off the pixel id, the CUDA
kernels give each thread whole pixels (ops/diff_schedule.py), and the cache
only fit the replay into TPU VMEM (its values are identical without it).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.ops import diff_schedule, rng, scene_table
from tinyraytracer_tpu_torch.utils import profiling
from tinyraytracer_tpu_torch.ops.diffkernel import (
    _MISS,
    _T_MIN,
    _TWO_PI,
    DIFF_PACKED_MAX_ACC,
    DiffStatic,
    _grads_to_scene,
    build_diff_static,
    packed_acc_width,
    static_kind_flags,
)
from tinyraytracer_tpu_torch.ops.megakernel import (
    CANDIDATE_BUDGET,
    dense_closest_hit,
    pixel_range,
)

_MASK = 0xFFFFFFFF

# Per-prim blocks of the flat table (diffkernel_packed.py:131-136).
_SPH_F = 15   # cx cy cz r2 r | kind ar ag ab fuzz ior er eg eb | matrow
_QUAD_F = 31  # n3 dp av3 ca bv3 cb | qc3 qu3 qv3 | mat block 9 | matrow
_MAT_OFF_S = 5
_GEO_OFF_Q = 12
_MAT_OFF_Q = 21
_LIGHT_F = 12  # corner(3) u(3) v(3) emit(3)

# Quad edge-surrogate width (diffkernel_packed.py:888).
_WQE = 0.05
# How far the kernel's loss and gradient tables may stand from the twin's,
# as a share of each table's largest entry: both sum the same terms, the
# kernel per thread and then over blocks in a fixed order, the twin over
# pixels per bounce.
TABLE_RTOL = 1e-5


@dataclasses.dataclass(frozen=True)
class _TableIndex:
    """The static part of packed_flat_table on one device: row and
    material indices, kind codes and the table's layout."""

    sph: torch.Tensor       # real sphere rows
    sph_mat: torch.Tensor   # their material rows
    quad: torch.Tensor
    quad_mat: torch.Tensor
    light_quad: torch.Tensor
    light_mat: torch.Tensor
    kinds: torch.Tensor     # (n_mat,) f32 kind codes
    prims: tuple
    light_off: int
    nw: int


@functools.lru_cache(maxsize=16)
def _table_index(st: DiffStatic, device: str) -> _TableIndex:
    ns_r, nq_r = len(st.sph_rows), len(st.quad_rows)
    idx = lambda v: torch.tensor(v, dtype=torch.long,  # noqa: E731
                                 device=device)
    prims = tuple(("s", _SPH_F * i, i) for i in range(ns_r)) + tuple(
        ("q", _SPH_F * ns_r + _QUAD_F * j, st.ns + j) for j in range(nq_r))
    light_off = _SPH_F * ns_r + _QUAD_F * nq_r
    off = light_off + _LIGHT_F * st.n_lights
    return _TableIndex(
        sph=idx(st.sph_rows), sph_mat=idx(st.mat_ids[:ns_r]),
        quad=idx(st.quad_rows), quad_mat=idx(st.mat_ids[st.ns:st.ns + nq_r]),
        light_quad=idx(st.light_quad_rows), light_mat=idx(st.light_mat_rows),
        kinds=torch.tensor(st.mat_kinds, dtype=torch.float32, device=device),
        prims=prims, light_off=light_off, nw=max(8, ((off + 7) // 8) * 8))


def packed_flat_table(scene, st: DiffStatic):
    """The scene as one flat f32 row, on the scene's device, built from
    the live params with tensor ops (the static indices are cached per
    scene structure and device).

    Spheres (_SPH_F floats each), then quads (_QUAD_F), then lights
    (_LIGHT_F), zero-padded to a multiple of 8. The quad plane and
    planar-coordinate rows (n, n.corner, av, ca, bv, cb) are derived here
    with the JAX package's formulas. Returns (tab (1, NW) f32, prims,
    light_off) with prims a tuple of ("s"|"q", offset, padded row).

    It is the table of both fused kernels: K5 reads it from shared
    memory, K4 from global memory. (JAX's K4 reads `diff_tables`, column
    tables it derives the quad planes from in the kernel; one AoS layout
    serves both CUDA kernels, a row being what a thread reads in its walk,
    and the planes are derived once per step here rather than per ray.)"""
    f32 = torch.float32
    ix = _table_index(st, str(scene.sph_center.device))

    def mat_cols(m):
        return [ix.kinds.index_select(0, m)[:, None],
                scene.mat_albedo.index_select(0, m).to(f32),
                scene.mat_fuzz.index_select(0, m).to(f32)[:, None],
                scene.mat_ior.index_select(0, m).to(f32)[:, None],
                scene.mat_emit.index_select(0, m).to(f32),
                m.to(f32)[:, None]]

    blocks = []
    if ix.sph.numel():
        c = scene.sph_center.index_select(0, ix.sph).to(f32)
        rad = scene.sph_radius.index_select(0, ix.sph).to(f32)[:, None]
        blocks.append(torch.cat([c, rad * rad, rad] + mat_cols(ix.sph_mat),
                                1).reshape(-1))
    if ix.quad.numel():
        qc = scene.quad_corner.index_select(0, ix.quad).to(f32)
        qu = scene.quad_u.index_select(0, ix.quad).to(f32)
        qv = scene.quad_v.index_select(0, ix.quad).to(f32)
        n = _cross(qu, qv)
        nn = torch.clamp_min(_dot(n, n), 1e-30)[:, None]
        dp = _dot(n, qc)[:, None]
        av = _cross(qv, n) / nn
        ca = _dot(av, qc)[:, None]
        bv = _cross(n, qu) / nn
        cb = _dot(bv, qc)[:, None]
        blocks.append(torch.cat([n, dp, av, ca, bv, cb, qc, qu, qv]
                                + mat_cols(ix.quad_mat), 1).reshape(-1))
    if ix.light_quad.numel():
        lq, lm = ix.light_quad, ix.light_mat
        blocks.append(torch.cat(
            [scene.quad_corner.index_select(0, lq).to(f32),
             scene.quad_u.index_select(0, lq).to(f32),
             scene.quad_v.index_select(0, lq).to(f32),
             scene.mat_emit.index_select(0, lm).to(f32)], 1).reshape(-1))
    tab = torch.zeros((1, ix.nw), dtype=f32, device=scene.sph_center.device)
    if blocks:
        flat = torch.cat(blocks)
        tab[0, :flat.numel()] = flat
    return tab, ix.prims, ix.light_off


def _cross(a, b):
    """Row-wise cross product of (n, 3) tensors, jnp.cross's formula."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


@dataclasses.dataclass(frozen=True)
class PackedSpec:
    """What the TPU kernels compile in and the CUDA kernels (K5 and K4)
    read as arguments: the table's layout, the estimator's switches and
    the surrogate scope."""

    n_sph: int          # real spheres, first in the table
    n_quad: int         # real quads, after the spheres
    n_lights: int       # real lights, at light_off
    ns: int             # padded rows of the gradient tables
    nq: int
    nm: int
    nl: int
    light_off: int
    # index among the quads of the one light that the soft shadow skips
    # (its own plane crossing is never an occluder); -1 with 0 or >1 lights
    light_quad: int
    nee: bool
    sil: bool
    has_met: bool
    has_die: bool
    # table rows (sphere i, quad j among the real ones, ascending) whose
    # soft-shadow and silhouette surrogates run: every row of the class
    # (dense), none (the class off) or a subset (K4 only)
    surr_s: tuple
    surr_q: tuple

    @property
    def acc_width(self) -> int:
        return packed_acc_width(self.n_sph, self.n_quad, self.nm,
                                self.n_lights)

    @property
    def class_scope(self) -> bool:
        """Whether each class's scope is all of its rows or none, which
        is what K5 takes."""
        return (self.surr_s in ((), tuple(range(self.n_sph)))
                and self.surr_q in ((), tuple(range(self.n_quad))))


def _scope_rows(scope, n: int) -> tuple:
    """A class's surrogate rows: True = all n, False = none, or the
    given table rows."""
    if scope is True:
        return tuple(range(n))
    if scope is False:
        return ()
    rows = tuple(sorted(int(r) for r in scope))
    if any(r < 0 or r >= n for r in rows) or len(set(rows)) != len(rows):
        raise ValueError(f"surrogate rows {rows} are not distinct rows of "
                         f"a class of {n}")
    return rows


@functools.lru_cache(maxsize=64)
def packed_spec(st: DiffStatic, light_off: int, *, nee: bool = True,
                sil: bool = True, surr_sph=True, surr_quad=True) -> PackedSpec:
    """`surr_sph` / `surr_quad`: True (the whole class), False (off) or a
    tuple of the class's table rows."""
    has_met, has_die = static_kind_flags(st)
    light_quad = (st.quad_rows.index(st.light_quad_rows[0])
                  if st.n_lights == 1 else -1)
    return PackedSpec(
        n_sph=len(st.sph_rows), n_quad=len(st.quad_rows),
        n_lights=st.n_lights, ns=st.ns, nq=st.nq, nm=st.nm, nl=st.nl,
        light_off=light_off, light_quad=light_quad, nee=nee, sil=sil,
        has_met=has_met, has_die=has_die,
        surr_s=_scope_rows(surr_sph, len(st.sph_rows)),
        surr_q=_scope_rows(surr_quad, len(st.quad_rows)))


@functools.lru_cache(maxsize=64)
def _acc_index(spec: PackedSpec) -> np.ndarray:
    """Where each accumulator float goes in the concatenated padded
    tables [dsph (ns, 8) | dquad (nq, 16) | dmat (nm, 8) | dlight
    (nl, 16) | dmisc (8, 128)]."""
    o_q = spec.ns * 8
    o_m = o_q + spec.nq * 16
    o_l = o_m + spec.nm * 8
    o_x = o_l + spec.nl * 16
    idx = [8 * i + c for i in range(spec.n_sph) for c in range(4)]
    idx += [o_q + 16 * j + c for j in range(spec.n_quad) for c in range(9)]
    idx += [o_m + 8 * m + c for m in range(spec.nm) for c in range(8)]
    idx += [o_l + 16 * k + c for k in range(spec.n_lights)
            for c in range(12)]
    idx += [o_x + c for c in range(4)]
    return np.asarray(idx, np.int64)


@functools.lru_cache(maxsize=64)
def _acc_index_on(spec: PackedSpec, device: str) -> torch.Tensor:
    """_acc_index on the device, copied there once per spec: a copy from
    pageable memory after each launch may make the host wait for the
    kernel before it queues the rest of the step."""
    return torch.from_numpy(_acc_index(spec)).to(device)


def tables_from_acc(acc: torch.Tensor, spec: PackedSpec):
    """The padded gradient tables (dsph, dquad, dmat, dlight, dmisc) from
    a kernel's summed accumulator vector."""
    total = 8 * (spec.ns + 2 * spec.nq + spec.nm + 2 * spec.nl + 128)
    flat = torch.zeros((total,), dtype=torch.float32, device=acc.device)
    flat[_acc_index_on(spec, str(acc.device))] = acc
    return _split_tables(flat, spec)


def _split_tables(flat: torch.Tensor, spec: PackedSpec):
    sizes = [spec.ns * 8, spec.nq * 16, spec.nm * 8, spec.nl * 16, 8 * 128]
    shapes = [(spec.ns, 8), (spec.nq, 16), (spec.nm, 8), (spec.nl, 16),
              (8, 128)]
    return tuple(p.view(s) for p, s in zip(torch.split(flat, sizes),
                                           shapes))


def _check(tab, cam, target, spec, width, height, spp, max_bounces,
           pixels=None):
    """Validates a launch's inputs; returns its pixel range (begin,
    count), the whole image for `pixels` None."""
    for name, t in (("tab", tab), ("cam", cam), ("target", target)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}")
        if t.device != tab.device:
            raise ValueError(f"{name} on {t.device}, tab on {tab.device}")
    if tab.dim() != 1 or tuple(cam.shape) != (32,):
        raise ValueError(f"tab must be 1-d and cam (32,), got "
                         f"{tuple(tab.shape)} and {tuple(cam.shape)}")
    begin, count = pixel_range(width, height, pixels)
    want = (height, width, 3) if pixels is None else (count, 3)
    if tuple(target.shape) != want:
        raise ValueError(f"target must be {want}, got "
                         f"{tuple(target.shape)}")
    if (spec.light_off + _LIGHT_F * spec.n_lights > tab.numel()
            or spec.light_off != _SPH_F * spec.n_sph
            + _QUAD_F * spec.n_quad):
        raise ValueError("the table does not hold the spec's primitives")
    if width < 2 or height < 2 or spp < 1 or max_bounces < 1:
        raise ValueError(f"need an image of at least 2x2 and spp, "
                         f"max_bounces >= 1; got {width}x{height}, "
                         f"spp={spp}, max_bounces={max_bounces}")
    return begin, count


# The stages a K5 or K4 launcher times while a profiler records
# (csrc/diff_common.cuh, Stage): the image kernel, the replay and adjoint
# (K4's walk), the reduce of the gradient parts.
STAGES = ("image", "adjoint", "reduce")


def stage_handles(prefix: str, device):
    """The stage events of a K5 or K4 launch while a profiler records, as
    (a ctypes array of their handles, its address for the launcher): the
    caller keeps the array alive across the call. (None, None)
    otherwise."""
    events = profiling.stage_events(prefix, STAGES, device)
    if events is None:
        return None, None
    handles = (ctypes.c_void_p * len(events))(*[e.cuda_event
                                                 for e in events])
    return handles, ctypes.addressof(handles)


def packed_diff(tab: torch.Tensor, cam: torch.Tensor, target: torch.Tensor,
                *, spec: PackedSpec, width: int, height: int, spp: int,
                max_bounces: int, seed: int = 0, spp_offset: int = 0,
                pixels: tuple | None = None):
    """K5 on the device of `tab`: (image (H, W, 3), dsph (ns, 8), dquad
    (nq, 16), dmat (nm, 8), dlight (nl, 16), dmisc (8, 128)), all f32;
    dmisc[0, 0:3] is the background gradient and dmisc[0, 3] the loss.

    `tab` is packed_flat_table's row (flattened), `cam` the 32-word
    camera vector with word 23 = width * height, `target` (H, W, 3).
    With `pixels` (begin, count), a mesh shard's range of flat pixel ids,
    `target` and the image are those pixels' (count, 3) rows, and the
    tables and loss are their share of the whole image's: the loss and
    its cotangent keep the whole image's scale (cam[23])."""
    begin, npix = _check(tab, cam, target, spec, width, height, spp,
                         max_bounces, pixels)
    kw = dict(spec=spec, width=width, height=height, spp=spp,
              max_bounces=max_bounces, seed=seed, spp_offset=spp_offset,
              pixels=pixels)
    if tab.device.type == "cpu":
        with profiling.annotate("tinyrt.train.launch"):
            return packed_diff_reference(tab, cam, target, **kw)
    if tab.device.type != "cuda":
        raise ValueError(f"no diff kernel for device {tab.device}")
    with profiling.annotate("tinyrt.train.launch"):
        img, acc = _launch_packed(tab, cam, target, spec, width, height,
                                  spp, max_bounces, seed, spp_offset, begin,
                                  npix)
    profiling.count("launches.packed_diff")
    with profiling.annotate("tinyrt.train.grads"):
        return (img, *tables_from_acc(acc, spec))


def _launch_packed(tab, cam, target, spec, width, height, spp, max_bounces,
                   seed, spp_offset, begin, npix):
    """packed_diff's launch on the card: (image, summed accumulator)."""
    if spec.acc_width > DIFF_PACKED_MAX_ACC:
        raise ValueError(f"the scene needs {spec.acc_width} gradient "
                         f"accumulators per thread; the kernel holds "
                         f"{DIFF_PACKED_MAX_ACC}")
    if not spec.class_scope:
        raise ValueError("K5 takes class-level surrogate scopes only; a "
                         "row subset runs on K4 (diffkernel.classic_diff)")
    lib = _build.load()
    dev = tab.device
    na = spec.acc_width
    nee, sil, met, die = diff_schedule.variant_flags(spec)
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        plan, shared = k5_plan(lib, (nee, sil, met, die), tab.numel(), na,
                               npix, max_bounces)
        split = image_plan(lib, "packed", (nee, sil, met, die), tab.numel(),
                           npix, spp)
        img = torch.empty(target.shape, **f32)
        samples = torch.empty((spp * npix * 3 if split > 1 else 0,), **f32)
        saves = torch.empty((plan.saves_floats,), **f32)
        part = torch.empty((plan.blocks, na), **f32)
        acc = torch.empty((na,), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _handles, events = stage_handles("k5", dev)
        err = lib.tinyrt_diff_packed(
            cam.data_ptr(), tab.data_ptr(), tab.numel(), spec.n_sph,
            spec.n_quad, spec.n_lights, spec.nm, spec.light_quad,
            target.data_ptr(), img.data_ptr(), saves.data_ptr(),
            part.data_ptr(), acc.data_ptr(), width, height,
            seed & _MASK, spp_offset & _MASK, spp, max_bounces,
            float(np.float32(1.0 / spp)), int(nee), int(sil), int(met),
            int(die), int(bool(spec.surr_s)), int(bool(spec.surr_q)),
            plan.blocks, plan.slots, int(shared), split, samples.data_ptr(),
            begin, npix, events, stream)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"diffkernel_packed launch failed: CUDA error "
                           f"{err} ({msg})")
    return img, acc


@functools.lru_cache(maxsize=256)
def _occupancy(lib, kernel: str, flags: tuple, nw: int, na: int,
               shared: bool, image: bool, device: int) -> tuple:
    """(blocks per SM, SMs) of K5 ("packed") or K4 ("classic"), or of its
    image kernel, for a variant on the current device (`device` keys the
    cache)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    if kernel == "packed":
        err = lib.tinyrt_diff_packed_occupancy(
            nw, na, int(shared), int(image), *map(int, flags),
            ctypes.byref(per_sm), ctypes.byref(sms))
    else:
        err = lib.tinyrt_diff_classic_occupancy(
            int(image), *map(int, flags), ctypes.byref(per_sm),
            ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"diff kernel occupancy query failed: CUDA error "
                           f"{err} ({lib.tinyrt_error_string(err).decode()})")
    return per_sm.value, sms.value


def image_plan(lib, kernel: str, flags: tuple, nw: int, npix: int,
               spp: int) -> int:
    """The sample parts of a launch's image kernel on the current device
    (diff_schedule.image_split)."""
    per_sm, sms = _occupancy(lib, kernel, flags, nw, 0, False, True,
                             torch.cuda.current_device())
    return diff_schedule.image_split(npix, spp, per_sm, sms)


def k5_plan(lib, flags: tuple, nw: int, na: int, npix: int,
            max_bounces: int):
    """K5's launch on the current device: (diff_schedule.Plan, whether
    the accumulator lives in shared memory). A thread's accumulator is its
    column of a [na][128] block of shared memory when that costs no block
    per SM against a local array (so when na is small), else a local
    array."""
    dev = torch.cuda.current_device()
    local = _occupancy(lib, "packed", flags, nw, na, False, False, dev)
    shared = _occupancy(lib, "packed", flags, nw, na, True, False, dev)
    use = shared[0] >= local[0] and shared[0] > 0
    per_sm, sms = shared if use else local
    return diff_schedule.plan(npix, per_sm, sms, max_bounces), use


# --- the plain PyTorch twin -------------------------------------------------

def _sigmoid(x):
    # one spelling in the kernel and the twin: 1 / (1 + exp(-x))
    return 1.0 / (1.0 + torch.exp(-x))


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _f(b):
    return b.to(torch.float32)


class _Twin:
    """One twin call: the table's scalars and the estimator's steps,
    each a function of (N,) pixel tensors in the kernel's op order. The
    surrogate chains run on (k, N) matrices over the scope's rows."""

    def __init__(self, tab, cam, spec: PackedSpec, seed):
        self.spec, self.seed = spec, seed
        self.dev = tab.device
        self.tb = tab.unbind(0)
        self.c = cam.unbind(0)
        ns, nq = spec.n_sph, spec.n_quad
        sph = tab[: ns * _SPH_F].view(ns, _SPH_F)
        quad = tab[ns * _SPH_F: ns * _SPH_F + nq * _QUAD_F].view(nq, _QUAD_F)
        self.lights = tab[spec.light_off:
                          spec.light_off + spec.n_lights * _LIGHT_F].view(
                              spec.n_lights, _LIGHT_F)
        z = lambda n: torch.zeros((n, 1), dtype=torch.float32,  # noqa: E731
                                  device=self.dev)
        # winner fields per prim, table order: padded row, isq, center (3),
        # radius, material block (10), quad corner/u/v (9)
        rows = torch.arange(ns + nq, dtype=torch.float32, device=self.dev)
        rows[ns:] += spec.ns - ns
        sfields = torch.cat([z(ns), sph[:, 0:3], sph[:, 4:5],
                             sph[:, _MAT_OFF_S:_MAT_OFF_S + 10],
                             z(ns).expand(ns, 9)], 1)
        qfields = torch.cat([z(nq) + 1.0, z(nq).expand(nq, 4),
                             quad[:, _MAT_OFF_Q:_MAT_OFF_Q + 10],
                             quad[:, _GEO_OFF_Q:_GEO_OFF_Q + 9]], 1)
        pay = torch.cat([rows[:, None], torch.cat([sfields, qfields], 0)], 1)
        self._hit = dense_closest_hit(sph[:, :4], quad[:, :12], pay)
        # the scope's rows, and their geometry as (k, 1) columns; the quad
        # soft shadow skips the one light's own quad, as the kernels do
        idx = lambda v: torch.tensor(v, dtype=torch.long,  # noqa: E731
                                     device=self.dev)
        self.s_rows = idx(spec.surr_s)
        self.q_rows = idx(spec.surr_q)
        self.qs_rows = idx([j for j in spec.surr_q if j != spec.light_quad])
        self.s_geo = tuple(sph[self.s_rows, k:k + 1] for k in (0, 1, 2, 4))
        self.q_geo = tuple(quad[self.q_rows, _GEO_OFF_Q + k:_GEO_OFF_Q + k + 1]
                           for k in range(9))
        self.qs_geo = tuple(
            quad[self.qs_rows, _GEO_OFF_Q + k:_GEO_OFF_Q + k + 1]
            for k in range(9))

    def set_pixels(self, pid, width):
        """The lanes of the next steps: pixel ids (N,) int64."""
        self.pid = pid
        self.px = (pid % width).to(torch.float32)
        self.py = (pid // width).to(torch.float32)

    # -- intersection ------------------------------------------------------
    def closest_hit(self, ox, oy, oz, dx, dy, dz):
        """(best t, hit, winner fields dict); fields are 0 on a miss and
        rowf is the padded row of the winner (0 on a miss)."""
        best, hit, w = self._hit(ox, oy, oz, dx, dy, dz)
        names = ("rowf", "isq", "wcx", "wcy", "wcz", "wrad", "kind", "war",
                 "wag", "wab", "wfuzz", "wior", "wer", "weg", "web", "wmat",
                 "wqcx", "wqcy", "wqcz", "wqux", "wquy", "wquz", "wqvx",
                 "wqvy", "wqvz")
        return best, hit, dict(zip(names, w))

    def occluded_t(self, ox, oy, oz, dx, dy, dz):
        return self._hit(ox, oy, oz, dx, dy, dz)[0]

    def camera_ray(self, samp):
        c = self.c
        r1, r2, r3, r4 = rng.uniform4(self.seed, self.pid, samp, 0)
        u = (self.px + r1) * c[18]
        v = (self.py + r2) * c[19]
        rad = torch.sqrt(r3)
        th = _TWO_PI * r4
        cth, sth = torch.cos(th), torch.sin(th)
        o = [c[k] + rad * cth * c[12 + k] + rad * sth * c[15 + k]
             for k in range(3)]
        t = [c[3 + k] + u * c[6 + k] - v * c[9 + k] - o[k] for k in range(3)]
        inv = 1.0 / torch.sqrt(torch.clamp_min(
            t[0] * t[0] + t[1] * t[1] + t[2] * t[2], 1e-30))
        return o[0], o[1], o[2], t[0] * inv, t[1] * inv, t[2] * inv

    # -- shade: all per-bounce intermediates from (state, winner) ----------
    def shade(self, samp, b, st, best_t, hit, wf):
        sp = self.spec
        (ox, oy, oz, dx, dy, dz, tr_, tg_, tb_, alive_f, pd_f) = st
        g = dict(wf)
        isq, wcx, wcy, wcz = wf["isq"], wf["wcx"], wf["wcy"], wf["wcz"]
        kind, wrad = wf["kind"], wf["wrad"]
        wqcx, wqcy, wqcz = wf["wqcx"], wf["wqcy"], wf["wqcz"]
        wqux, wquy, wquz = wf["wqux"], wf["wquy"], wf["wquz"]
        wqvx, wqvy, wqvz = wf["wqvx"], wf["wqvy"], wf["wqvz"]
        alive = alive_f > 0.5
        hit_live = alive & hit
        miss_live = alive & ~hit
        hlf, mlf = _f(hit_live), _f(miss_live)

        ocx, ocy, ocz = ox - wcx, oy - wcy, oz - wcz
        hb = _dot3(ocx, ocy, ocz, dx, dy, dz)
        cterm = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - wrad * wrad
        disc = hb * hb - cterm
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        sq_safe = torch.clamp_min(sq, 1e-8)
        t0 = -hb - sq
        t1 = -hb + sq
        use0 = t0 >= _T_MIN
        t_sph = torch.where(use0, t0, t1)
        wnx, wny, wnz = _cross3(wqux, wquy, wquz, wqvx, wqvy, wqvz)
        dden = _dot3(wnx, wny, wnz, dx, dy, dz)
        dden = torch.where(torch.abs(dden) < 1e-12, 1e-12, dden)
        num = _dot3(wnx, wny, wnz, wqcx - ox, wqcy - oy, wqcz - oz)
        t_quad = num / dden
        quad_w = isq > 0.5
        t_diff = torch.where(quad_w, t_quad, t_sph)
        t = torch.where(hit, t_diff, 1.0)
        p_x, p_y, p_z = ox + t * dx, oy + t * dy, oz + t * dz
        mx_, my_, mz_ = p_x - wcx, p_y - wcy, p_z - wcz
        rho = torch.sqrt(torch.clamp_min(_dot3(mx_, my_, mz_, mx_, my_, mz_),
                                         1e-24))
        sx_o, sy_o, sz_o = mx_ / rho, my_ / rho, mz_ / rho
        qlen = torch.sqrt(torch.clamp_min(
            _dot3(wnx, wny, wnz, wnx, wny, wnz), 1e-24))
        qx_o, qy_o, qz_o = wnx / qlen, wny / qlen, wnz / qlen
        n_ox = torch.where(quad_w, qx_o, sx_o)
        n_oy = torch.where(quad_w, qy_o, sy_o)
        n_oz = torch.where(quad_w, qz_o, sz_o)
        front = _dot3(dx, dy, dz, n_ox, n_oy, n_oz) < 0.0
        sgn = torch.where(front, 1.0, -1.0)
        nx_, ny_, nz_ = n_ox * sgn, n_oy * sgn, n_oz * sgn

        is_lam = kind < 0.5
        is_met = (kind >= 0.5) & (kind < 1.5)
        is_die = (kind >= 1.5) & (kind < 2.5)
        is_light = kind >= 2.5
        if sp.nee:
            nee_sampled = quad_w & is_light
            gate_e = hlf * (1.0 - pd_f * _f(nee_sampled))
        else:
            gate_e = hlf

        if sp.nee and sp.n_lights > 0:
            nu1, nu2, nu3, _ = rng.uniform4(self.seed, self.pid, samp,
                                            0x40000000 + b)
            kpick = torch.clamp((nu3 * float(sp.n_lights)).to(torch.int32),
                                0, sp.n_lights - 1)
            lt = self.lights[kpick.long()]
            (lcx, lcy, lcz, lux, luy, luz, lvx, lvy, lvz, ler, leg,
             leb) = lt.unbind(1)
            yx = lcx + nu1 * lux + nu2 * lvx
            yy = lcy + nu1 * luy + nu2 * lvy
            yz = lcz + nu1 * luz + nu2 * lvz
            tlx, tly, tlz = yx - p_x, yy - p_y, yz - p_z
            r2l = _dot3(tlx, tly, tlz, tlx, tly, tlz)
            r2g = torch.clamp_min(r2l, 1e-12)
            dist = torch.sqrt(r2g)
            idist = 1.0 / dist
            wlx, wly, wlz = tlx * idist, tly * idist, tlz * idist
            lnx, lny, lnz = _cross3(lux, luy, luz, lvx, lvy, lvz)
            area = torch.sqrt(torch.clamp_min(
                _dot3(lnx, lny, lnz, lnx, lny, lnz), 1e-24))
            ainv = 1.0 / area
            lnux, lnuy, lnuz = lnx * ainv, lny * ainv, lnz * ainv
            cosx = _dot3(nx_, ny_, nz_, wlx, wly, wlz)
            cy_raw = _dot3(lnux, lnuy, lnuz, wlx, wly, wlz)
            cosy = torch.abs(cy_raw)
            graw = cosx * cosy * area * float(sp.n_lights) / r2g
            geom = torch.clamp_max(graw, 16.0 * np.pi)
            activef = _f(hit_live & is_lam & (cosx > 0.0))
            g["nee_vals"] = dict(
                nu1=nu1, nu2=nu2, kpick=kpick, lux=lux, luy=luy, luz=luz,
                lvx=lvx, lvy=lvy, lvz=lvz, ler=ler, leg=leg, leb=leb,
                tlx=tlx, tly=tly, tlz=tlz, r2l=r2l, r2g=r2g, dist=dist,
                idist=idist, wlx=wlx, wly=wly, wlz=wlz, lnx=lnx, lny=lny,
                lnz=lnz, area=area, ainv=ainv, lnux=lnux, lnuy=lnuy,
                lnuz=lnuz, cosx=cosx, cy_raw=cy_raw, cosy=cosy, graw=graw,
                geom=geom, activef=activef)

        su1, su2, su3, su4 = rng.uniform4(self.seed, self.pid, samp, 1 + b)
        theta = _TWO_PI * su1
        cphi = 1.0 - 2.0 * su2
        sphi = torch.sqrt(torch.clamp_min(1.0 - cphi * cphi, 0.0))
        rr = torch.exp(torch.log(torch.clamp_min(su3, 1e-30)) * (1.0 / 3.0))
        bx = rr * sphi * torch.cos(theta)
        by = rr * sphi * torch.sin(theta)
        bz = rr * cphi
        bnorm = 1.0 / torch.sqrt(torch.clamp_min(bx * bx + by * by + bz * bz,
                                                 1e-24))
        ux_, uy_, uz_ = bx * bnorm, by * bnorm, bz * bnorm
        lx, ly, lz = nx_ + ux_, ny_ + uy_, nz_ + uz_
        degen = ((torch.abs(lx) < 1e-7) & (torch.abs(ly) < 1e-7)
                 & (torch.abs(lz) < 1e-7))
        lamx = torch.where(degen, nx_, lx)
        lamy = torch.where(degen, ny_, ly)
        lamz = torch.where(degen, nz_, lz)
        if sp.has_met or sp.has_die:
            sdn = _dot3(dx, dy, dz, nx_, ny_, nz_)
            rfx = dx - 2.0 * sdn * nx_
            rfy = dy - 2.0 * sdn * ny_
            rfz = dz - 2.0 * sdn * nz_
            g.update(sdn=sdn)
        if sp.has_met:
            wfuzz = wf["wfuzz"]
            mex, mey, mez = rfx + wfuzz * bx, rfy + wfuzz * by, rfz + wfuzz * bz
        if sp.has_die:
            wior = wf["wior"]
            eta = torch.where(front, 1.0 / torch.clamp_min(wior, 1e-6), wior)
            mcos_raw = -(nx_ * dx + ny_ * dy + nz_ * dz)
            cos_clip = mcos_raw < 1.0
            cosv = torch.clamp_max(mcos_raw, 1.0)
            sinv = torch.sqrt(torch.clamp_min(1.0 - cosv * cosv, 0.0))
            tir = eta * sinv > 1.0
            sr0 = (1.0 - eta) / (1.0 + eta)
            r0 = sr0 * sr0
            x = 1.0 - cosv
            x2 = x * x
            reflp = r0 + (1.0 - r0) * (x2 * x2 * x)
            cref = tir | (reflp > su4)
            ppx = eta * (dx + nx_ * cosv)
            ppy = eta * (dy + ny_ * cosv)
            ppz = eta * (dz + nz_ * cosv)
            plen2 = _dot3(ppx, ppy, ppz, ppx, ppy, ppz)
            zk = 1.0 - plen2
            kk = torch.clamp_min(torch.abs(zk), 1e-12)
            par = -torch.sqrt(kk)
            fx, fy, fz = ppx + par * nx_, ppy + par * ny_, ppz + par * nz_
            dnx_die = torch.where(cref, rfx, fx)
            dny_die = torch.where(cref, rfy, fy)
            dnz_die = torch.where(cref, rfz, fz)
            g.update(eta=eta, cosv=cosv, cos_clip=cos_clip, cref=cref,
                     ppx=ppx, ppy=ppy, ppz=ppz, zk=zk, kk=kk, par=par)
        if sp.has_met and sp.has_die:
            dnx = torch.where(is_lam, lamx, torch.where(is_met, mex, dnx_die))
            dny = torch.where(is_lam, lamy, torch.where(is_met, mey, dny_die))
            dnz = torch.where(is_lam, lamz, torch.where(is_met, mez, dnz_die))
        elif sp.has_met:
            dnx = torch.where(is_lam, lamx, mex)
            dny = torch.where(is_lam, lamy, mey)
            dnz = torch.where(is_lam, lamz, mez)
        elif sp.has_die:
            dnx = torch.where(is_lam, lamx, dnx_die)
            dny = torch.where(is_lam, lamy, dny_die)
            dnz = torch.where(is_lam, lamz, dnz_die)
        else:
            dnx, dny, dnz = lamx, lamy, lamz
        invl = 1.0 / torch.sqrt(torch.clamp_min(
            _dot3(dnx, dny, dnz, dnx, dny, dnz), 1e-24))
        scat = hit_live & ~is_light
        g.update(
            hit=hit, hlf=hlf, mlf=mlf, gate_e=gate_e, scf=_f(scat),
            is_lam=is_lam, is_met=is_met, is_die=is_die, quad_w=quad_w,
            wnx=wnx, wny=wny, wnz=wnz, ocx=ocx, ocy=ocy, ocz=ocz, hb=hb,
            sq_safe=sq_safe, use0=use0, dden=dden, t_quad=t_quad, t=t,
            p_x=p_x, p_y=p_y, p_z=p_z, rho=rho, sx_o=sx_o, sy_o=sy_o,
            sz_o=sz_o, qx_o=qx_o, qy_o=qy_o, qz_o=qz_o, qlen=qlen,
            front=front, sgn=sgn, nx_=nx_, ny_=ny_, nz_=nz_, bx=bx, by=by,
            bz=bz, invl=invl, sdx=dnx * invl, sdy=dny * invl,
            sdz=dnz * invl)
        return g

    def advance(self, g, st):
        (ox, oy, oz, dx, dy, dz, tr_, tg_, tb_, _alive, _pd) = st
        scf = g["scf"]
        inv = 1.0 - scf
        return (inv * ox + scf * g["p_x"], inv * oy + scf * g["p_y"],
                inv * oz + scf * g["p_z"], inv * dx + scf * g["sdx"],
                inv * dy + scf * g["sdy"], inv * dz + scf * g["sdz"],
                tr_ * (inv + scf * g["war"]), tg_ * (inv + scf * g["wag"]),
                tb_ * (inv + scf * g["wab"]), scf, scf * _f(g["is_lam"]))

    def color_adds(self, g, st, vis):
        tr_, tg_, tb_ = st[6], st[7], st[8]
        c = self.c
        mlf, gate_e = g["mlf"], g["gate_e"]
        cr = mlf * tr_ * c[20] + gate_e * tr_ * g["wer"]
        cg = mlf * tg_ * c[21] + gate_e * tg_ * g["weg"]
        cb = mlf * tb_ * c[22] + gate_e * tb_ * g["web"]
        if "nee_vals" in g:
            nv = g["nee_vals"]
            s = nv["activef"] * vis * nv["geom"] * (1.0 / np.pi)
            cr = cr + s * tr_ * g["war"] * nv["ler"]
            cg = cg + s * tg_ * g["wag"] * nv["leg"]
            cb = cb + s * tb_ * g["wab"] * nv["leb"]
        return cr, cg, cb

    def shadow_vis(self, g):
        if "nee_vals" not in g:
            return torch.ones_like(g["hlf"])
        nv = g["nee_vals"]
        occ_t = self.occluded_t(g["p_x"], g["p_y"], g["p_z"], nv["wlx"],
                                nv["wly"], nv["wlz"])
        return _f(~(occ_t < nv["dist"] * (1.0 - 1e-3)))

    # -- surrogates: (k, N) over the scope's rows --------------------------
    def softshadow_fwd(self, g):
        nv = g["nee_vals"]
        px_, py_, pz_ = g["p_x"], g["p_y"], g["p_z"]
        wlx, wly, wlz, dist = nv["wlx"], nv["wly"], nv["wlz"], nv["dist"]
        cxs, cys, czs, srs = self.s_geo
        r_abs = torch.abs(srs)
        cxx, cxy, cxz = cxs - px_, cys - py_, czs - pz_
        s_along = cxx * wlx + cxy * wly + cxz * wlz
        s_cl = torch.minimum(torch.clamp_min(s_along, 0.0), dist)
        ex = px_ + s_cl * wlx - cxs
        ey = py_ + s_cl * wly - cys
        ez = pz_ + s_cl * wlz - czs
        dsep = torch.sqrt(torch.clamp_min(ex * ex + ey * ey + ez * ez, 1e-12))
        wsoft = 0.25 * r_abs + 1e-6
        vs = _sigmoid((dsep - r_abs) / wsoft)
        return dict(cxx=cxx, cxy=cxy, cxz=cxz, s_along=s_along, s_cl=s_cl,
                    ex=ex, ey=ey, ez=ez, dsep=dsep, wsoft=wsoft, vs=vs,
                    r_abs=r_abs, v=torch.prod(vs, 0), dist=dist)

    def softshadow_adj(self, ss, cv, g):
        """cv (N,) -> the rows' 4 gradients (k, N) and the shared chain's
        (cpx, cpy, cpz, cwlx, cwly, cwlz, cdist), summed over rows."""
        nv = g["nee_vals"]
        wlx, wly, wlz = nv["wlx"], nv["wly"], nv["wlz"]
        vs, wsoft, dist = ss["vs"], ss["wsoft"], ss["dist"]
        cvs = cv * ss["v"] / torch.clamp_min(vs, 1e-6)
        czs_ = cvs * (vs * (1.0 - vs))
        w2 = wsoft * wsoft
        csr_abs = czs_ * (-(wsoft) - (ss["dsep"] - ss["r_abs"]) * 0.25) / w2
        cdsep = czs_ / wsoft
        inv_dsep = 1.0 / ss["dsep"]
        cex = cdsep * ss["ex"] * inv_dsep
        cey = cdsep * ss["ey"] * inv_dsep
        cez = cdsep * ss["ez"] * inv_dsep
        cs_cl = cex * wlx + cey * wly + cez * wlz
        s_along = ss["s_along"]
        in_rng = (s_along > 0.0) & (s_along < dist)
        cs_along = torch.where(in_rng, cs_cl, 0.0)
        cdist = torch.where(s_along >= dist, cs_cl, 0.0).sum(0)
        grads = (-cex + cs_along * wlx, -cey + cs_along * wly,
                 -cez + cs_along * wlz, csr_abs * torch.sign(self.s_geo[3]))
        chain = ((cex - cs_along * wlx).sum(0), (cey - cs_along * wly).sum(0),
                 (cez - cs_along * wlz).sum(0),
                 (cex * ss["s_cl"] + cs_along * ss["cxx"]).sum(0),
                 (cey * ss["s_cl"] + cs_along * ss["cxy"]).sum(0),
                 (cez * ss["s_cl"] + cs_along * ss["cxz"]).sum(0), cdist)
        return grads, chain

    def quad_cov(self, geo, ax, ay, az, bx_, by_, bz_):
        (qcx, qcy, qcz, qux, quy, quz, qvx, qvy, qvz) = geo
        nx = quy * qvz - quz * qvy
        ny = quz * qvx - qux * qvz
        nz = qux * qvy - quy * qvx
        nn = torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-30)
        inv_nn = 1.0 / nn
        wx, wy, wz = nx * inv_nn, ny * inv_nn, nz * inv_nn
        dp = nx * qcx + ny * qcy + nz * qcz
        den = nx * bx_ + ny * by_ + nz * bz_
        den_ok = torch.abs(den) > 1e-8
        dsafe = torch.where(den_ok, den, 1.0)
        tpar = (dp - (nx * ax + ny * ay + nz * az)) / dsafe
        prx = ax + tpar * bx_ - qcx
        pry = ay + tpar * by_ - qcy
        prz = az + tpar * bz_ - qcz
        al = ((pry * qvz - prz * qvy) * wx + (prz * qvx - prx * qvz) * wy
              + (prx * qvy - pry * qvx) * wz)
        be = ((quy * prz - quz * pry) * wx + (quz * prx - qux * prz) * wy
              + (qux * pry - quy * prx) * wz)
        inv_w = 1.0 / _WQE
        s1 = _sigmoid(al * inv_w)
        s2 = _sigmoid((1.0 - al) * inv_w)
        s3 = _sigmoid(be * inv_w)
        s4 = _sigmoid((1.0 - be) * inv_w)
        return dict(qc=(qcx, qcy, qcz), qu=(qux, quy, quz),
                    qv=(qvx, qvy, qvz), n=(nx, ny, nz), w=(wx, wy, wz),
                    inv_nn=inv_nn, den_ok=den_ok, dsafe=dsafe, tpar=tpar,
                    prx=prx, pry=pry, prz=prz, s1=s1, s2=s2, s3=s3, s4=s4,
                    cov=s1 * s2 * s3 * s4)

    def quad_cov_adj(self, qf, ccov, ax, ay, az, bx_, by_, bz_,
                     need_seg=True):
        """ccov (k, N) -> the rows' 9 gradients (k, N) and, with need_seg,
        the segment's origin and direction cotangents summed over rows."""
        qcx, qcy, qcz = qf["qc"]
        qux, quy, quz = qf["qu"]
        qvx, qvy, qvz = qf["qv"]
        nx, ny, nz = qf["n"]
        wx, wy, wz = qf["w"]
        prx, pry, prz = qf["prx"], qf["pry"], qf["prz"]
        tpar, dsafe = qf["tpar"], qf["dsafe"]
        inv_w = 1.0 / _WQE
        cal = ccov * qf["cov"] * (qf["s2"] - qf["s1"]) * inv_w
        cbe = ccov * qf["cov"] * (qf["s4"] - qf["s3"]) * inv_w
        cprx = cal * (qvy * wz - qvz * wy) + cbe * (wy * quz - wz * quy)
        cpry = cal * (qvz * wx - qvx * wz) + cbe * (wz * qux - wx * quz)
        cprz = cal * (qvx * wy - qvy * wx) + cbe * (wx * quy - wy * qux)
        cqv_x = cal * (wy * prz - wz * pry)
        cqv_y = cal * (wz * prx - wx * prz)
        cqv_z = cal * (wx * pry - wy * prx)
        cqu_x = cbe * (pry * wz - prz * wy)
        cqu_y = cbe * (prz * wx - prx * wz)
        cqu_z = cbe * (prx * wy - pry * wx)
        cwx = cal * (pry * qvz - prz * qvy) + cbe * (quy * prz - quz * pry)
        cwy = cal * (prz * qvx - prx * qvz) + cbe * (quz * prx - qux * prz)
        cwz = cal * (prx * qvy - pry * qvx) + cbe * (qux * pry - quy * prx)
        wdc = wx * cwx + wy * cwy + wz * cwz
        cnx = cwx * qf["inv_nn"] - 2.0 * wx * wdc
        cny = cwy * qf["inv_nn"] - 2.0 * wy * wdc
        cnz = cwz * qf["inv_nn"] - 2.0 * wz * wdc
        ctp = (cprx * bx_ + cpry * by_ + cprz * bz_) * _f(qf["den_ok"])
        cqc_x, cqc_y, cqc_z = -cprx, -cpry, -cprz
        cN = ctp / dsafe
        cD = -ctp * tpar / dsafe
        cnx = cnx + cN * (qcx - ax) + cD * bx_
        cny = cny + cN * (qcy - ay) + cD * by_
        cnz = cnz + cN * (qcz - az) + cD * bz_
        cqc_x = cqc_x + cN * nx
        cqc_y = cqc_y + cN * ny
        cqc_z = cqc_z + cN * nz
        cqu_x = cqu_x + (qvy * cnz - qvz * cny)
        cqu_y = cqu_y + (qvz * cnx - qvx * cnz)
        cqu_z = cqu_z + (qvx * cny - qvy * cnx)
        cqv_x = cqv_x + (cny * quz - cnz * quy)
        cqv_y = cqv_y + (cnz * qux - cnx * quz)
        cqv_z = cqv_z + (cnx * quy - cny * qux)
        grads = (cqc_x, cqc_y, cqc_z, cqu_x, cqu_y, cqu_z, cqv_x, cqv_y,
                 cqv_z)
        if not need_seg:
            return grads, None, None
        ca = ((cprx - cN * nx).sum(0), (cpry - cN * ny).sum(0),
              (cprz - cN * nz).sum(0))
        cb = ((cprx * tpar + cD * nx).sum(0), (cpry * tpar + cD * ny).sum(0),
              (cprz * tpar + cD * nz).sum(0))
        return grads, ca, cb

    def quad_softshadow(self, g):
        """The soft-shadow rows' coverage of the light segment and their
        visibility product."""
        nv = g["nee_vals"]
        qf = self.quad_cov(self.qs_geo, g["p_x"], g["p_y"], g["p_z"],
                           nv["wlx"], nv["wly"], nv["wlz"])
        gate = _f(qf["den_ok"] & (qf["tpar"] > 1e-3)
                  & (qf["tpar"] < nv["dist"] * (1.0 - 1e-3)))
        vq_raw = 1.0 - gate * qf["cov"]
        vq = torch.clamp_min(vq_raw, 1e-3)
        return dict(qf=qf, gate=gate, vq_raw=vq_raw, vq=vq,
                    v=torch.prod(vq, 0))

    def quad_softshadow_adj(self, qs, cv, g):
        nv = g["nee_vals"]
        cvq = cv * qs["v"] / torch.clamp_min(qs["vq"], 1e-6)
        cvq = torch.where(qs["vq_raw"] > 1e-3, cvq, 0.0)
        gq, ca, cb = self.quad_cov_adj(qs["qf"], -qs["gate"] * cvq, g["p_x"],
                                       g["p_y"], g["p_z"], nv["wlx"],
                                       nv["wly"], nv["wlz"])
        return gq, (*ca, *cb)

    def quad_silhouette_adj(self, st, best_t, rowf, cF):
        (ox, oy, oz, dx, dy, dz, _tr, _tg, _tb, alive_f, _pd) = st
        hit = best_t < _MISS
        t_lim = torch.where(hit, best_t, 3.0e30)
        rowi = rowf.to(torch.int32)
        live = alive_f > 0.5
        qf = self.quad_cov(self.q_geo, ox, oy, oz, dx, dy, dz)
        wq_win = (rowi == (self.spec.ns + self.q_rows)[:, None]) & hit
        gate = _f(qf["den_ok"] & (qf["tpar"] > _T_MIN) & (qf["tpar"] < t_lim))
        p = torch.where(wq_win, qf["cov"], 1.0 - gate * qf["cov"])
        p = torch.where(live, p, 1.0)
        cp = cF / torch.clamp_min(p, 1e-3)
        sgn_ev = torch.where(wq_win, 1.0, -gate)
        ccov = torch.where(live, cp * sgn_ev, 0.0)
        return self.quad_cov_adj(qf, ccov, ox, oy, oz, dx, dy, dz,
                                 need_seg=False)[0]

    def silhouette_adj(self, st, best_t, rowf, cF):
        (ox, oy, oz, dx, dy, dz, _tr, _tg, _tb, alive_f, _pd) = st
        hit = best_t < _MISS
        t_lim = torch.where(hit, best_t, 3.0e30)
        rowi = rowf.to(torch.int32)
        live = alive_f > 0.5
        cxs, cys, czs, srs = self.s_geo
        r_abs = torch.abs(srs)
        ws = (rowi == self.s_rows[:, None]) & hit
        cox, coy, coz = cxs - ox, cys - oy, czs - oz
        s_along = cox * dx + coy * dy + coz * dz
        s_hit = torch.clamp_min(s_along, _T_MIN)
        s_blk = torch.minimum(torch.clamp_min(s_along, _T_MIN), t_lim)
        s_eff = torch.where(ws, s_hit, s_blk)
        ex = ox + s_eff * dx - cxs
        ey = oy + s_eff * dy - cys
        ez = oz + s_eff * dz - czs
        dmin = torch.sqrt(torch.clamp_min(ex * ex + ey * ey + ez * ez, 1e-12))
        wsil = 0.05 * r_abs + 1e-5
        cov = _sigmoid((r_abs - dmin) / wsil)
        p = torch.where(ws, cov, 1.0 - cov)
        p = torch.where(live, p, 1.0)
        cp = cF / torch.clamp_min(p, 1e-3)
        sign = torch.where(ws, 1.0, -1.0)
        ccov = torch.where(live, cp * sign, 0.0)
        cz_ = ccov * cov * (1.0 - cov)
        w2 = wsil * wsil
        cr_abs = cz_ * (wsil - (r_abs - dmin) * 0.05) / w2
        cdmin = -cz_ / wsil
        inv_dmin = 1.0 / dmin
        cex = cdmin * ex * inv_dmin
        cey = cdmin * ey * inv_dmin
        cez = cdmin * ez * inv_dmin
        cs_eff = cex * dx + cey * dy + cez * dz
        m_hit = _f(s_along > _T_MIN)
        m_blk = _f((s_along > _T_MIN) & (s_along < t_lim))
        cs_along = torch.where(ws, m_hit, m_blk) * cs_eff
        return (-cex + cs_along * dx, -cey + cs_along * dy,
                -cez + cs_along * dz, cr_abs * torch.sign(srs))

    # -- one bounce backwards -------------------------------------------------
    def bounce_adj(self, samp, b, st, best_t, wf, vis, cin, chat):
        """Recompute the bounce's shading and apply its hand VJPs. Returns
        the cotangent of the state entering the bounce and the bounce's
        per-lane gradient terms."""
        sp, c = self.spec, self.c
        hit = best_t < _MISS
        g = self.shade(samp, b, st, best_t, hit, wf)
        (ox, oy, oz, dx, dy, dz, T1r, T1g, T1b, _alive, _pd) = st
        (cox_in, coy_in, coz_in, cdx_in, cdy_in, cdz_in,
         cTr_in, cTg_in, cTb_in) = cin
        chr_, chg_, chb_ = chat
        scf = g["scf"]
        inv_s = 1.0 - scf
        hlf, mlf, gate_e = g["hlf"], g["mlf"], g["gate_e"]
        nx_, ny_, nz_ = g["nx_"], g["ny_"], g["nz_"]
        war, wag, wab = g["war"], g["wag"], g["wab"]

        # A5 scatter
        cT1r = cTr_in * (inv_s + scf * war)
        cT1g = cTg_in * (inv_s + scf * wag)
        cT1b = cTb_in * (inv_s + scf * wab)
        calb_r = scf * cTr_in * T1r
        calb_g = scf * cTg_in * T1g
        calb_b = scf * cTb_in * T1b
        cpx, cpy, cpz = scf * cox_in, scf * coy_in, scf * coz_in
        cox, coy, coz = inv_s * cox_in, inv_s * coy_in, inv_s * coz_in
        csdx, csdy, csdz = scf * cdx_in, scf * cdy_in, scf * cdz_in
        cdx, cdy, cdz = inv_s * cdx_in, inv_s * cdy_in, inv_s * cdz_in
        sdx, sdy, sdz, invl = g["sdx"], g["sdy"], g["sdz"], g["invl"]
        dot_c = sdx * csdx + sdy * csdy + sdz * csdz
        cdnx = invl * (csdx - sdx * dot_c)
        cdny = invl * (csdy - sdy * dot_c)
        cdnz = invl * (csdz - sdz * dot_c)
        lamf = _f(g["is_lam"])
        cnx, cny, cnz = lamf * cdnx, lamf * cdny, lamf * cdnz
        zal = torch.zeros_like(cdnx)
        creflx = crefly = creflz = cfuzz = cior = zal
        if sp.has_met:
            metf = _f(g["is_met"])
            creflx, crefly, creflz = metf * cdnx, metf * cdny, metf * cdnz
            cfuzz = metf * (g["bx"] * cdnx + g["by"] * cdny + g["bz"] * cdnz)
        if sp.has_die:
            dief = _f(g["is_die"])
            creff = _f(g["cref"])
            creflx = creflx + dief * creff * cdnx
            crefly = crefly + dief * creff * cdny
            creflz = creflz + dief * creff * cdnz
            refr_f = dief * (1.0 - creff)
            cfx, cfy, cfz = refr_f * cdnx, refr_f * cdny, refr_f * cdnz
            cppx, cppy, cppz = cfx, cfy, cfz
            cpar = nx_ * cfx + ny_ * cfy + nz_ * cfz
            cnx = cnx + g["par"] * cfx
            cny = cny + g["par"] * cfy
            cnz = cnz + g["par"] * cfz
            kk, zk = g["kk"], g["zk"]
            live_k = _f(torch.abs(zk) > 1e-12)
            cpl = cpar * 0.5 * torch.sign(zk) * live_k / torch.sqrt(kk)
            cppx = cppx + 2.0 * cpl * g["ppx"]
            cppy = cppy + 2.0 * cpl * g["ppy"]
            cppz = cppz + 2.0 * cpl * g["ppz"]
            eta, cosv = g["eta"], g["cosv"]
            ceta = ((dx + nx_ * cosv) * cppx + (dy + ny_ * cosv) * cppy
                    + (dz + nz_ * cosv) * cppz)
            cdx = cdx + eta * cppx
            cdy = cdy + eta * cppy
            cdz = cdz + eta * cppz
            cnx = cnx + eta * cosv * cppx
            cny = cny + eta * cosv * cppy
            cnz = cnz + eta * cosv * cppz
            ccos = eta * (nx_ * cppx + ny_ * cppy + nz_ * cppz)
            cnd = -ccos * _f(g["cos_clip"])
            cnx, cny, cnz = cnx + cnd * dx, cny + cnd * dy, cnz + cnd * dz
            cdx, cdy, cdz = cdx + cnd * nx_, cdy + cnd * ny_, cdz + cnd * nz_
            frontf = _f(g["front"])
            iors = torch.clamp_min(g["wior"], 1e-6)
            cior = ceta * (frontf * (-1.0 / (iors * iors)) + (1.0 - frontf))
        if sp.has_met or sp.has_die:
            sdn = g["sdn"]
            ndotcr = nx_ * creflx + ny_ * crefly + nz_ * creflz
            cdx = cdx + creflx - 2.0 * ndotcr * nx_
            cdy = cdy + crefly - 2.0 * ndotcr * ny_
            cdz = cdz + creflz - 2.0 * ndotcr * nz_
            cnx = cnx - 2.0 * sdn * creflx - 2.0 * ndotcr * dx
            cny = cny - 2.0 * sdn * crefly - 2.0 * ndotcr * dy
            cnz = cnz - 2.0 * sdn * creflz - 2.0 * ndotcr * dz

        # A4 NEE; the surrogate terms are (k, N) over the scope's rows
        n_s, n_q = len(sp.surr_s), len(sp.surr_q)
        sph_surr = quad_soft = quad_sil = None
        gl = None
        if "nee_vals" in g:
            nv = g["nee_vals"]
            s_base = nv["activef"] * vis * (1.0 / np.pi)
            geomf = nv["geom"]
            ler, leg, leb = nv["ler"], nv["leg"], nv["leb"]
            cT1r = cT1r + s_base * geomf * war * ler * chr_
            cT1g = cT1g + s_base * geomf * wag * leg * chg_
            cT1b = cT1b + s_base * geomf * wab * leb * chb_
            calb_r = calb_r + s_base * geomf * T1r * ler * chr_
            calb_g = calb_g + s_base * geomf * T1g * leg * chg_
            calb_b = calb_b + s_base * geomf * T1b * leb * chb_
            cler = s_base * geomf * T1r * war * chr_
            cleg = s_base * geomf * T1g * wag * chg_
            cleb = s_base * geomf * T1b * wab * chb_
            ghat = s_base * (chr_ * T1r * war * ler + chg_ * T1g * wag * leg
                             + chb_ * T1b * wab * leb)
            cvr = ghat * geomf
            cgraw = ghat * _f(nv["graw"] < 16.0 * np.pi)
            cwlx = cwly = cwlz = cdist = zal
            if n_s or n_q:
                one = torch.ones_like(hlf)
                ss = self.softshadow_fwd(g) if n_s else None
                qs = self.quad_softshadow(g) if len(self.qs_rows) else None
                v_s = one if ss is None else ss["v"]
                v_q = one if qs is None else qs["v"]
                cv_t = cvr / torch.clamp_min(v_s * v_q, 1e-3)
                if ss is not None:
                    sph_surr, (cpx_s, cpy_s, cpz_s, cwlx, cwly, cwlz,
                               cdist) = self.softshadow_adj(ss, cv_t * v_q, g)
                    cpx, cpy, cpz = cpx + cpx_s, cpy + cpy_s, cpz + cpz_s
                if qs is not None:
                    quad_soft, (cpx_q, cpy_q, cpz_q, cwlx_q, cwly_q,
                                cwlz_q) = self.quad_softshadow_adj(
                                    qs, cv_t * v_s, g)
                    cpx, cpy, cpz = cpx + cpx_q, cpy + cpy_q, cpz + cpz_q
                    cwlx = cwlx + cwlx_q
                    cwly = cwly + cwly_q
                    cwlz = cwlz + cwlz_q
            r2g, area = nv["r2g"], nv["area"]
            nlf = float(sp.n_lights)
            f_cx = cgraw * nv["cosy"] * area * nlf / r2g
            f_cy = cgraw * nv["cosx"] * area * nlf / r2g
            carea = cgraw * nv["cosx"] * nv["cosy"] * nlf / r2g
            live_r2 = _f(nv["r2l"] > 1e-12)
            cr2 = -cgraw * nv["graw"] / r2g * live_r2
            cnx = cnx + f_cx * nv["wlx"]
            cny = cny + f_cx * nv["wly"]
            cnz = cnz + f_cx * nv["wlz"]
            cwlx = cwlx + f_cx * nx_
            cwly = cwly + f_cx * ny_
            cwlz = cwlz + f_cx * nz_
            ccy = f_cy * torch.sign(nv["cy_raw"])
            clnux, clnuy, clnuz = ccy * nv["wlx"], ccy * nv["wly"], \
                ccy * nv["wlz"]
            cwlx = cwlx + ccy * nv["lnux"]
            cwly = cwly + ccy * nv["lnuy"]
            cwlz = cwlz + ccy * nv["lnuz"]
            ainv = nv["ainv"]
            clnx, clny, clnz = clnux * ainv, clnuy * ainv, clnuz * ainv
            cainv = nv["lnx"] * clnux + nv["lny"] * clnuy + nv["lnz"] * clnuz
            carea = carea - ainv * ainv * cainv
            clnx = clnx + carea * nv["lnux"]
            clny = clny + carea * nv["lnuy"]
            clnz = clnz + carea * nv["lnuz"]
            clux, cluy, cluz = _cross3(nv["lvx"], nv["lvy"], nv["lvz"],
                                       clnx, clny, clnz)
            clvx, clvy, clvz = _cross3(clnx, clny, clnz, nv["lux"],
                                       nv["luy"], nv["luz"])
            idist = nv["idist"]
            ctlx, ctly, ctlz = cwlx * idist, cwly * idist, cwlz * idist
            cidist = nv["tlx"] * cwlx + nv["tly"] * cwly + nv["tlz"] * cwlz
            cdist = cdist - idist * idist * cidist
            cr2 = cr2 + cdist * 0.5 * idist * live_r2
            ctlx = ctlx + 2.0 * cr2 * nv["tlx"]
            ctly = ctly + 2.0 * cr2 * nv["tly"]
            ctlz = ctlz + 2.0 * cr2 * nv["tlz"]
            cpx, cpy, cpz = cpx - ctlx, cpy - ctly, cpz - ctlz
            clux = clux + nv["nu1"] * ctlx
            cluy = cluy + nv["nu1"] * ctly
            cluz = cluz + nv["nu1"] * ctlz
            clvx = clvx + nv["nu2"] * ctlx
            clvy = clvy + nv["nu2"] * ctly
            clvz = clvz + nv["nu2"] * ctlz
            gl = (nv["kpick"], [ctlx, ctly, ctlz, clux, cluy, cluz, clvx,
                                clvy, clvz, cler, cleg, cleb])

        # A3 emission + A2 background
        cT1r = cT1r + gate_e * chr_ * g["wer"] + mlf * chr_ * c[20]
        cT1g = cT1g + gate_e * chg_ * g["weg"] + mlf * chg_ * c[21]
        cT1b = cT1b + gate_e * chb_ * g["web"] + mlf * chb_ * c[22]
        cemit = (gate_e * chr_ * T1r, gate_e * chg_ * T1g,
                 gate_e * chb_ * T1b)
        cbg = (mlf * T1r * chr_, mlf * T1g * chg_, mlf * T1b * chb_)

        # A1 silhouette
        rowf = wf["rowf"]
        if sp.sil and (n_s or n_q):
            cF = cT1r * T1r + cT1g * T1g + cT1b * T1b
            if n_s:
                sil = self.silhouette_adj(st, best_t, rowf, cF)
                sph_surr = sil if sph_surr is None else tuple(
                    a + b_ for a, b_ in zip(sil, sph_surr))
            if n_q:
                quad_sil = self.quad_silhouette_adj(st, best_t, rowf, cF)

        # A0 normal -> point -> t -> geometry
        sgn = g["sgn"]
        cnox, cnoy, cnoz = sgn * cnx, sgn * cny, sgn * cnz
        quadf = g["isq"]
        sphf = 1.0 - quadf
        rho = g["rho"]
        sd_n = g["sx_o"] * cnox + g["sy_o"] * cnoy + g["sz_o"] * cnoz
        cmx = sphf * (cnox - g["sx_o"] * sd_n) / rho
        cmy = sphf * (cnoy - g["sy_o"] * sd_n) / rho
        cmz = sphf * (cnoz - g["sz_o"] * sd_n) / rho
        cpx, cpy, cpz = cpx + cmx, cpy + cmy, cpz + cmz
        c_cx, c_cy, c_cz = -cmx, -cmy, -cmz
        qd_n = g["qx_o"] * cnox + g["qy_o"] * cnoy + g["qz_o"] * cnoz
        cwnx = quadf * (cnox - g["qx_o"] * qd_n) / g["qlen"]
        cwny = quadf * (cnoy - g["qy_o"] * qd_n) / g["qlen"]
        cwnz = quadf * (cnoz - g["qz_o"] * qd_n) / g["qlen"]
        ct = (cpx * dx + cpy * dy + cpz * dz) * hlf
        cox, coy, coz = cox + cpx, coy + cpy, coz + cpz
        t = g["t"]
        cdx, cdy, cdz = cdx + t * cpx, cdy + t * cpy, cdz + t * cpz
        sphtf = sphf * hlf
        sq_safe = g["sq_safe"]
        root_sgn = 2.0 * _f(g["use0"]) - 1.0
        chb = ct * sphtf * (-1.0 - root_sgn * g["hb"] / sq_safe)
        cct = ct * sphtf * (root_sgn * 0.5 / sq_safe)
        ocx, ocy, ocz = g["ocx"], g["ocy"], g["ocz"]
        cocx = chb * dx + 2.0 * cct * ocx
        cocy = chb * dy + 2.0 * cct * ocy
        cocz = chb * dz + 2.0 * cct * ocz
        crad = cct * (-2.0 * g["wrad"])
        cdx, cdy, cdz = cdx + chb * ocx, cdy + chb * ocy, cdz + chb * ocz
        cox, coy, coz = cox + cocx, coy + cocy, coz + cocz
        c_cx, c_cy, c_cz = c_cx - cocx, c_cy - cocy, c_cz - cocz
        qtf = quadf * hlf
        cnum = ct * qtf / g["dden"]
        cden = -ct * qtf * g["t_quad"] / g["dden"]
        cwnx = cwnx + cnum * (g["wqcx"] - ox) + cden * dx
        cwny = cwny + cnum * (g["wqcy"] - oy) + cden * dy
        cwnz = cwnz + cnum * (g["wqcz"] - oz) + cden * dz
        wnx, wny, wnz = g["wnx"], g["wny"], g["wnz"]
        cqc = (cnum * wnx, cnum * wny, cnum * wnz)
        cox, coy, coz = cox - cnum * wnx, coy - cnum * wny, coz - cnum * wnz
        cdx, cdy, cdz = cdx + cden * wnx, cdy + cden * wny, cdz + cden * wnz
        cqu = _cross3(g["wqvx"], g["wqvy"], g["wqvz"], cwnx, cwny, cwnz)
        cqv = _cross3(cwnx, cwny, cwnz, g["wqux"], g["wquy"], g["wquz"])
        terms = dict(
            rowf=rowf, wmat=g["wmat"], sph=(c_cx, c_cy, c_cz, crad),
            quad=cqc + cqu + cqv, mat=(calb_r, calb_g, calb_b, cfuzz, cior,
                                      *cemit),
            light=gl, bg=cbg, sph_surr=sph_surr, quad_soft=quad_soft,
            quad_sil=quad_sil)
        cout = (cox, coy, coz, cdx, cdy, cdz, cT1r, cT1g, cT1b)
        return cout, terms


def _onehot(idx, n):
    return (torch.arange(n, device=idx.device)[:, None]
            == idx.to(torch.int64)[None]).to(torch.float32)


def _lane_dot(onehot, cols):
    # the TPU kernel's one-hot product over lanes, in full f32
    from tinyraytracer_tpu_torch.ops.intersect import _matmul_full_f32
    return _matmul_full_f32(onehot, torch.stack(cols, 1))


def packed_diff_reference(tab: torch.Tensor, cam: torch.Tensor,
                          target: torch.Tensor, *, spec: PackedSpec,
                          width: int, height: int, spp: int,
                          max_bounces: int, seed: int = 0,
                          spp_offset: int = 0, replay_dead: bool = True,
                          pixel_chunk: int = 0, pixels: tuple | None = None):
    """Plain PyTorch twin of K5 and of K4, on the device of `tab`; the
    same arguments and outputs as `packed_diff` (any surrogate scope, as
    K4 takes; a pixel range with `pixels`). The reverse sweep replays all
    `max_bounces` bounces of every sample, as the TPU kernels do;
    `replay_dead=False` drops, as the CUDA kernels do, the bounces after a
    path ended (their terms are exact zeros, which the tests hold). Pixels go in chunks of `pixel_chunk` (0:
    as many as keep a (rows, pixels) matrix within CANDIDATE_BUDGET
    elements); a chunk changes no pixel's bits, only the order in which
    the loss and the tables sum over pixels."""
    begin, npix = _check(tab, cam, target, spec, width, height, spp,
                         max_bounces, pixels)
    dev = tab.device
    tw = _Twin(tab, cam, spec, seed)
    step = pixel_chunk or max(1, CANDIDATE_BUDGET // max(
        spec.ns + spec.nq, spec.nm))
    tgt = target.reshape(npix, 3)
    npixf = cam[23]
    inv_spp = float(np.float32(1.0 / spp))
    cscale = 2.0 / (npixf * 3.0 * float(spp))
    image = torch.empty((npix, 3), dtype=torch.float32, device=dev)
    dsph = torch.zeros((spec.ns, 8), dtype=torch.float32, device=dev)
    dquad = torch.zeros((spec.nq, 16), dtype=torch.float32, device=dev)
    dmat = torch.zeros((spec.nm, 8), dtype=torch.float32, device=dev)
    dlight = torch.zeros((spec.nl, 16), dtype=torch.float32, device=dev)
    bg_sum = torch.zeros(3, dtype=torch.float32, device=dev)
    lsum = torch.zeros((), dtype=torch.float32, device=dev)

    def rows_sum(cols):
        return torch.stack([a.sum(1) for a in cols], 1)

    for p0 in range(0, npix, step):
        pid = torch.arange(begin + p0, begin + min(p0 + step, npix),
                           dtype=torch.int64, device=dev)
        tw.set_pixels(pid, width)
        one = torch.ones(pid.shape[0], dtype=torch.float32, device=dev)
        zero = torch.zeros_like(one)

        def start(samp):
            return (*tw.camera_ray(samp), one, one, one, one, zero)

        # phase 1: the forward NEE image
        acc = [zero, zero, zero]
        for s in range(spp):
            samp = (spp_offset + s) & _MASK
            st = start(samp)
            col = [zero, zero, zero]
            for b in range(max_bounces):
                best, hit, wf = tw.closest_hit(*st[:6])
                g = tw.shade(samp, b, st, best, hit, wf)
                dc = tw.color_adds(g, st, tw.shadow_vis(g))
                live = st[9] > 0.5
                col = [torch.where(live, c + d, c) for c, d in zip(col, dc)]
                st = tuple(torch.where(live, a2, a)
                           for a2, a in zip(tw.advance(g, st), st))
                if not bool((st[9] > 0.5).any()):
                    break
            acc = [a + c for a, c in zip(acc, col)]
        img = [a * inv_spp for a in acc]
        image[p0:p0 + pid.shape[0]] = torch.stack(img, -1)

        # phase 2: the loss cotangent and the MSE
        tgt_c = tgt[p0:p0 + pid.shape[0]].unbind(1)
        diffs = [i - t for i, t in zip(img, tgt_c)]
        chat = tuple(cscale * d for d in diffs)
        lsum = lsum + torch.sum(diffs[0] * diffs[0] + diffs[1] * diffs[1]
                                + diffs[2] * diffs[2])

        # phase 3: replay + adjoint
        bg_acc = [zero, zero, zero]
        for s in range(spp):
            samp = (spp_offset + s) & _MASK
            st = start(samp)
            saves = []
            for b in range(max_bounces):
                best, hit, wf = tw.closest_hit(*st[:6])
                g = tw.shade(samp, b, st, best, hit, wf)
                saves.append((st, best, wf, tw.shadow_vis(g)))
                st = tw.advance(g, st)
            co = (zero,) * 9
            for b in reversed(range(max_bounces)):
                st_b, best, wf, vis = saves[b]
                co, tm = tw.bounce_adj(samp, b, st_b, best, wf, vis, co,
                                       chat)
                if not replay_dead:
                    live = st_b[9] > 0.5
                    keep = lambda x: torch.where(live, x, 0.0)  # noqa: E731
                    co = tuple(keep(x) for x in co)
                    tm = _map_terms(tm, keep)
                dsph[:, :4] += _lane_dot(_onehot(tm["rowf"], spec.ns),
                                         list(tm["sph"]))
                if tm["sph_surr"] is not None:
                    dsph[:, :4].index_add_(0, tw.s_rows,
                                           rows_sum(tm["sph_surr"]))
                dquad[:, :9] += _lane_dot(_onehot(tm["rowf"] - spec.ns,
                                                  spec.nq), list(tm["quad"]))
                if tm["quad_soft"] is not None:
                    dquad[:, :9].index_add_(0, tw.qs_rows,
                                            rows_sum(tm["quad_soft"]))
                if tm["quad_sil"] is not None:
                    dquad[:, :9].index_add_(0, tw.q_rows,
                                            rows_sum(tm["quad_sil"]))
                dmat += _lane_dot(_onehot(tm["wmat"], spec.nm),
                                  list(tm["mat"]))
                if tm["light"] is not None:
                    kpick, cols = tm["light"]
                    dlight[:, :12] += _lane_dot(_onehot(kpick, spec.nl), cols)
                bg_acc = [a + x for a, x in zip(bg_acc, tm["bg"])]
        bg_sum = bg_sum + torch.stack([torch.sum(a) for a in bg_acc])
    dmisc = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    dmisc[0, 0:3] = bg_sum
    dmisc[0, 3] = lsum / (npixf * 3.0)
    return image.view(target.shape), dsph, dquad, dmat, dlight, dmisc


def _map_terms(tm, fn):
    out = dict(tm)
    for k in ("sph", "quad", "mat", "bg"):
        out[k] = tuple(fn(x) for x in tm[k])
    for k in ("sph_surr", "quad_soft", "quad_sil"):
        if tm[k] is not None:
            out[k] = tuple(fn(x) for x in tm[k])
    if tm["light"] is not None:
        out["light"] = (tm["light"][0], [fn(x) for x in tm["light"][1]])
    return out


# --- scene level --------------------------------------------------------------

def _inputs(scene, camera, target, background, static, nee, silhouette,
            surr_sph, surr_quad):
    st = static if static is not None else build_diff_static(scene)
    dev = scene.sph_center.device
    tab, _prims, light_off = packed_flat_table(scene, st)
    spec = packed_spec(st, light_off, nee=nee, sil=silhouette,
                       surr_sph=surr_sph, surr_quad=surr_quad)
    cam = scene_table.camera_vector(camera, background)[0]
    cam[23] = float(camera.width * camera.height)
    cam = torch.from_numpy(cam).to(dev)
    tgt = torch.as_tensor(target, dtype=torch.float32).to(dev).reshape(
        camera.height, camera.width, 3).contiguous()
    return st, tab.view(-1), cam, tgt, spec


def _value_and_grad(fn, scene, camera, target, *, spp, max_bounces,
                    background, seed, spp_offset, nee, silhouette, static,
                    mesh, surr_sph, surr_quad):
    """(loss, image, grads) through the launcher `fn` (a kernel's wrapper
    or the twin), over `mesh` (parallel/sharded.Mesh; None: the one-cell
    mesh on the scene's device, one launch over the whole image). The
    pixels split over every cell of the mesh, both axes, with no sample
    split (diffkernel_packed.py:1926-1950): each cell runs `fn` on its
    range on its device, the images join in mesh order and the five
    tables (the loss with them, in dmisc) sum in mesh order."""
    from tinyraytracer_tpu_torch.parallel import sharded

    with profiling.annotate("tinyrt.train.table"):
        st, tab, cam, tgt, spec = _inputs(scene, camera, target, background,
                                          static, nee, silhouette, surr_sph,
                                          surr_quad)
    if mesh is None:
        mesh = sharded.one_cell(tab.device)
    w, h = camera.width, camera.height
    kw = dict(spec=spec, width=w, height=h, spp=spp,
              max_bounces=max_bounces, seed=int(seed),
              spp_offset=int(spp_offset))
    ranges = sharded.split_pixels(w * h, mesh.size)
    rows = tgt.view(-1, 3)
    imgs, parts = [], []
    for c in mesh.cells:
        b, n = ranges[c.index]
        img, *tables = fn(tab.to(c.device), cam.to(c.device),
                          rows[b:b + n].to(c.device), pixels=(b, n), **kw)
        imgs.append(img)
        parts.append(tables)
    with profiling.annotate("tinyrt.train.grads"):
        flats = [torch.cat([t.reshape(-1) for t in ts]) for ts in parts]
        img = mesh.concat(imgs, ranges).view(h, w, 3)
        flat = mesh.sum(flats).to(tab.device)
        tables = [part.view(t.shape) for part, t in zip(
            torch.split(flat, [t.numel() for t in tables]), tables)]
        grads = _grads_to_scene(scene, st, *tables)
    return tables[4][0, 3], img, grads


def render_value_and_grad_packed(scene, camera, target, *, spp: int,
                                 max_bounces: int, background, seed: int = 0,
                                 spp_offset=0, nee: bool = True,
                                 silhouette: bool = True,
                                 static: DiffStatic | None = None,
                                 tile=None, mesh=None, surr_sph: bool = True,
                                 surr_quad: bool = True):
    """(loss, image (H, W, 3), grads) of the fused objective through K5 on
    the scene's device (the twin on the CPU), or with `mesh` sharded over
    its cells (`_value_and_grad`). `surr_sph`/`surr_quad` False drop that
    class's soft-shadow and silhouette surrogates (its soft visibility
    counts as 1); K5 takes whole classes only. `tile` is accepted and
    ignored."""
    del tile
    return _value_and_grad(
        packed_diff, scene, camera, target, spp=spp,
        max_bounces=max_bounces, background=background, seed=seed,
        spp_offset=spp_offset, nee=nee, silhouette=silhouette,
        static=static, mesh=mesh, surr_sph=surr_sph, surr_quad=surr_quad)


def render_value_and_grad_packed_reference(scene, camera, target, *,
                                           spp: int, max_bounces: int,
                                           background, seed: int = 0,
                                           spp_offset=0, nee: bool = True,
                                           silhouette: bool = True,
                                           static: DiffStatic | None = None,
                                           surr_sph: bool = True,
                                           surr_quad: bool = True,
                                           mesh=None):
    """`render_value_and_grad_packed` through the twin, on any device."""
    return _value_and_grad(
        packed_diff_reference, scene, camera, target, spp=spp,
        max_bounces=max_bounces, background=background, seed=seed,
        spp_offset=spp_offset, nee=nee, silhouette=silhouette,
        static=static, mesh=mesh, surr_sph=surr_sph, surr_quad=surr_quad)
