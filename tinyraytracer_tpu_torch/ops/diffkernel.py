"""Fused differentiable render: the training objective and its gradients
in one kernel launch (port of ops/diffkernel.py: the routing and the
classic-layout kernel K4).

    L = mean((render_nee(scene) - target)^2)

is evaluated and differentiated w.r.t. every scene parameter by one
kernel: an NEE forward image, the per-pixel MSE cotangent, and a
hand-derived reverse sweep over each sample's bounces. The estimator is
that of ops/trace.trace(nee=True, silhouette=True): the same pcg4d
streams, emission-skip rule, quad-light NEE with the soft-shadow
surrogate, silhouette surrogates and material scatter chains.

The JAX package has two such kernels, and so has the port. Scenes of at
most DIFF_PACKED_MAX_PRIMS real primitives and DIFF_PACKED_MAX_SPHERES
real spheres, with a constant background and a class-level surrogate
scope, go to the packed kernel K5 (ops/diffkernel_packed.py,
csrc/diffkernel_packed.cu); every other case goes to the classic-layout
kernel K4 (`classic_diff`, csrc/diffkernel.cu): explicit surrogate row
subsets, larger scenes, and (unlike the JAX package, whose K5 has no such
limit) scenes whose gradient tables overflow the CUDA K5's per-thread
accumulator. `routes_packed` is the one rule. Both CUDA kernels run one
estimator (csrc/diff_common.cuh) on one flat table
(diffkernel_packed.packed_flat_table), and `packed_diff_reference` is the
plain twin of both.

Gradient targets: sph_center, sph_radius, quad_corner, quad_u, quad_v,
mat_albedo, mat_fuzz, mat_ior, mat_emit, background.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.models import materials as mat
from tinyraytracer_tpu_torch.models.world import require_no_media
from tinyraytracer_tpu_torch.ops import diff_schedule
from tinyraytracer_tpu_torch.ops.scene_table import host_background
from tinyraytracer_tpu_torch.utils import profiling

_T_MIN = 1.0e-3
_MISS = 3.0e38
_TWO_PI = 6.283185307179586

# Routing limits of the packed kernel (diffkernel_packed.py:88-100 in the
# JAX package): above them the JAX package takes the classic kernel K4.
DIFF_PACKED_MAX_PRIMS = 48
DIFF_PACKED_MAX_SPHERES = 16
# Floats of the CUDA K5's per-thread gradient accumulator
# (csrc/diffkernel_packed.cu, kMaxAcc). A scene needing more (a large
# material palette, many light quads) is routed as the classic kernel's.
DIFF_PACKED_MAX_ACC = 1024

# Floats of K4's per-thread gradient columns ([na][threads]) that the
# launch may allocate: the grid shrinks below one wave to stay within it.
DIFF_CLASSIC_MAX_COLS = 1 << 30
_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DiffStatic:
    """Host structure of a scene for the fused kernel: row selections,
    material ids and light membership, never differentiated."""

    ns: int                 # padded compacted sphere rows
    nq: int                 # padded compacted quad rows
    nm: int                 # padded material rows
    nl: int                 # padded light rows
    n_lights: int           # real light count
    sph_rows: tuple         # global sphere rows (real)
    quad_rows: tuple        # global quad rows (real)
    light_quad_rows: tuple  # global quad rows of the lights
    light_mat_rows: tuple   # material rows of the lights
    mat_ids: tuple          # compacted prim -> global material row
    mat_kinds: tuple        # material kind codes (static ints)


def build_diff_static(scene) -> DiffStatic:
    require_no_media(scene, "the fused train step (K5, K4)")
    a = scene.numpy()
    s_rows = np.nonzero(a["sph_valid"])[0]
    q_rows = np.nonzero(a["quad_valid"])[0]
    kinds = a["mat_kind"]
    sph_mat, quad_mat = a["sph_mat"], a["quad_mat"]
    ns = max(8, ((len(s_rows) + 7) // 8) * 8)
    nq = max(8, ((len(q_rows) + 7) // 8) * 8)
    mids = np.zeros((ns + nq,), np.int64)
    mids[: len(s_rows)] = sph_mat[s_rows]
    mids[ns:ns + len(q_rows)] = quad_mat[q_rows]
    is_light = kinds[quad_mat[q_rows]] == mat.LIGHT
    lq_rows = q_rows[is_light]
    nl = max(8, ((len(lq_rows) + 7) // 8) * 8)
    nm = max(8, ((kinds.shape[0] + 7) // 8) * 8)
    return DiffStatic(
        ns=ns, nq=nq, nm=nm, nl=nl, n_lights=len(lq_rows),
        sph_rows=tuple(int(i) for i in s_rows),
        quad_rows=tuple(int(i) for i in q_rows),
        light_quad_rows=tuple(int(i) for i in lq_rows),
        light_mat_rows=tuple(int(i) for i in quad_mat[lq_rows]),
        mat_ids=tuple(int(i) for i in mids),
        mat_kinds=tuple(int(k) for k in kinds),
    )


def static_kind_flags(st: DiffStatic):
    """(has_met, has_die): does any real primitive use a Metal /
    Dielectric material? The kernel then drops the absent scatter chains
    and their adjoints, which is value-preserving."""
    used = set()
    for i in range(len(st.sph_rows)):
        used.add(st.mat_kinds[st.mat_ids[i]])
    for j in range(len(st.quad_rows)):
        used.add(st.mat_kinds[st.mat_ids[st.ns + j]])
    return (mat.METAL in used), (mat.DIELECTRIC in used)


def packed_acc_width(n_sph: int, n_quad: int, nm: int, n_lights: int) -> int:
    """Floats of K5's gradient accumulator: sphere 4, quad 9, material 8
    and light 12 columns per row, background 3, loss 1."""
    return 4 * n_sph + 9 * n_quad + 8 * nm + 12 * n_lights + 4


def routes_packed(st: DiffStatic, background) -> bool:
    """Whether render_value_and_grad (with a class-level surrogate scope)
    sends this scene to K5: a constant background, at most
    DIFF_PACKED_MAX_PRIMS real primitives and DIFF_PACKED_MAX_SPHERES real
    spheres, and gradients within DIFF_PACKED_MAX_ACC accumulators."""
    n_sph, n_quad = len(st.sph_rows), len(st.quad_rows)
    return (host_background(background).ndim == 1
            and n_sph + n_quad <= DIFF_PACKED_MAX_PRIMS
            and n_sph <= DIFF_PACKED_MAX_SPHERES
            and packed_acc_width(n_sph, n_quad, st.nm, st.n_lights)
            <= DIFF_PACKED_MAX_ACC)


def _surrogate_rows(st: DiffStatic, surr_rows):
    """The per-class surrogate scopes of `surr_rows` as packed_spec takes
    them (True = the class, False = off, a tuple = table rows), and
    whether every class is whole or off (a class-level scope)."""
    if surr_rows is None:
        return True, True, True
    sv = surr_rows.get("sph", ())
    qv = surr_rows.get("quad", ())
    smap = {r: i for i, r in enumerate(st.sph_rows)}
    qmap = {r: j for j, r in enumerate(st.quad_rows)}
    try:
        surr_s = True if sv is None else tuple(sorted(
            smap[int(r)] for r in sv))
        surr_q = True if qv is None else tuple(sorted(
            qmap[int(r)] for r in qv))
    except KeyError as e:
        raise ValueError(
            f"surr_rows names row {e} which is not a valid "
            "sphere/quad row of this scene") from None
    class_level = (surr_s is True or not surr_s) and (
        surr_q is True or not surr_q)
    return surr_s or False, surr_q or False, class_level


def render_value_and_grad(scene, camera, target, *, spp: int,
                          max_bounces: int, background, seed: int = 0,
                          spp_offset=0, nee: bool = True,
                          silhouette: bool = True,
                          static: DiffStatic | None = None,
                          packed: bool | None = None, mesh=None,
                          tile: tuple | None = None,
                          surr_rows: dict | None = None):
    """Fused train objective on the scene's device: (loss, image, grads).

    grads is a dict over diff.params.FLOAT_FIELDS plus "background",
    shaped like the scene's fields. `surr_rows` ({"sph": rows, "quad":
    rows}) scopes the boundary surrogates per class: None = the whole
    class, () or missing = the class dropped, a row tuple = an explicit
    subset (K4 only; the soft-shadow visibility product then runs over the
    listed rows only). `packed` None routes by `routes_packed`; an explicit
    subset always takes K4. `tile` is accepted and ignored (the CUDA
    kernels size their grids from the card, ops/diff_schedule.py).
    `mesh` (parallel/sharded.Mesh) splits the pixels over every cell of
    the mesh and sums the gradient tables in mesh order (data-parallel
    training, diffkernel_packed.py:1810-1820); the image and grads land
    on the scene's device, the same bits on every rank of a process
    group.
    """
    if host_background(background).ndim != 1:
        raise ValueError(
            "the fused diff kernels support constant backgrounds only; "
            "gradient-sky ((2,3) [bottom, top]) scenes train through the "
            "modular path (make_train_step / render_loss), which "
            "differentiates the sky-lerped miss term via autodiff")
    st = static if static is not None else build_diff_static(scene)
    surr_s, surr_q, class_level = _surrogate_rows(st, surr_rows)
    if not class_level:
        packed = False
    elif packed is None:
        packed = routes_packed(st, background)
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    if packed:
        return dkp.render_value_and_grad_packed(
            scene, camera, target, spp=spp, max_bounces=max_bounces,
            background=background, seed=seed, spp_offset=spp_offset,
            nee=nee, silhouette=silhouette, static=st, tile=tile,
            mesh=mesh, surr_sph=bool(surr_s), surr_quad=bool(surr_q))
    return dkp._value_and_grad(
        classic_diff, scene, camera, target, spp=spp,
        max_bounces=max_bounces, background=background, seed=seed,
        spp_offset=spp_offset, nee=nee, silhouette=silhouette, static=st,
        mesh=mesh, surr_sph=surr_s, surr_quad=surr_q)


def classic_diff(tab: torch.Tensor, cam: torch.Tensor, target: torch.Tensor,
                 *, spec, width: int, height: int, spp: int,
                 max_bounces: int, seed: int = 0, spp_offset: int = 0,
                 pixels: tuple | None = None):
    """K4 on the device of `tab`: (image (H, W, 3), dsph (ns, 8), dquad
    (nq, 16), dmat (nm, 8), dlight (nl, 16), dmisc (8, 128)), all f32, as
    diffkernel_packed.packed_diff returns them, for any surrogate scope
    (`spec`, a diffkernel_packed.PackedSpec) and table width; with
    `pixels` (begin, count), over that range, as packed_diff.

    On a CPU tensor it runs the plain twin
    diffkernel_packed.packed_diff_reference; on a CUDA tensor it launches
    csrc/diffkernel.cu, built at first use, and raises if the launch
    fails. Each launch adds one to the host counter `launches.classic_diff`
    (utils/profiling.py); while a profiler records, the launcher times its
    stages as `k4.<stage>` (diffkernel_packed.STAGES)."""
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    begin, npix = dkp._check(tab, cam, target, spec, width, height, spp,
                             max_bounces, pixels)
    kw = dict(spec=spec, width=width, height=height, spp=spp,
              max_bounces=max_bounces, seed=seed, spp_offset=spp_offset,
              pixels=pixels)
    if tab.device.type == "cpu":
        with profiling.annotate("tinyrt.train.launch"):
            return dkp.packed_diff_reference(tab, cam, target, **kw)
    if tab.device.type != "cuda":
        raise ValueError(f"no diff kernel for device {tab.device}")
    with profiling.annotate("tinyrt.train.launch"):
        img, acc = _launch_classic(tab, cam, target, spec, width, height,
                                   spp, max_bounces, seed, spp_offset,
                                   begin, npix)
    profiling.count("launches.classic_diff")
    with profiling.annotate("tinyrt.train.grads"):
        return (img, *dkp.tables_from_acc(acc, spec))


def _launch_classic(tab, cam, target, spec, width, height, spp,
                    max_bounces, seed, spp_offset, begin, npix):
    """classic_diff's launch on the card: (image, summed accumulator)."""
    from tinyraytracer_tpu_torch.ops import diffkernel_packed as dkp

    lib = _build.load()
    dev = tab.device
    na = spec.acc_width
    flags = diff_schedule.variant_flags(spec)
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        per_sm, sms = dkp._occupancy(lib, "classic", flags, 0, 0, False,
                                     False, torch.cuda.current_device())
        plan = diff_schedule.plan(npix, per_sm, sms, max_bounces,
                                  cols_per_thread=na,
                                  max_cols=DIFF_CLASSIC_MAX_COLS)
        split = dkp.image_plan(lib, "classic", flags, 0, npix, spp)
        img = torch.empty(target.shape, **f32)
        samples = torch.empty((spp * npix * 3 if split > 1 else 0,), **f32)
        saves = torch.empty((plan.saves_floats,), **f32)
        cols = torch.empty((na, plan.threads), **f32)
        wpart = torch.empty((plan.blocks * (diff_schedule.BLOCK // 32), na),
                            **f32)
        acc = torch.empty((na,), **f32)
        srows, qrows = _scope_tensors(spec.surr_s, spec.surr_q, str(dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        _handles, events = dkp.stage_handles("k4", dev)
        err = lib.tinyrt_diff_classic(
            cam.data_ptr(), tab.data_ptr(), spec.n_sph, spec.n_quad,
            spec.n_lights, spec.nm, spec.light_quad, srows.data_ptr(),
            srows.numel(), qrows.data_ptr(), qrows.numel(),
            target.data_ptr(), img.data_ptr(), saves.data_ptr(),
            cols.data_ptr(), wpart.data_ptr(), acc.data_ptr(), plan.blocks,
            plan.slots, width, height, seed & _MASK, spp_offset & _MASK,
            spp, max_bounces, float(np.float32(1.0 / spp)),
            *map(int, flags), split, samples.data_ptr(), begin, npix,
            events, stream)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"diffkernel launch failed: CUDA error {err} "
                           f"({msg})")
    return img, acc


@functools.lru_cache(maxsize=32)
def _rows_on(rows: tuple, device: str) -> torch.Tensor:
    """Scene rows as a long index tensor on the device, built once."""
    return torch.tensor(rows, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=16)
def _scope_tensors(surr_s: tuple, surr_q: tuple, device: str):
    """The surrogate row lists as int32 tensors on the device (a scope
    is fixed for a fit, so they are built once)."""
    return (torch.tensor(surr_s, dtype=torch.int32, device=device),
            torch.tensor(surr_q, dtype=torch.int32, device=device))


def _grads_to_scene(scene, st: DiffStatic, dsph, dquad, dmat, dlight,
                    dmisc):
    """Map the compacted gradient tables back to scene-shaped tensors.
    Light rows add in order, so lights sharing a material sum the same
    way on every device."""
    ns_real, nq_real = len(st.sph_rows), len(st.quad_rows)
    dev = str(scene.sph_center.device)
    g_sc = torch.zeros_like(scene.sph_center)
    g_sr = torch.zeros_like(scene.sph_radius)
    if ns_real:
        rows = _rows_on(st.sph_rows, dev)
        g_sc[rows] = dsph[:ns_real, 0:3]
        g_sr[rows] = dsph[:ns_real, 3]
    g_qc = torch.zeros_like(scene.quad_corner)
    g_qu = torch.zeros_like(scene.quad_u)
    g_qv = torch.zeros_like(scene.quad_v)
    if nq_real:
        rows = _rows_on(st.quad_rows, dev)
        g_qc[rows] = dquad[:nq_real, 0:3]
        g_qu[rows] = dquad[:nq_real, 3:6]
        g_qv[rows] = dquad[:nq_real, 6:9]
    nmr = scene.mat_albedo.shape[0]
    g_alb = dmat[:nmr, 0:3].clone()
    g_fuzz = dmat[:nmr, 3].clone()
    g_ior = dmat[:nmr, 4].clone()
    g_emit = dmat[:nmr, 5:8].clone()
    for k, (lq, lm) in enumerate(zip(st.light_quad_rows,
                                     st.light_mat_rows)):
        g_qc[lq] += dlight[k, 0:3]
        g_qu[lq] += dlight[k, 3:6]
        g_qv[lq] += dlight[k, 6:9]
        g_emit[lm] += dlight[k, 9:12]
    return {
        "sph_center": g_sc,
        "sph_radius": g_sr,
        "quad_corner": g_qc,
        "quad_u": g_qu,
        "quad_v": g_qv,
        "mat_albedo": g_alb,
        "mat_fuzz": g_fuzz,
        "mat_ior": g_ior,
        "mat_emit": g_emit,
        "background": dmisc[0, 0:3].clone(),
    }
