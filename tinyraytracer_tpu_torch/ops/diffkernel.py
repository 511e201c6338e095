"""Fused differentiable render: the training objective and its gradients
in one kernel launch (port of the routing half of ops/diffkernel.py).

    L = mean((render_nee(scene) - target)^2)

is evaluated and differentiated w.r.t. every scene parameter by one
kernel: an NEE forward image, the per-pixel MSE cotangent, and a
hand-derived reverse sweep over each sample's bounces. The estimator is
that of ops/trace.trace(nee=True, silhouette=True): the same pcg4d
streams, emission-skip rule, quad-light NEE with the soft-shadow
surrogate, silhouette surrogates and material scatter chains.

The JAX package has two such kernels. Scenes of at most
DIFF_PACKED_MAX_PRIMS real primitives and DIFF_PACKED_MAX_SPHERES real
spheres, with a constant background and a class-level surrogate scope, go
to the packed kernel (ops/diffkernel_packed.py, K5, ported); every other
case goes to the classic-layout kernel K4 (`_make_diff_kernel`), which is
not ported yet: those cases raise NotImplementedError here, as do scenes
whose gradient tables overflow the CUDA K5's per-thread accumulator
(`routes_packed` is the one rule).

Gradient targets: sph_center, sph_radius, quad_corner, quad_u, quad_v,
mat_albedo, mat_fuzz, mat_ior, mat_emit, background.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tinyraytracer_tpu_torch.models import materials as mat

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

_K4 = ("the classic-layout fused diff kernel K4 "
       "(ops/diffkernel.py:_make_diff_kernel), which is not ported yet")


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
    return (np.asarray(background, np.float32).ndim == 1
            and n_sph + n_quad <= DIFF_PACKED_MAX_PRIMS
            and n_sph <= DIFF_PACKED_MAX_SPHERES
            and packed_acc_width(n_sph, n_quad, st.nm, st.n_lights)
            <= DIFF_PACKED_MAX_ACC)


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
    class, () or missing = the class compiled out, a row tuple = an
    explicit subset (classic kernel K4 only). `packed` None routes as the
    JAX package does; `tile` is accepted and ignored (the CUDA kernel
    runs one thread per pixel).
    """
    if np.asarray(background, np.float32).ndim != 1:
        raise ValueError(
            "the fused diff kernels support constant backgrounds only; "
            "gradient-sky ((2,3) [bottom, top]) scenes train through the "
            "modular path (make_train_step / render_loss), which "
            "differentiates the sky-lerped miss term via autodiff")
    if mesh is not None:
        raise NotImplementedError(
            "sharded fused training (parallel/sharded.py) is not ported yet")
    st = static if static is not None else build_diff_static(scene)
    surr_sph_on = surr_quad_on = True
    if surr_rows is not None:
        sv = surr_rows.get("sph", ())
        qv = surr_rows.get("quad", ())
        smap = {r: i for i, r in enumerate(st.sph_rows)}
        qmap = {r: j for j, r in enumerate(st.quad_rows)}
        try:
            surr_s = None if sv is None else tuple(sorted(
                smap[int(r)] for r in sv))
            surr_q = None if qv is None else tuple(sorted(
                qmap[int(r)] for r in qv))
        except KeyError as e:
            raise ValueError(
                f"surr_rows names row {e} which is not a valid "
                "sphere/quad row of this scene") from None
        surr_sph_on = sv is None
        surr_quad_on = qv is None
        if surr_s or surr_q:
            raise NotImplementedError(
                f"explicit surrogate row subsets need {_K4}")
    if packed is None:
        packed = routes_packed(st, background)
    if not packed:
        raise NotImplementedError(
            f"scenes of more than {DIFF_PACKED_MAX_PRIMS} primitives or "
            f"{DIFF_PACKED_MAX_SPHERES} spheres, or whose gradients need "
            f"more than {DIFF_PACKED_MAX_ACC} accumulators per pixel, "
            f"need {_K4}")
    from tinyraytracer_tpu_torch.ops.diffkernel_packed import (
        render_value_and_grad_packed,
    )

    return render_value_and_grad_packed(
        scene, camera, target, spp=spp, max_bounces=max_bounces,
        background=background, seed=seed, spp_offset=spp_offset, nee=nee,
        silhouette=silhouette, static=st, tile=tile,
        surr_sph=surr_sph_on, surr_quad=surr_quad_on)


def _grads_to_scene(scene, st: DiffStatic, dsph, dquad, dmat, dlight,
                    dmisc):
    """Map the compacted gradient tables back to scene-shaped tensors.
    Light rows add in order, so lights sharing a material sum the same
    way on every device."""
    ns_real, nq_real = len(st.sph_rows), len(st.quad_rows)
    g_sc = torch.zeros_like(scene.sph_center)
    g_sr = torch.zeros_like(scene.sph_radius)
    if ns_real:
        rows = list(st.sph_rows)
        g_sc[rows] = dsph[:ns_real, 0:3]
        g_sr[rows] = dsph[:ns_real, 3]
    g_qc = torch.zeros_like(scene.quad_corner)
    g_qu = torch.zeros_like(scene.quad_u)
    g_qv = torch.zeros_like(scene.quad_v)
    if nq_real:
        rows = list(st.quad_rows)
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
