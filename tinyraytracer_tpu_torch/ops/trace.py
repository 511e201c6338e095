"""The modular wavefront path tracer, differentiable (port of ops/trace.py).

The whole ray batch advances together through a masked loop over
bounces, with the reference's semantics step for step: exactly
`max_bounces` hit+scatter iterations; emission added on every hit;
throughput *= attenuation on scatter; a light absorbs; a miss adds
throughput * background and the ray dies; exhausting the budget adds no
background. Every step is PyTorch autograd code, so the radiance is
differentiable in the scene; the closest-hit *selections* (dense argmin,
kernel K3 through `compact`, or the BVH walk through `bvh`) are
detached, and gradients flow through the winner's recomputed t
(ops/intersect.py).

`nee=True` samples quad lights explicitly (next-event estimation), which
makes direct light a smooth function of geometry; `silhouette=True`
multiplies throughput by a value-preserving ratio whose gradient is the
score of a soft visibility of every primitive (`_silhouette_factor`).
Both surrogates build (rows, rays) matrices over the scene's *valid*
primitives only: a padded row's factor is exactly 1 in the JAX package,
so dropping it changes no forward value and leaves its (zero) gradient.

Selections can be recorded and replayed (`SelectionTape`): the training
loss (diff/inverse.py) renders once without a graph, then replays the
saved selections while it rebuilds the graph one sample round at a time,
the counterpart of the JAX package's rematerialisation that saves only
the selections (trace.py:42, 204-205).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from tinyraytracer_tpu_torch.models import materials as mat
from tinyraytracer_tpu_torch.models.camera import Camera, generate_rays
from tinyraytracer_tpu_torch.ops import bvh as bvh_ops
from tinyraytracer_tpu_torch.ops import intersect as isect
from tinyraytracer_tpu_torch.ops import rng
from tinyraytracer_tpu_torch.ops.intersect import (
    clip,
    const,
    cross,
    maximum,
    minimum,
    take_rows,
)
from tinyraytracer_tpu_torch.ops.intersect_kernel import (
    closest_hit,
    closest_hit_reference,
)
from tinyraytracer_tpu_torch.ops.scatter import scatter

# Target wavefront width (rays traced at once) when fusing samples.
_FUSE_RAY_TARGET = 1 << 20

# The NEE light-choice stream: 0x40000000 + bounce.
_NEE_STREAM = 0x40000000


@dataclasses.dataclass(frozen=True)
class SceneRows:
    """Structure of a scene the surrogates need, as device index tensors:
    the valid sphere and quad rows, and the valid quads whose material is
    a light (in row order). Parameters never change it."""

    sph: torch.Tensor
    quad: torch.Tensor
    light: torch.Tensor

    @property
    def n_lights(self) -> int:
        return int(self.light.shape[0])


def scene_rows(scene) -> SceneRows:
    """The scene's SceneRows (reads the masks back to the host once)."""
    sv = scene.sph_valid.detach().cpu()
    qv = scene.quad_valid.detach().cpu()
    kind = scene.mat_kind.detach().cpu()
    qmat = scene.quad_mat.detach().cpu().to(torch.int64)
    light = (kind[qmat] == mat.LIGHT) & qv
    dev = scene.sph_center.device

    def idx(mask):
        return torch.nonzero(mask).flatten().to(dev)

    return SceneRows(sph=idx(sv), quad=idx(qv), light=idx(light))


class SelectionTape:
    """The detached selections of `trace` calls, in the order they were
    made. Passed as `trace(tape=...)` it records; after `replay()` the
    same calls take the recorded results, in order, instead of selecting
    again."""

    def __init__(self):
        self.entries: list = []
        self._pos: Optional[int] = None
        self._rays = slice(None)

    def replay(self, rays: slice = slice(None)) -> "SelectionTape":
        """Replay from the start, for the rays `rays` of the recorded
        wavefront."""
        self._pos, self._rays = 0, rays
        return self

    def __call__(self, select, o, d, need_j=True):
        if self._pos is None:
            t, j = select(o, d, need_j)
            out = (t, j if need_j else None)
            self.entries.append(out)
            return out
        out = self.entries[self._pos]
        self._pos += 1
        return tuple(None if x is None else x[self._rays] for x in out)


def trace(
    scene,
    origins,
    directions,
    pixel_id,
    sample_id,
    seed,
    max_bounces: int,
    background,
    exact: bool = False,
    remat: bool = True,
    compact=None,
    nee: bool = False,
    silhouette: bool = False,
    count_alive: bool = False,
    tape: Optional[SelectionTape] = None,
    rows: Optional[SceneRows] = None,
    bvh=None,
):
    """Path-trace a ray wavefront. Returns (R, 3) linear radiance, and
    with `count_alive=True` also the per-bounce alive ray counts
    (max_bounces,) f32.

    origins/directions: (R, 3) with unit directions; pixel_id: (R,) ints;
    sample_id: an int or (R,) ints; background: (3,) or a (2, 3) gradient
    sky [bottom, top]. Selection: K3 over `compact`
    (intersect_kernel.CompactRows; its `plain` flag runs the twin), else
    the BVH walk over `bvh` (ops/bvh.BVHArrays), else dense over every
    primitive (`exact` picks the oracle form).
    `remat` (with autograd on) recomputes each bounce in the backward
    pass from its saved selections instead of keeping its graph.
    `rows` is `scene_rows(scene)`, computed when not given.
    """
    dev = origins.device
    r = origins.shape[0]
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    if rows is None and (nee or silhouette):
        rows = scene_rows(scene)

    def select(o, d, need_j=True):
        """Detached closest-hit selection: (t_screen, j). j < 0 = miss;
        a shadow ray needs only t (`need_j` False: K3 launches t-only and
        returns j None, a tape drops j)."""
        if compact is not None:
            if compact.plain:
                return closest_hit_reference(compact, o, d, need_j)
            return closest_hit(compact, o, d, need_j)
        if bvh is not None:
            return bvh_ops.traverse(scene, bvh, o, d)
        return isect.closest_select(scene, o, d, exact=exact)

    if tape is not None:
        base = select
        select = lambda o, d, need_j=True: tape(base, o, d, need_j)  # noqa

    def body(bounce, sel, o, d, throughput, color, alive, prev_diffuse):
        t_sel, j = sel(o, d)
        if silhouette:
            throughput = throughput * _silhouette_factor(
                scene, o, d, t_sel, j, alive, rows)[:, None]
        rec = isect.select_to_record(scene, o, d, t_sel, j)

        hit_live = alive & rec.hit
        miss_live = alive & ~rec.hit

        if background.dim() == 2:
            tmix = 0.5 * (d[:, 1:2] + 1.0)
            bg_ray = background[0][None, :] + tmix * (
                background[1] - background[0])[None, :]
        else:
            bg_ray = background[None, :]
        color = color + torch.where(miss_live[:, None], throughput * bg_ray,
                                    0.0)
        # Under NEE a diffuse bounce already counted the quad lights it
        # samples; emission of sphere lights is still counted here.
        if nee:
            nee_sampled = rec.is_quad & (rec.mat_kind == mat.LIGHT)
            count_emit = hit_live & ~(prev_diffuse & nee_sampled)
        else:
            count_emit = hit_live
        color = color + torch.where(count_emit[:, None],
                                    throughput * rec.emit, 0.0)
        if nee:
            color = color + _nee_contribution(
                scene, rec, hit_live, throughput, d, seed, pixel_id,
                sample_id, bounce, sel, rows)

        new_d, attenuation, absorbed = scatter(d, rec, seed, pixel_id,
                                               sample_id, bounce)
        scattered = hit_live & ~absorbed
        throughput = torch.where(scattered[:, None],
                                 throughput * attenuation, throughput)
        o = torch.where(scattered[:, None], rec.point, o)
        d = torch.where(scattered[:, None], new_d, d)
        prev_diffuse = scattered & (rec.mat_kind == mat.LAMBERTIAN)
        return o, d, throughput, color, scattered, prev_diffuse

    ones = torch.ones((r, 3), dtype=torch.float32, device=dev)
    carry = (origins, directions, ones, torch.zeros_like(ones),
             torch.ones((r,), dtype=torch.bool, device=dev),
             torch.zeros((r,), dtype=torch.bool, device=dev))
    use_ckpt = remat and torch.is_grad_enabled()
    counts = []
    for b in range(max_bounces):
        if use_ckpt:
            # the bounce's selections are recorded on its first run and
            # replayed when the backward pass recomputes it
            def run(*c, b=b, tape_b=SelectionTape()):
                if tape_b.entries:
                    tape_b.replay()
                return body(b, lambda o, d, need_j=True: tape_b(
                    select, o, d, need_j), *c)

            carry = checkpoint(run, *carry, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            carry = body(b, select, *carry)
        if count_alive:
            counts.append(carry[4].to(torch.float32).sum())
    colors = carry[3]
    if count_alive:
        return colors, torch.stack(counts)
    return colors


def _silhouette_factor(scene, o, d, t_sel, j, alive, rows: SceneRows):
    """Boundary (silhouette) gradients via a value-preserving ratio.

    Each ray x primitive visibility event is a Bernoulli with a soft
    probability: for spheres, from the ray line's distance to the center
    (p = cov if the ray's winner is that sphere, 1 - cov otherwise); for
    quads, the four planar-coordinate edges softened with sigmoids
    (p = cov if the winner, else 1 - gate * cov with a detached "plane
    crossed in front of the winner" gate). Throughput is multiplied by
    prod p / stop_grad(prod p): forward exactly 1, backward the score
    d log p / d(params). Rays and the winner t are detached; primitives
    behind the winner get p = 1. Rows are the valid ones (`rows`)."""
    o, d, t_sel = o.detach(), d.detach(), t_sel.detach()
    ns = scene.sph_center.shape[0]
    c = take_rows(scene.sph_center, rows.sph)                 # (Ns,3)
    cx, cy, cz = c[:, 0:1], c[:, 1:2], c[:, 2:3]
    r = torch.abs(take_rows(scene.sph_radius, rows.sph))[:, None]

    hit = t_sel < isect.MISS_T
    t_lim = torch.where(hit, t_sel, 3.0e30)[None, :]          # (1,R)
    is_sph_winner = hit[None, :] & (j[None, :] == rows.sph[:, None])

    ox, oy, oz = o[:, 0][None, :], o[:, 1][None, :], o[:, 2][None, :]
    dx, dy, dz = d[:, 0][None, :], d[:, 1][None, :], d[:, 2][None, :]
    cox = cx - ox                                             # (Ns,R)
    coy = cy - oy
    coz = cz - oz
    s_along = cox * dx + coy * dy + coz * dz
    # hit event: closest approach of the forward ray line; pass-by event:
    # clamped to the winner t, so spheres behind the hit stay inert
    s_hit = maximum(s_along, isect.T_MIN)
    s_blk = clip(s_along, isect.T_MIN, t_lim)
    s_eff = torch.where(is_sph_winner, s_hit, s_blk)
    ex = ox + s_eff * dx - cx
    ey = oy + s_eff * dy - cy
    ez = oz + s_eff * dz - cz
    dmin = torch.sqrt(maximum(ex * ex + ey * ey + ez * ez, 1e-12))
    w = 0.05 * r + 1e-5
    cov = torch.sigmoid((r - dmin) / w)
    p = torch.where(is_sph_winner, cov, 1.0 - cov)
    p = torch.where(alive[None, :], p, 1.0)
    # clamp p before the ratio so numerator and denominator match: the
    # forward value stays exactly 1
    p = maximum(p, 1e-3)
    ratio = torch.prod(p / p.detach(), dim=0)                 # (R,)

    qc = take_rows(scene.quad_corner, rows.quad)              # (Nq,3)
    qu = take_rows(scene.quad_u, rows.quad)
    qv = take_rows(scene.quad_v, rows.quad)
    qn = cross(qu, qv)
    qd = torch.sum(qn * qc, dim=-1)
    qw = qn / maximum(torch.sum(qn * qn, dim=-1, keepdim=True), 1e-12)
    nx_, ny_, nz_ = qn[:, 0:1], qn[:, 1:2], qn[:, 2:3]
    denom = nx_ * dx + ny_ * dy + nz_ * dz                    # (Nq,R)
    # parallel rays never cross the plane: keep t finite, gate them off
    denom_ok = torch.abs(denom) > 1e-8
    denom_safe = torch.where(denom_ok, denom, 1.0)
    n_dot_o = nx_ * ox + ny_ * oy + nz_ * oz
    t_pl = (qd[:, None] - n_dot_o) / denom_safe
    prx = ox + t_pl * dx - qc[:, 0:1]
    pry = oy + t_pl * dy - qc[:, 1:2]
    prz = oz + t_pl * dz - qc[:, 2:3]
    ux_, uy_, uz_ = qu[:, 0:1], qu[:, 1:2], qu[:, 2:3]
    vx_, vy_, vz_ = qv[:, 0:1], qv[:, 1:2], qv[:, 2:3]
    wx_, wy_, wz_ = qw[:, 0:1], qw[:, 1:2], qw[:, 2:3]
    alpha = ((pry * vz_ - prz * vy_) * wx_
             + (prz * vx_ - prx * vz_) * wy_
             + (prx * vy_ - pry * vx_) * wz_)
    beta = ((uy_ * prz - uz_ * pry) * wx_
            + (uz_ * prx - ux_ * prz) * wy_
            + (ux_ * pry - uy_ * prx) * wz_)
    wq = 0.05                                   # 5% of each edge length
    cov_q = (torch.sigmoid(alpha / wq) * torch.sigmoid((1.0 - alpha) / wq)
             * torch.sigmoid(beta / wq) * torch.sigmoid((1.0 - beta) / wq))
    is_quad_winner = hit[None, :] & ((j[None, :] - ns) == rows.quad[:, None])
    t_pl_s = t_pl.detach()
    gate = (denom_ok & (t_pl_s > isect.T_MIN) & (t_pl_s < t_lim)).to(
        torch.float32)
    pq = torch.where(is_quad_winner, cov_q, 1.0 - gate * cov_q)
    pq = torch.where(alive[None, :], pq, 1.0)
    pq = maximum(pq, 1e-3)
    return ratio * torch.prod(pq / pq.detach(), dim=0)        # (R,)


def _nee_contribution(scene, rec, hit_live, throughput, d, seed, pixel_id,
                      sample_id, bounce, select, rows: SceneRows):
    """Direct light by area sampling of quad lights: one light chosen
    uniformly per shading point (weighted by the light count), a detached
    shadow ray through `select`, and a soft-shadow ratio V_soft /
    stop_grad(V_soft) over the sphere and quad occluders whose gradient
    is the score of a soft visibility."""
    n_lights = rows.n_lights
    u1, u2, u3, _ = rng.uniform4(seed, pixel_id, sample_id,
                                 _NEE_STREAM + bounce)
    # the k-th light in row order, k = floor(u3 * NL) (JAX: argmax over
    # the cumulative-count match, the same row)
    k = torch.clamp((u3 * float(n_lights)).to(torch.int32), 0,
                    max(n_lights - 1, 0)).to(torch.int64)
    il = (rows.light.index_select(0, k) if n_lights
          else torch.zeros_like(k))

    corner = take_rows(scene.quad_corner, il)
    lu = take_rows(scene.quad_u, il)
    lv = take_rows(scene.quad_v, il)
    l_emit = take_rows(scene.mat_emit,
                       scene.quad_mat.index_select(0, il).to(torch.int64))

    y = corner + u1[:, None] * lu + u2[:, None] * lv          # on the light
    x = rec.point
    to_l = y - x
    r2 = torch.sum(to_l * to_l, dim=-1)
    dist = torch.sqrt(maximum(r2, 1e-12))
    w = to_l / dist[:, None]
    ln = cross(lu, lv)
    area = torch.sqrt(maximum(torch.sum(ln * ln, dim=-1), 1e-24))
    ln_unit = ln / area[:, None]
    cos_x = torch.sum(rec.normal * w, dim=-1)
    cos_y = torch.abs(torch.sum(ln_unit * w, dim=-1))      # double-sided

    # only diffuse surfaces get NEE
    active = hit_live & (rec.mat_kind == mat.LAMBERTIAN) & (cos_x > 0.0)
    if n_lights == 0:
        active = torch.zeros_like(active)

    occ_t, _ = select(x.detach(), w.detach(), need_j=False)
    visible = ~(occ_t < dist.detach() * (1.0 - 1e-3))

    # soft shadow of the sphere occluders: (Ns, R)
    c = take_rows(scene.sph_center, rows.sph)
    scx, scy, scz = c[:, 0:1], c[:, 1:2], c[:, 2:3]
    r_all = torch.abs(take_rows(scene.sph_radius, rows.sph))[:, None]
    xx, xy_, xz = x[:, 0][None, :], x[:, 1][None, :], x[:, 2][None, :]
    wx, wy, wz = w[:, 0][None, :], w[:, 1][None, :], w[:, 2][None, :]
    cxx = scx - xx
    cxy = scy - xy_
    cxz = scz - xz
    s_along = cxx * wx + cxy * wy + cxz * wz
    s_clamp = clip(s_along, 0.0, dist[None, :])
    ex = xx + s_clamp * wx - scx
    ey = xy_ + s_clamp * wy - scy
    ez = xz + s_clamp * wz - scz
    dsep = torch.sqrt(maximum(ex * ex + ey * ey + ez * ez, 1e-12))
    soft_w = 0.25 * r_all + 1e-6
    v_soft_i = torch.sigmoid((dsep - r_all) / soft_w)
    v_soft = torch.prod(v_soft_i, dim=0)                    # (R,)

    # soft shadow of the quad occluders: the segment's plane crossing,
    # softened on the four planar-coordinate edges; hard detached gate
    qc = take_rows(scene.quad_corner, rows.quad)
    qu = take_rows(scene.quad_u, rows.quad)
    qv = take_rows(scene.quad_v, rows.quad)
    qn_s = cross(qu, qv)
    qd_s = torch.sum(qn_s * qc, dim=-1)
    qw_s = qn_s / maximum(torch.sum(qn_s * qn_s, dim=-1, keepdim=True),
                          1e-12)
    nqx, nqy, nqz = qn_s[:, 0:1], qn_s[:, 1:2], qn_s[:, 2:3]
    den_s = nqx * wx + nqy * wy + nqz * wz                  # (Nq,R)
    den_ok = torch.abs(den_s) > 1e-8
    den_safe = torch.where(den_ok, den_s, 1.0)
    s_pl = (qd_s[:, None] - (nqx * xx + nqy * xy_ + nqz * xz)) / den_safe
    prx = xx + s_pl * wx - qc[:, 0:1]
    pry = xy_ + s_pl * wy - qc[:, 1:2]
    prz = xz + s_pl * wz - qc[:, 2:3]
    qux, quy, quz = qu[:, 0:1], qu[:, 1:2], qu[:, 2:3]
    qvx, qvy, qvz = qv[:, 0:1], qv[:, 1:2], qv[:, 2:3]
    qwx, qwy, qwz = qw_s[:, 0:1], qw_s[:, 1:2], qw_s[:, 2:3]
    al_s = ((pry * qvz - prz * qvy) * qwx
            + (prz * qvx - prx * qvz) * qwy
            + (prx * qvy - pry * qvx) * qwz)
    be_s = ((quy * prz - quz * pry) * qwx
            + (quz * prx - qux * prz) * qwy
            + (qux * pry - quy * prx) * qwz)
    wq_s = 0.05
    cov_qs = (torch.sigmoid(al_s / wq_s)
              * torch.sigmoid((1.0 - al_s) / wq_s)
              * torch.sigmoid(be_s / wq_s)
              * torch.sigmoid((1.0 - be_s) / wq_s))
    s_pl_s = s_pl.detach()
    gate_s = (den_ok & (s_pl_s > 1e-3)
              & (s_pl_s < dist.detach()[None, :] * (1.0 - 1e-3))).to(
                  torch.float32)
    v_soft_q = maximum(1.0 - gate_s * cov_qs, 1e-3)
    v_soft = v_soft * torch.prod(v_soft_q, dim=0)
    v_ratio = v_soft / maximum(v_soft.detach(), 1e-3)

    # f/pdf = (albedo/pi) E cos_x |cos_y| A NL / r^2, the 1/r^2 clamped
    geom = cos_x * cos_y * area * float(n_lights) / maximum(r2, 1e-12)
    geom = minimum(geom, 16.0 * math.pi)
    contrib = (throughput * rec.albedo * l_emit
               * (geom * v_ratio / math.pi)[:, None])
    gate = (active & visible)[:, None]
    return torch.where(gate, contrib, const(0.0, contrib))


def sample_rounds(npix: int, spp: int, fuse_spp: bool):
    """(chunk, rounds): with `fuse_spp`, `chunk` samples of every pixel are
    traced in one wavefront, chunk the largest divisor of spp that keeps
    chunk * npix within _FUSE_RAY_TARGET rays (the JAX package's rule)."""
    chunk = 1
    if fuse_spp:
        cap = max(1, _FUSE_RAY_TARGET // max(npix, 1))
        for c in range(min(spp, cap), 0, -1):
            if spp % c == 0:
                chunk = c
                break
    return chunk, spp // chunk


def round_ids(pixel_id: torch.Tensor, chunk: int, s0: int):
    """Pixel and sample ids of the round covering samples [s0, s0+chunk)."""
    if chunk == 1:
        return pixel_id, s0 & 0xFFFFFFFF
    npix = pixel_id.shape[0]
    pid = pixel_id.repeat(chunk)
    sid = ((s0 + torch.arange(chunk, dtype=torch.int64,
                              device=pixel_id.device)) & 0xFFFFFFFF
           ).repeat_interleave(npix)
    return pid, sid


def render_pixels(scene, camera: Camera, pixel_id, *, spp: int,
                  max_bounces: int, background, seed, exact: bool = False,
                  spp_offset: int = 0, compact=None, nee: bool = False,
                  silhouette: bool = False, fuse_spp: bool = False,
                  tapes: Optional[list] = None,
                  rows: Optional[SceneRows] = None,
                  bvh=None) -> torch.Tensor:
    """Mean radiance (npix, 3) over `spp` jittered samples of the given
    flat pixel ids (any subset of the image), on their device. With
    `tapes` (a list) each round's selections are recorded into a new
    SelectionTape appended to it.

    `fuse_spp` traces several samples of every pixel in one wavefront and
    sums them (`sample_rounds`). With a `bvh`, autograd off and no
    `tapes`, the samples are traced together too, since the walk's time
    goes by its steps, not its rays; unless `fuse_spp` is set, each
    sample's radiance is then added in sample order, which gives the bits
    of one sample at a time."""
    dev = pixel_id.device
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    camera = camera.to(dev)
    npix = pixel_id.shape[0]
    group = (bvh is not None and tapes is None
             and not torch.is_grad_enabled())
    chunk, rounds = sample_rounds(npix, spp, fuse_spp or group)
    if rows is None and (nee or silhouette):
        rows = scene_rows(scene)
    acc = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    for k in range(rounds):
        pid, sid = round_ids(pixel_id, chunk, k * chunk + int(spp_offset))
        o, d = generate_rays(camera, pid, sid, seed)
        tape = None
        if tapes is not None:
            tape = SelectionTape()
            tapes.append(tape)
        c = trace(scene, o, d, pid, sid, seed, max_bounces, background,
                  exact=exact, compact=compact, nee=nee,
                  silhouette=silhouette, tape=tape, rows=rows, bvh=bvh)
        if chunk == 1:
            acc = acc + c
        elif fuse_spp:
            acc = acc + c.reshape(chunk, npix, 3).sum(dim=0)
        else:
            for c_s in c.reshape(chunk, npix, 3):
                acc = acc + c_s
    return acc / float(spp)


def render_image(scene, camera: Camera, *, spp: int, max_bounces: int,
                 background, seed=0, exact: bool = False, compact=None,
                 nee: bool = False, silhouette: bool = False, bvh=None
                 ) -> torch.Tensor:
    """Render the full image, (height, width, 3) linear radiance, on the
    device of the scene's tensors."""
    w, h = camera.width, camera.height
    pixel_id = torch.arange(w * h, dtype=torch.int64,
                            device=scene.sph_center.device)
    img = render_pixels(scene, camera, pixel_id, spp=spp,
                        max_bounces=max_bounces, background=background,
                        seed=seed, exact=exact, compact=compact, nee=nee,
                        silhouette=silhouette, bvh=bvh)
    return img.reshape(h, w, 3)
