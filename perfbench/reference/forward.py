"""The plain forward path tracer: the radiance of chosen pixels.

The reference binary's estimator (cheolwanpark/tiny-raytracer:
sampler/cpu.rs, the materials under material/, hittable/sphere.rs and
quad.rs) written as plain PyTorch over lanes, one lane a (pixel, sample)
pair:

- a jittered thin-lens camera ray per sample, u = (x + r1) / (w - 1),
  v = (y + r2) / (h - 1), the defocus disk in polar form, with the
  uniforms of PCG4D stream 0;
- per bounce, the closest hit over the spheres and then the quads (a
  strict `<` first minimum, half-open quad bounds, t >= 1e-3), then the
  shading with the uniforms of stream 1 + b: emission or background,
  Lambertian (normal + unit vector, degenerate fallback), metal (reflect
  + fuzz), dielectric (Schlick, total internal reflection), light
  (absorbs);
- the pixel's radiance is its samples' colours added in sample order,
  times f32(1 / spp).

Every operation is one separately rounded f32 operation, in the order
that the f32 implementations of the estimator share. The tracer runs in
`dtype` (f32 for the reference; a lower precision for the control) and
counts the segments it executes: a lane pays a segment for each bounce
it starts alive.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import rng
from perfbench.reference.scene import Lowered

T_MIN = 1.0e-3
MISS = 3.0e38
TWO_PI = 6.283185307179586
GAMMA = 2.2
INTENSITY_MAX = 0.999
# Elements of one (rows, lanes) candidate matrix per lane chunk.
CANDIDATE_BUDGET = 1 << 25


def normalize3(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def sphere_ts(sph, ox, oy, oz, dx, dy, dz):
    """(S, N) hit distances: the near root, else the far one, at
    t >= T_MIN; MISS when neither."""
    ocx = ox - sph[:, 0:1]
    ocy = oy - sph[:, 1:2]
    ocz = oz - sph[:, 2:3]
    half_b = ocx * dx + ocy * dy + ocz * dz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - sph[:, 3:4]
    disc = half_b * half_b - c_term
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -half_b - sq
    t1 = -half_b + sq
    t = torch.where(t0 >= T_MIN, t0, torch.where(t1 >= T_MIN, t1, MISS))
    return torch.where(disc >= 0.0, t, MISS)


def quad_ts(quad, ox, oy, oz, dx, dy, dz):
    """(Q, N) hit distances: the plane's t where the planar coordinates
    lie in [0, 1), t >= T_MIN; MISS otherwise."""
    q = [quad[:, k:k + 1] for k in range(12)]
    qnx, qny, qnz, qdp, avx, avy, avz, qca, bvx, bvy, bvz, qcb = q
    den = qnx * dx + qny * dy + qnz * dz
    ok_den = torch.abs(den) >= 1e-12
    den = torch.where(ok_den, den, 1e-12)
    tq = (qdp - (qnx * ox + qny * oy + qnz * oz)) / den
    al = (avx * ox + avy * oy + avz * oz) + tq * (
        avx * dx + avy * dy + avz * dz) - qca
    be = (bvx * ox + bvy * oy + bvz * oz) + tq * (
        bvx * dx + bvy * dy + bvz * dz) - qcb
    ok = (ok_den & (tq >= T_MIN) & (al >= 0.0) & (al < 1.0)
          & (be >= 0.0) & (be < 1.0))
    return torch.where(ok, tq, MISS)


def closest_hit(low: Lowered, ox, oy, oz, dx, dy, dz):
    """(best t, hit, the 13 payload columns, zero on a miss)."""
    ts = []
    if low.n_sph:
        ts.append(sphere_ts(low.sph, ox, oy, oz, dx, dy, dz))
    if low.n_quad:
        ts.append(quad_ts(low.quad, ox, oy, oz, dx, dy, dz))
    ts = torch.cat(ts, 0)
    win = torch.argmin(ts, 0)
    best = ts.gather(0, win[None])[0]
    hit = best < MISS
    w = torch.where(hit[:, None], low.pay[win], 0.0)
    return best, hit, w.unbind(1)


def _pow5(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x


def shade(ox, oy, oz, dx, dy, dz, tput, col, alive, best_t, hit, w,
          u, bg, has_met, has_die):
    """One bounce: the colour gathered and the scattered ray."""
    (w_isq, w_ax, w_ay, w_az, w_kind, w_ar, w_ag, w_ab, w_fuzz, w_ior,
     w_er, w_eg, w_eb) = w
    u1, u2, u3, u4 = u
    hit_live = alive & hit
    miss_live = alive & ~hit
    t = torch.where(hit, best_t, 1.0)
    p_x = ox + t * dx
    p_y = oy + t * dy
    p_z = oz + t * dz
    quad = w_isq > 0.5
    onx, ony, onz = normalize3(torch.where(quad, w_ax, p_x - w_ax),
                               torch.where(quad, w_ay, p_y - w_ay),
                               torch.where(quad, w_az, p_z - w_az))
    front = (dx * onx + dy * ony + dz * onz) < 0.0
    sgn = torch.where(front, 1.0, -1.0).to(ox.dtype)
    nx_ = onx * sgn
    ny_ = ony * sgn
    nz_ = onz * sgn
    dt = ox.dtype
    mlf = miss_live.to(dt)
    hlf = hit_live.to(dt)
    col = [c + mlf * tp * b + hlf * tp * e
           for c, tp, b, e in zip(col, tput, bg, (w_er, w_eg, w_eb))]

    theta = TWO_PI * u1
    cphi = 1.0 - 2.0 * u2
    sphi = torch.sqrt(torch.clamp_min(1.0 - cphi * cphi, 0.0))
    rr = torch.exp(torch.log(torch.clamp_min(u3, 1e-30)) * (1.0 / 3.0))
    bx = rr * sphi * torch.cos(theta)
    by = rr * sphi * torch.sin(theta)
    bz = rr * cphi
    bnorm = 1.0 / torch.sqrt(torch.clamp_min(bx * bx + by * by + bz * bz,
                                             1e-30))
    lx = nx_ + bx * bnorm
    ly = ny_ + by * bnorm
    lz = nz_ + bz * bnorm
    degen = ((torch.abs(lx) < 1e-7) & (torch.abs(ly) < 1e-7)
             & (torch.abs(lz) < 1e-7))
    lx = torch.where(degen, nx_, lx)
    ly = torch.where(degen, ny_, ly)
    lz = torch.where(degen, nz_, lz)
    if has_met or has_die:
        ddn = dx * nx_ + dy * ny_ + dz * nz_
        rx = dx - 2.0 * ddn * nx_
        ry = dy - 2.0 * ddn * ny_
        rz = dz - 2.0 * ddn * nz_
    if has_met:
        mx = rx + w_fuzz * bx
        my = ry + w_fuzz * by
        mz = rz + w_fuzz * bz
    if has_die:
        eta = torch.where(front, 1.0 / w_ior, w_ior)
        cos = torch.clamp_max(-(nx_ * dx + ny_ * dy + nz_ * dz), 1.0)
        sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, 0.0))
        tir = eta * sin > 1.0
        sr0 = (1.0 - eta) / (1.0 + eta)
        r0 = sr0 * sr0
        refl = r0 + (1.0 - r0) * _pow5(1.0 - cos)
        choose_reflect = tir | (refl > u4)
        px_ = eta * (dx + nx_ * cos)
        py_ = eta * (dy + ny_ * cos)
        pz_ = eta * (dz + nz_ * cos)
        plen2 = px_ * px_ + py_ * py_ + pz_ * pz_
        par = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - plen2), 1e-12))
        gx = torch.where(choose_reflect, rx, px_ + par * nx_)
        gy = torch.where(choose_reflect, ry, py_ + par * ny_)
        gz = torch.where(choose_reflect, rz, pz_ + par * nz_)
    is_lam = w_kind < 0.5
    if has_met and has_die:
        is_met = (w_kind >= 0.5) & (w_kind < 1.5)
        sx = torch.where(is_lam, lx, torch.where(is_met, mx, gx))
        sy = torch.where(is_lam, ly, torch.where(is_met, my, gy))
        sz = torch.where(is_lam, lz, torch.where(is_met, mz, gz))
    elif has_met:
        sx, sy, sz = (torch.where(is_lam, a, b)
                      for a, b in ((lx, mx), (ly, my), (lz, mz)))
    elif has_die:
        sx, sy, sz = (torch.where(is_lam, a, b)
                      for a, b in ((lx, gx), (ly, gy), (lz, gz)))
    else:
        sx, sy, sz = lx, ly, lz
    sx, sy, sz = normalize3(sx, sy, sz)
    absorbed = w_kind >= 2.5
    scat = hit_live & ~absorbed
    sf = scat.to(dt)
    inv_sf = 1.0 - sf
    tput = [tp * (inv_sf + sf * a) for tp, a in zip(tput, (w_ar, w_ag, w_ab))]
    ox = torch.where(scat, p_x, ox)
    oy = torch.where(scat, p_y, oy)
    oz = torch.where(scat, p_z, oz)
    dx = torch.where(scat, sx, dx)
    dy = torch.where(scat, sy, dy)
    dz = torch.where(scat, sz, dz)
    return (ox, oy, oz, dx, dy, dz), tput, col, scat


def trace_lanes(low: Lowered, cam: torch.Tensor, pid: torch.Tensor,
                samp: torch.Tensor, *, width: int, seed: int,
                max_bounces: int):
    """(N, 3) colour of the lanes (pixel id `pid`, sample id `samp`) and
    the segments they executed, on the device and in the dtype of `cam`
    and `low`."""
    dt = cam.dtype
    c = cam.unbind(0)
    bg = c[20:23]
    px = (pid % width).to(dt)
    py = (pid // width).to(dt)
    r1, r2, r3, r4 = rng.uniform4(seed, pid, samp, 0, dt)
    u = (px + r1) * c[18]
    v = (py + r2) * c[19]
    rad = torch.sqrt(r3)
    th = TWO_PI * r4
    cth, sth = torch.cos(th), torch.sin(th)
    o = [c[k] + rad * cth * c[12 + k] + rad * sth * c[15 + k]
         for k in range(3)]
    t = [c[3 + k] + u * c[6 + k] - v * c[9 + k] - o[k] for k in range(3)]
    ray = (*o, *normalize3(*t))
    one = torch.ones(pid.shape[0], dtype=dt, device=pid.device)
    tput = [one, one, one]
    col = [torch.zeros_like(one) for _ in range(3)]
    alive = torch.ones(pid.shape[0], dtype=torch.bool, device=pid.device)
    segments = 0
    for b in range(max_bounces):
        segments += int(alive.sum())
        best, hit, w = closest_hit(low, *ray)
        uu = rng.uniform4(seed, pid, samp, 1 + b, dt)
        ray, tput, col, alive = shade(*ray, tput, col, alive, best, hit, w,
                                      uu, bg, low.has_met, low.has_die)
        if not bool(alive.any()):
            break
    return torch.stack(col, -1), segments


def render_pixels(low: Lowered, cam: torch.Tensor, pixels: torch.Tensor, *,
                  width: int, spp: int, seed: int, max_bounces: int,
                  lane_chunk: int = 0):
    """(P, 3) linear radiance of the flat pixel ids `pixels` over samples
    [0, spp), and the mean segments a camera ray executed. Lanes go in
    chunks of whole pixels (`lane_chunk` lanes at most; 0 keeps each
    candidate matrix within CANDIDATE_BUDGET elements)."""
    dev = cam.device
    rows = max(1, low.n_sph + low.n_quad)
    lanes = lane_chunk or max(spp, CANDIDATE_BUDGET // rows)
    per = max(1, lanes // spp)
    inv = float(np.float32(1.0 / spp))
    out, segments = [], 0
    for p0 in range(0, pixels.shape[0], per):
        pid = pixels[p0:p0 + per].to(dev, torch.int64)
        n = pid.shape[0]
        lane_pid = pid.repeat_interleave(spp)
        lane_s = torch.arange(spp, dtype=torch.int64, device=dev).repeat(n)
        col, seg = trace_lanes(low, cam, lane_pid, lane_s, width=width,
                               seed=seed, max_bounces=max_bounces)
        col = col.view(n, spp, 3)
        acc = torch.zeros((n, 3), dtype=cam.dtype, device=dev)
        for s in range(spp):
            acc = acc + col[:, s]
        out.append(acc * inv)
        segments += seg
    return torch.cat(out), segments / (pixels.shape[0] * spp)


def gamma(linear: np.ndarray) -> np.ndarray:
    """The gamma-2.2 image of linear radiance, negatives clamped, in f32
    (image.rs `new_with_gamma_correction`)."""
    return np.maximum(np.asarray(linear, np.float32), 0.0) ** (1.0 / GAMMA)


def to_u8(img_gamma: np.ndarray) -> np.ndarray:
    """The 8-bit values the PNG holds: clamped to [0, 0.999], times 255,
    truncated (image.rs)."""
    return np.asarray(np.clip(np.asarray(img_gamma, np.float32), 0.0,
                              INTENSITY_MAX) * 255.0, np.uint8)
