"""The plain forward path tracer with participating media.

Ray Tracing: The Next Week (Shirley et al.,
raytracing.github.io/books/RayTracingTheNextWeek.html), section
"Volumes": a `constant_medium` fills a boundary sphere with a constant
density and scatters with an `isotropic` phase function. Written as plain
PyTorch over lanes, one lane a (pixel, sample) pair, on top of the
forward tracer of perfbench/reference/forward.py (its camera ray, sphere
and quad tests and surface shading):

- a medium's hit along a ray (`medium_ts`): t1 < t2, the boundary
  sphere's two roots over the whole line, t1 raised to T_MIN (1e-3; the
  book raises it to the ray's interval start, then to 0), and no hit
  where the line misses the sphere or t1 >= t2 (the book's second
  boundary hit, the far root past t1 + 1e-4, is the far root itself).
  The free-flight distance is -(1 / density) ln(u); divided by |d| it
  puts the hit at t1 + distance / |d|, taken where that is below t2 (the
  book takes it up to t2). u = 0 gives ln 0 = -inf: no hit;
- u is the first uniform of PCG4D stream MEDIUM_STREAM | k << 16 | b for
  the medium of ordinal k (the order the description lists them) at
  bounce b of a sample: a stream that no camera ray (0) or scatter
  (1 + b) draws, where the book takes the next number of one shared
  generator;
- the closest hit is the least t over the spheres, the quads and then
  the media, a strict `<` first minimum in that row order (argmin's
  first index), as forward.py's over spheres then quads;
- a medium's hit scatters isotropically: to the uniform unit vector of
  the bounce's scatter uniforms (stream 1 + b, the Lambertian's draw),
  normalised, with the throughput times the medium's albedo and no
  emission (the book's `isotropic::scatter`).

Every operation is one separately rounded operation in `dtype`, in the
order of forward.py's f32 arithmetic. The tracer counts the segments it
executes (a lane a bounce it starts alive) and, of those, the ones whose
hit is a medium's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import forward, rng
from perfbench.reference.forward import MISS, T_MIN, TWO_PI
from perfbench.reference.scene import Lowered

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MEDIUM_STREAM = 0x80000000
ISOTROPIC = 4.0


@dataclasses.dataclass
class Media:
    """The media of a description, in its order: `rows` (D, 5) centre,
    radius^2 and -1/density of each boundary, `pay` (D, 13) each one's
    winner payload (forward.py's columns: is_quad 0, the centre as the
    normal source, kind ISOTROPIC, the albedo, fuzz 0, ior 1, no
    emission)."""

    rows: torch.Tensor
    pay: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    def to(self, device, dtype=torch.float32) -> "Media":
        return Media(rows=self.rows.to(device, dtype),
                     pay=self.pay.to(device, dtype))


def media(desc: dict) -> Media:
    """The description's `media` list: each `{"boundary": {"center",
    "radius"}, "density", "albedo"}`; radius^2 and -1/density are f32
    operations on the f32 values."""
    items = desc.get("media", [])
    n = len(items)
    rows = np.zeros((n, 5), np.float32)
    pay = np.zeros((n, 13), np.float32)
    for k, m in enumerate(items):
        c = np.asarray(m["boundary"]["center"], np.float32)
        r = np.float32(m["boundary"]["radius"])
        rows[k, 0:3] = c
        rows[k, 3] = r * r
        rows[k, 4] = np.float32(-1.0) / np.float32(m["density"])
        pay[k, 1:4] = c
        pay[k, 4] = ISOTROPIC
        pay[k, 5:8] = np.asarray(m["albedo"], np.float32)
        pay[k, 9] = 1.0
    return Media(rows=torch.from_numpy(rows), pay=torch.from_numpy(pay))


def medium_ts(rows, ox, oy, oz, dx, dy, dz, u):
    """(D, N) hit distances of the media `rows` (D, 5) for rays (N,), `u`
    (D, N) each medium's uniform; MISS where a medium is not hit."""
    ocx = ox - rows[:, 0:1]
    ocy = oy - rows[:, 1:2]
    ocz = oz - rows[:, 2:3]
    half_b = ocx * dx + ocy * dy + ocz * dz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - rows[:, 3:4]
    disc = half_b * half_b - c_term
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = torch.clamp_min(-half_b - sq, T_MIN)
    t2 = -half_b + sq
    length = torch.sqrt(dx * dx + dy * dy + dz * dz)
    t = t1 + rows[:, 4:5] * torch.log(u) / length
    return torch.where((disc >= 0.0) & (t1 < t2) & (t < t2), t, MISS)


def closest_hit(low: Lowered, med: Media, key, ox, oy, oz, dx, dy, dz):
    """(best t, hit, the 13 payload columns, zero on a miss) over the
    spheres, the quads and the media; `key` (seed, pixel ids, sample ids,
    bounce) draws each medium's uniform."""
    seed, pid, samp, b = key
    ts = []
    if low.n_sph:
        ts.append(forward.sphere_ts(low.sph, ox, oy, oz, dx, dy, dz))
    if low.n_quad:
        ts.append(forward.quad_ts(low.quad, ox, oy, oz, dx, dy, dz))
    if med.n:
        u = torch.stack([
            rng.uniform4(seed, pid, samp, MEDIUM_STREAM | (k << 16) | b,
                         ox.dtype)[0] for k in range(med.n)])
        ts.append(medium_ts(med.rows, ox, oy, oz, dx, dy, dz, u))
    ts = torch.cat(ts, 0)
    win = torch.argmin(ts, 0)
    best = ts.gather(0, win[None])[0]
    hit = best < MISS
    pay = torch.cat([low.pay, med.pay], 0)
    w = torch.where(hit[:, None], pay[win], 0.0)
    return best, hit, w.unbind(1)


def shade(ray, tput, col, alive, best_t, hit, w, u, bg, has_met, has_die):
    """One bounce: forward.py's surface shading, then the isotropic
    scatter of the lanes whose hit is a medium's (which the surface
    shading leaves unmoved and alive no longer). Returns the scattered
    ray, throughput, colour, alive, and which lanes scattered in a
    medium."""
    ray2, tput2, col2, scat = forward.shade(*ray, tput, col, alive, best_t,
                                            hit, w, u, bg, has_met, has_die)
    ox, oy, oz, dx, dy, dz = ray
    u1, u2, u3, _ = u
    iso = alive & hit & (w[4] > 3.5)
    # isotropic::scatter: a uniform unit vector (the scatter uniforms of
    # the bounce, as the Lambertian's random_unit_vector)
    theta = TWO_PI * u1
    cphi = 1.0 - 2.0 * u2
    sphi = torch.sqrt(torch.clamp_min(1.0 - cphi * cphi, 0.0))
    rr = torch.exp(torch.log(torch.clamp_min(u3, 1e-30)) * (1.0 / 3.0))
    bx = rr * sphi * torch.cos(theta)
    by = rr * sphi * torch.sin(theta)
    bz = rr * cphi
    bnorm = 1.0 / torch.sqrt(torch.clamp_min(bx * bx + by * by + bz * bz,
                                             1e-30))
    sx, sy, sz = forward.normalize3(bx * bnorm, by * bnorm, bz * bnorm)
    t = torch.where(hit, best_t, 1.0)
    p = (ox + t * dx, oy + t * dy, oz + t * dz)
    ray2 = tuple(torch.where(iso, a, r) for a, r in zip((*p, sx, sy, sz),
                                                        ray2))
    tput2 = [torch.where(iso, tp * a, t2)
             for tp, a, t2 in zip(tput, w[5:8], tput2)]
    return ray2, tput2, col2, scat | iso, iso


def trace_lanes(low: Lowered, med: Media, cam: torch.Tensor,
                pid: torch.Tensor, samp: torch.Tensor, *, width: int,
                seed: int, max_bounces: int):
    """(N, 3) colour of the lanes (pixel id `pid`, sample id `samp`), the
    segments they executed and those that ended in a medium, on the
    device and in the dtype of `cam`."""
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
    ray = (*o, *forward.normalize3(*t))
    one = torch.ones(pid.shape[0], dtype=dt, device=pid.device)
    tput = [one, one, one]
    col = [torch.zeros_like(one) for _ in range(3)]
    alive = torch.ones(pid.shape[0], dtype=torch.bool, device=pid.device)
    segments = scatters = 0
    for b in range(max_bounces):
        segments += int(alive.sum())
        best, hit, w = closest_hit(low, med, (seed, pid, samp, b), *ray)
        uu = rng.uniform4(seed, pid, samp, 1 + b, dt)
        ray, tput, col, alive, iso = shade(ray, tput, col, alive, best, hit,
                                           w, uu, bg, low.has_met,
                                           low.has_die)
        scatters += int(iso.sum())
        if not bool(alive.any()):
            break
    return torch.stack(col, -1), segments, scatters


def render_pixels(low: Lowered, med: Media, cam: torch.Tensor,
                  pixels: torch.Tensor, *, width: int, spp: int, seed: int,
                  max_bounces: int, lane_chunk: int = 0):
    """(P, 3) linear radiance of the flat pixel ids `pixels` over samples
    [0, spp), the mean segments a camera ray executed, and the share of
    all segments that ended in a medium. Lanes go in chunks of whole
    pixels (`lane_chunk` lanes at most; 0 keeps each candidate matrix
    within forward.CANDIDATE_BUDGET elements)."""
    dev = cam.device
    rows = max(1, low.n_sph + low.n_quad + med.n)
    lanes = lane_chunk or max(spp, forward.CANDIDATE_BUDGET // rows)
    per = max(1, lanes // spp)
    inv = float(np.float32(1.0 / spp))
    out, segments, scatters = [], 0, 0
    for p0 in range(0, pixels.shape[0], per):
        pid = pixels[p0:p0 + per].to(dev, torch.int64)
        n = pid.shape[0]
        lane_pid = pid.repeat_interleave(spp)
        lane_s = torch.arange(spp, dtype=torch.int64, device=dev).repeat(n)
        col, seg, sc = trace_lanes(low, med, cam, lane_pid, lane_s,
                                   width=width, seed=seed,
                                   max_bounces=max_bounces)
        col = col.view(n, spp, 3)
        acc = torch.zeros((n, 3), dtype=cam.dtype, device=dev)
        for s in range(spp):
            acc = acc + col[:, s]
        out.append(acc * inv)
        segments += seg
        scatters += sc
    return (torch.cat(out), segments / (pixels.shape[0] * spp),
            scatters / max(segments, 1))
