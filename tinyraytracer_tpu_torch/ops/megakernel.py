"""Forward megakernels: the shared per-pixel sampler, the classic-layout
kernel (K2) and the scene-bound renderer.

`shade_bounce` is the plain PyTorch twin of one bounce of the JAX
package's `megakernel._shade_bounce` (emission / background, the material
scatter lobes, throughput update), written op for op in the same order so
that the twins, the JAX kernels and the CUDA kernels (csrc/common.cuh)
run the same arithmetic per pixel. It works on tensors of any one shape.
`lockstep_render` is the sample and bounce loop both twins share, and
`dense_closest_hit` their closest-hit search.

Participating media (`ConstantMedium`, models/geometry.py) render on K2
alone, behind its HAS_MED flag: `medium_ts` is the medium's hit (the
boundary sphere's two roots, a free-flight distance from its own draw of
stream `medium_stream(b, k)`), which the closest hit takes over the
surfaces and the media together, and `shade_bounce(has_med=True)` adds
the isotropic lobe. Scenes without media run the same operations as
before, bit for bit.

`render_flat` is the wrapper of K2, the port of the JAX package's
`megakernel._make_kernel` (ops/megakernel.py:489) in its default regen
mode: the same sampler as the packed kernel over the compacted scene rows
of `scene_table.lower_flat`, for scenes of any size. Its closest-hit
search takes one of three routes: every real row (dense), the sphere rows
in blocks with a per-block AABB cull (`aabbs`), or a per-thread walk of a
threaded BVH over the rows (`nodes`). The cull and the walk select the
dense search's winner, exact ties included, for every ray whose hit
tests' own f32 rounding keeps a reported hit inside the row's box
(padded 5e-5 a side), so the image is the same bit for bit; a ray tested
from about a thousand units away can get a "hit" outside a small sphere
from the dense search that a box culls (PERF.md §6: one sample in 405
million at the final scene's full size). On a CPU tensor it runs
`render_flat_reference`, the plain (dense) twin; on a CUDA tensor it
launches csrc/megakernel.cu and raises if the launch fails. Each launch
adds one to the host counter `launches.render_flat`
(utils/profiling.py), and counts lanes as K1 does and, in the device
counters `walk_steps` and `walk_iters`, its closest-hit tests.

What bounds K2 on each route is in csrc/megakernel.cu's note: FP32
issue over the tests a ray runs. The walk runs a few dozen node and row
tests where the dense search runs every row, at a lower rate (dependent
node loads, lanes that disagree); it is the route from BVH_MIN_PRIMS real
primitives up. Above AUTO_CULL_ROWS padded rows K2 keeps the JAX
package's Morton order and block cull.

`MegakernelRenderer` binds a scene and camera and renders (H, W, 3)
linear radiance: scenes of at most PACKED_MAX_PRIMS real primitives
through the packed kernel (ops/megakernel_packed.py), larger ones through
K2, as the JAX package routes them, and picks K2's route from the
scene's primitive and row counts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.world import SceneArrays
from tinyraytracer_tpu_torch.ops import rng, scene_table
from tinyraytracer_tpu_torch.utils import profiling

T_MIN = 1.0e-3      # sampler/cpu.rs:48
MISS = 3.0e38
TWO_PI = 6.283185307179586   # used as f32: 6.2831855

# The JAX package culls row blocks when the scene has more padded active
# rows than its dense kernel fits at the 128-lane floor:
# `auto_tile_rays(n_rows) == 0` means n_rows * 128 > 512 * 1024
# (megakernel.py:67, MAX_ROWS_X_TILE). Its VMEM model is not ported; this
# one threshold is, so that both packages Morton-order the rows of the
# same scenes: row order decides exact ties.
AUTO_CULL_ROWS = 4096

# K2 walks a BVH from this many real primitives up, to the cull's
# AUTO_CULL_ROWS: on the H100 the walk beat the dense search at every
# size of the sweep (PERF.md §6: 49-500 spheres, 1.5-7.5x), whose
# smallest is K2's smallest scene by the packed route's rule; smaller
# scenes forced onto K2 keep the dense search.
BVH_MIN_PRIMS = 49

# Most elements of one candidate matrix (rows x pixels) the twin builds
# when no pixel chunk is given (16 MiB of f32 per intermediate).
CANDIDATE_BUDGET = 1 << 22

# A medium's free-flight draw: stream MEDIUM_STREAM | k << 16 | b for the
# medium of ordinal k at bounce b of a sample, outside the streams 0 (the
# camera ray) and 1 + b (the scatter) of any budget below 2^31, so a
# scene without media keeps every draw. b and k must fit their fields.
MEDIUM_STREAM = 0x80000000
MAX_MEDIUM_BOUNCES = 1 << 16
MAX_MEDIA = 1 << 15


def medium_stream(b: int, k: int) -> int:
    """The PCG4D stream of medium k's draw at bounce b (csrc/common.cuh,
    `medium_stream`)."""
    return MEDIUM_STREAM | (k << 16) | b


def normalize3(x, y, z):
    """Unit vector with a 1e-30 floor on the squared length. 1/sqrt is
    correctly rounded in both steps; the JAX kernels' rsqrt differs from
    it by up to 2 ulp."""
    inv = 1.0 / torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def _pow5(x):
    # XLA's integer_pow(x, 5): x2 = x*x, x4 = x2*x2, x4*x
    x2 = x * x
    x4 = x2 * x2
    return x4 * x


def shade_bounce(ox, oy, oz, dx, dy, dz,
                 tput_r, tput_g, tput_b, col_r, col_g, col_b,
                 alive, best_t, hit,
                 w_isq, w_ax, w_ay, w_az, w_kind,
                 w_ar, w_ag, w_ab, w_fuzz, w_ior, w_er, w_eg, w_eb,
                 u1, u2, u3, u4, bg, bg2=None,
                 has_met=True, has_die=True, has_med=False):
    """One bounce's shading given the winner payload (cpu.rs:47-62).

    `w_a*` is the normal source: the quad's unit plane normal when
    `w_isq > 0.5`, the sphere center otherwise. `u1..u4` are this
    bounce's scatter uniforms. `bg` is the (r, g, b) background as 0-dim
    f32 tensors; `bg2`, when given, the top of a gradient sky lerped on
    the miss direction's y. `has_met`/`has_die` False drop a material
    kind's lobe, which no winner select can then take (value-preserving).
    `has_med` adds the isotropic lobe of a medium's winner (kind
    ISOTROPIC): the Lambertian's unit vector alone, never absorbed.
    Returns the post-bounce (o, d, throughput, color, alive_f) state.
    """
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
    # hittable/mod.rs:34-40 face flip
    front = (dx * onx + dy * ony + dz * onz) < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx_ = onx * sgn
    ny_ = ony * sgn
    nz_ = onz * sgn

    bg_r, bg_g, bg_b = bg
    if bg2 is not None:
        tmix = 0.5 * (dy + 1.0)
        bg_r = bg_r + tmix * (bg2[0] - bg_r)
        bg_g = bg_g + tmix * (bg2[1] - bg_g)
        bg_b = bg_b + tmix * (bg2[2] - bg_b)
    mlf = miss_live.to(torch.float32)
    hlf = hit_live.to(torch.float32)
    col_r = col_r + mlf * tput_r * bg_r + hlf * tput_r * w_er
    col_g = col_g + mlf * tput_g * bg_g + hlf * tput_g * w_eg
    col_b = col_b + mlf * tput_b * bg_b + hlf * tput_b * w_eb

    # uniform in unit ball, inverse CDF (vec3extend.rs:15-30)
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
    # Lambertian degenerate-direction fallback (lambertian.rs:16-22)
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
        # metal fuzz (metal.rs:18-25)
        mx = rx + w_fuzz * bx
        my = ry + w_fuzz * by
        mz = rz + w_fuzz * bz
    if has_die:
        # dielectric (dielectric.rs:26-46)
        eta = torch.where(front, 1.0 / w_ior, w_ior)
        cos = torch.clamp_max(-(nx_ * dx + ny_ * dy + nz_ * dz), 1.0)
        sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, 0.0))
        tir = eta * sin > 1.0
        sr0 = (1.0 - eta) / (1.0 + eta)
        r0 = sr0 * sr0
        refl = r0 + (1.0 - r0) * _pow5(1.0 - cos)
        choose_reflect = tir | (refl > u4)
        # refract (vec3extend.rs:79-84), 1e-12 floor at grazing incidence
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
        sx = torch.where(is_lam, lx, mx)
        sy = torch.where(is_lam, ly, my)
        sz = torch.where(is_lam, lz, mz)
    elif has_die:
        sx = torch.where(is_lam, lx, gx)
        sy = torch.where(is_lam, ly, gy)
        sz = torch.where(is_lam, lz, gz)
    else:
        sx, sy, sz = lx, ly, lz
    if has_med:
        # isotropic phase (a medium's winner): a uniform unit vector
        is_iso = w_kind > 3.5
        sx = torch.where(is_iso, bx * bnorm, sx)
        sy = torch.where(is_iso, by * bnorm, sy)
        sz = torch.where(is_iso, bz * bnorm, sz)
    sx, sy, sz = normalize3(sx, sy, sz)

    absorbed = w_kind >= 2.5          # LIGHT = 3
    if has_med:
        absorbed = absorbed & ~is_iso
    scat = hit_live & ~absorbed
    sf = scat.to(torch.float32)
    inv_sf = 1.0 - sf
    tput_r = tput_r * (inv_sf + sf * w_ar)
    tput_g = tput_g * (inv_sf + sf * w_ag)
    tput_b = tput_b * (inv_sf + sf * w_ab)
    ox = torch.where(scat, p_x, ox)
    oy = torch.where(scat, p_y, oy)
    oz = torch.where(scat, p_z, oz)
    dx = torch.where(scat, sx, dx)
    dy = torch.where(scat, sy, dy)
    dz = torch.where(scat, sz, dz)
    return (ox, oy, oz, dx, dy, dz,
            tput_r, tput_g, tput_b, col_r, col_g, col_b, sf)


def sphere_ts(sph: torch.Tensor, ox, oy, oz, dx, dy, dz) -> torch.Tensor:
    """(S, P) hit distances of rays (P,) against spheres `sph` (S, 4+):
    the near root, else the far one, at t >= T_MIN; MISS when neither
    (sphere.rs:29-54)."""
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


def quad_ts(quad: torch.Tensor, ox, oy, oz, dx, dy, dz) -> torch.Tensor:
    """(Q, P) hit distances of rays (P,) against quads `quad` (Q, 12+):
    (n, n.corner, av, ca, bv, cb); the plane's t where the planar
    coordinates fall in the half-open [0, 1), t >= T_MIN; MISS otherwise
    (quad.rs:33-54). The twin of common.cuh's quad_hit_t."""
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


def medium_ts(med: torch.Tensor, ox, oy, oz, dx, dy, dz,
              u: torch.Tensor) -> torch.Tensor:
    """(D, P) hit distances of rays (P,) in the media `med` (D, 5+):
    (cx, cy, cz, r^2, -1/density) of the boundary sphere, `u` (D, P) each
    medium's uniform. t1, t2 are the boundary's roots over the whole line,
    t1 raised to T_MIN; the hit is t1 + (-1/density) ln(u) / |d| where it
    lies below t2 (u = 0 gives +inf: no hit); MISS where the line misses
    the sphere or t1 >= t2 (models/geometry.py: the book's
    `constant_medium::hit` and its departures). The twin of common.cuh's
    medium_hit_t, which skips the draw where t1 is not below the best
    hit so far: such a medium cannot win."""
    ocx = ox - med[:, 0:1]
    ocy = oy - med[:, 1:2]
    ocz = oz - med[:, 2:3]
    half_b = ocx * dx + ocy * dy + ocz * dz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - med[:, 3:4]
    disc = half_b * half_b - c_term
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_in = torch.clamp_min(-half_b - sq, T_MIN)
    t_out = -half_b + sq
    length = torch.sqrt(dx * dx + dy * dy + dz * dz)
    th = t_in + med[:, 4:5] * torch.log(u) / length
    ok = (disc >= 0.0) & (t_in < t_out) & (th < t_out)
    return torch.where(ok, th, MISS)


def dense_closest_hit(sph: torch.Tensor, quad: torch.Tensor,
                      pay: torch.Tensor, med: torch.Tensor | None = None):
    """Closest hit over a dense (rows, pixels) candidate matrix.

    `sph` is (S, 4+) with (cx, cy, cz, r^2) first, `quad` (Q, 12+) with
    (n, n.corner, av, ca, bv, cb) first, both real rows only, `med`
    (D, 5+) the media (`medium_ts`) or None; `pay` is (S + Q + D, 13):
    is_quad, normal source (3), kind, albedo (3), fuzz, ior, emission
    (3). argmin's first index over spheres, then quads, then media is the
    kernels' strict-`<` running minimum over the same order. Returns
    f(ox, oy, oz, dx, dy, dz, key=None) -> (best t, hit, 13 payload
    columns, all zero on a miss); with media, `key` (seed, pixel ids,
    sample id, bounce) draws each medium's uniform."""
    n_sph, n_quad = sph.shape[0], quad.shape[0]
    n_med = 0 if med is None else med.shape[0]

    def closest_hit(ox, oy, oz, dx, dy, dz, key=None):
        ts = []
        if n_sph:
            ts.append(sphere_ts(sph, ox, oy, oz, dx, dy, dz))
        if n_quad:
            ts.append(quad_ts(quad, ox, oy, oz, dx, dy, dz))
        if n_med:
            seed, pid, samp, b = key
            u = torch.stack([rng.uniform4(seed, pid, samp,
                                          medium_stream(b, k))[0]
                             for k in range(n_med)])
            ts.append(medium_ts(med, ox, oy, oz, dx, dy, dz, u))
        ts = torch.cat(ts, 0)
        win = torch.argmin(ts, 0)
        best = ts.gather(0, win[None])[0]
        hit = best < MISS
        w = torch.where(hit[:, None], pay[win], 0.0)
        return best, hit, w.unbind(1)

    return closest_hit


def pixel_range(width: int, height: int, pixels) -> tuple:
    """(begin, count) of the flat pixel ids a forward render covers:
    `pixels` (begin, count), a mesh shard's contiguous range, or None for
    the whole image. Raises unless the range is non-empty and in the
    image."""
    if pixels is None:
        return 0, width * height
    begin, count = (int(v) for v in pixels)
    if begin < 0 or count < 1 or begin + count > width * height:
        raise ValueError(f"pixels {tuple(pixels)} is not a range of a "
                         f"{width}x{height} image")
    return begin, count


def lockstep_render(cam: torch.Tensor, closest_hit, *, width: int,
                    height: int, spp: int, max_bounces: int, seed: int,
                    spp_offset: int, has_met: bool, has_die: bool,
                    sky: bool, pixel_chunk: int = 0,
                    pixels: tuple | None = None,
                    has_med: bool = False) -> torch.Tensor:
    """The twins' sampler: (H, W, 3) f32 mean radiance over samples
    [spp_offset, spp_offset + spp), or with `pixels` (begin, count) the
    (count, 3) radiance of those flat pixel ids.

    Lockstep sample and bounce loops with every pixel of a chunk a lane.
    A pixel whose path ended adds +0.0 until its sample is folded, exactly
    as a lane of the JAX regeneration loop does, so each pixel sees the
    kernels' op sequence; chunking the pixels changes no bit.
    `closest_hit(ox, oy, oz, dx, dy, dz)` returns (best t, hit, the 13
    payload columns of `dense_closest_hit`); with `has_med` it also takes
    `key=(seed, pixel ids, sample id, bounce)` and the shading adds the
    isotropic lobe. `pixel_chunk` 0 takes all pixels at once.
    """
    dev = cam.device
    begin, n = pixel_range(width, height, pixels)
    c = cam.unbind(0)     # 0-dim f32 tensors: scalar math stays in f32
    pos, ul, hor, ver = c[0:3], c[3:6], c[6:9], c[9:12]
    du, dv = c[12:15], c[15:18]
    inv_w1, inv_h1 = c[18], c[19]
    bg = c[20:23]
    bg2 = c[24:27] if sky else None
    inv = float(np.float32(1.0 / spp))
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    step = pixel_chunk or n
    for p0 in range(0, n, step):
        pid = torch.arange(begin + p0, begin + min(p0 + step, n),
                           dtype=torch.int64, device=dev)
        px = (pid % width).to(torch.float32)
        py = (pid // width).to(torch.float32)

        def gen_camera_ray(samp):
            r1, r2, r3, r4 = rng.uniform4(seed, pid, samp, 0)
            # pointgen.rs:41-42 (w-1)/(h-1) normalization
            u = (px + r1) * inv_w1
            v = (py + r2) * inv_h1
            # defocus disk, polar form (math/vec3extend.rs:45-53)
            rad = torch.sqrt(r3)
            th = TWO_PI * r4
            cth, sth = torch.cos(th), torch.sin(th)
            o = [pos[k] + rad * cth * du[k] + rad * sth * dv[k]
                 for k in range(3)]
            t = [ul[k] + u * hor[k] - v * ver[k] - o[k] for k in range(3)]
            return (*o, *normalize3(*t))

        one = torch.ones(pid.shape[0], dtype=torch.float32, device=dev)
        acc = [torch.zeros_like(one) for _ in range(3)]
        for s in range(spp):
            samp = (spp_offset + s) & 0xFFFFFFFF
            ox, oy, oz, dx, dy, dz = gen_camera_ray(samp)
            tput = [one, one, one]
            col = [torch.zeros_like(one) for _ in range(3)]
            alive = torch.ones(pid.shape[0], dtype=torch.bool, device=dev)
            for b in range(max_bounces):
                if has_med:
                    best, hit, w = closest_hit(ox, oy, oz, dx, dy, dz,
                                               key=(seed, pid, samp, b))
                else:
                    best, hit, w = closest_hit(ox, oy, oz, dx, dy, dz)
                u1, u2, u3, u4 = rng.uniform4(seed, pid, samp, 1 + b)
                (ox, oy, oz, dx, dy, dz, *tput, c_r, c_g, c_b,
                 alive_f) = shade_bounce(
                    ox, oy, oz, dx, dy, dz, *tput, *col, alive, best, hit,
                    *w, u1, u2, u3, u4, bg, bg2, has_met=has_met,
                    has_die=has_die, has_med=has_med)
                col = [c_r, c_g, c_b]
                alive = alive_f > 0.5
                if not bool(alive.any()):
                    break
            acc = [a + x for a, x in zip(acc, col)]
        out[p0:p0 + pid.shape[0]] = torch.stack([a * inv for a in acc], -1)
    return out if pixels is not None else out.view(height, width, 3)


def counts_ptr(device) -> int | None:
    """The device's counter buffer for a forward launch (K1 or K2) while a
    profiler records, else None: the kernel that does not count."""
    buf = profiling.device_counters(device)
    return None if buf is None else buf.data_ptr()


def launch_forward(lib, device, width: int, height: int, spp: int, pixels,
                   split_query, launch):
    """Runs one forward kernel (K1 or K2) over the flat pixel ids `pixels`
    (begin, count), or the whole image for None, and returns (out, CUDA
    error): out is (count, 3), or (H, W, 3) for the whole image.

    `split_query(rows)` returns the kernel's sample split for a grid over
    that many image rows, the rows the range spans (see csrc/common.cuh,
    `sample_split`), or minus a CUDA error; `launch(out, samples, split,
    inv_spp, pix0, npix, stream)` makes the kernel's own call with data
    pointers as ints. With more than one sample part per pixel, the kernel
    writes each sample's colour to a (spp, count, 3) scratch and a second
    kernel folds them in sample order, so the image has the same bits."""
    begin, n = pixel_range(width, height, pixels)
    shape = (n, 3) if pixels is not None else (height, width, 3)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    inv = float(np.float32(1.0 / spp))
    rows = (begin + n - 1) // width - begin // width + 1
    with torch.cuda.device(device):
        split = split_query(rows)
        if split < 1:
            return out, -split
        samples = (torch.empty((spp, n, 3), dtype=torch.float32,
                               device=device) if split > 1 else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(out.data_ptr(),
                     None if samples is None else samples.data_ptr(), split,
                     inv, begin, n, stream)
        if err == 0 and samples is not None:
            err = lib.tinyrt_fold_samples(samples.data_ptr(), out.data_ptr(),
                                          n, spp, inv, stream)
    return out, err


# --- K2: the classic-layout megakernel ------------------------------------

def _check_flat(sph, quad, pay, cam, aabbs, nodes, n_sph, n_quad, width,
                height, spp, max_bounces, med=None, n_med=0):
    ts = dict(sph=sph, quad=quad, pay=pay, cam=cam)
    if aabbs is not None:
        ts["aabbs"] = aabbs
    if nodes is not None:
        ts["nodes"] = nodes
    if med is not None:
        ts["med"] = med
    for name, t in ts.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype}")
        if t.device != sph.device:
            raise ValueError(f"{name} on {t.device}, sph on {sph.device}")
    if sph.dim() != 2 or sph.shape[1] != 4 or sph.shape[0] < 1:
        raise ValueError(f"sph must be (ns, 4), got {tuple(sph.shape)}")
    if quad.dim() != 2 or quad.shape[1] != 12 or quad.shape[0] < 1:
        raise ValueError(f"quad must be (nq, 12), got {tuple(quad.shape)}")
    ns, nq = sph.shape[0], quad.shape[0]
    if (med is None) != (n_med == 0) or (
            med is not None and tuple(med.shape) != (n_med, 8)):
        raise ValueError(f"med must be ({n_med}, 8) for {n_med} media, or "
                         f"None for none, got "
                         f"{None if med is None else tuple(med.shape)}")
    if n_med and not (n_med <= MAX_MEDIA
                      and max_bounces <= MAX_MEDIUM_BOUNCES):
        raise ValueError(f"{n_med} media over {max_bounces} bounces: the "
                         f"medium draws' streams take at most {MAX_MEDIA} "
                         f"media and {MAX_MEDIUM_BOUNCES} bounces")
    if not (0 <= n_sph <= ns and 0 <= n_quad <= nq
            and n_sph + n_quad + n_med):
        raise ValueError(f"{n_sph} spheres and {n_quad} quads do not fit "
                         f"{ns} sphere and {nq} quad rows")
    na = (ns if n_sph else 0) + (nq if n_quad else 0) + n_med
    if tuple(pay.shape) != (na, 16):
        raise ValueError(f"pay must be ({na}, 16), got {tuple(pay.shape)}")
    if tuple(cam.shape) != (32,):
        raise ValueError(f"cam must be (32,), got {tuple(cam.shape)}")
    if aabbs is not None:
        k = -(-ns // min(scene_table.ROW_CHUNK, ns))
        if tuple(aabbs.shape) != (k, 8):
            raise ValueError(f"aabbs must be ({k}, 8), got "
                             f"{tuple(aabbs.shape)}")
    if nodes is not None:
        m = 2 * (n_sph + n_quad + n_med) - 1
        if tuple(nodes.shape) != (m, 8):
            raise ValueError(f"nodes must be ({m}, 8), got "
                             f"{tuple(nodes.shape)}")
        if aabbs is not None:
            raise ValueError("K2 takes aabbs or nodes, not both")
    if width < 2 or height < 2:
        raise ValueError(f"image must be at least 2x2, got {width}x{height}")
    if spp < 1 or max_bounces < 1:
        raise ValueError(f"spp={spp} and max_bounces={max_bounces} must "
                         "be >= 1")


def render_flat(sph: torch.Tensor, quad: torch.Tensor, pay: torch.Tensor,
                cam: torch.Tensor, aabbs: torch.Tensor | None = None,
                nodes: torch.Tensor | None = None, *,
                n_sph: int, n_quad: int, width: int, height: int, spp: int,
                max_bounces: int, seed: int = 0, spp_offset: int = 0,
                has_met: bool = True, has_die: bool = True,
                sky: bool = False, fmad: bool = False,
                pixels: tuple | None = None,
                med: torch.Tensor | None = None,
                n_med: int = 0) -> torch.Tensor:
    """(H, W, 3) f32 mean radiance over samples [spp_offset,
    spp_offset + spp) on the device of `sph`; with `pixels` (begin,
    count), the (count, 3) radiance of those flat pixel ids (a mesh
    shard's range).

    The inputs are `scene_table.FlatScene`'s arrays as tensors. With
    `aabbs` the kernel skips a block of ROW_CHUNK sphere rows when the
    pixel's ray does not enter the block's AABB before its best hit so
    far; with `nodes` (`scene_table.bvh_nodes`, whose links and rows the
    kernel trusts) each thread walks the BVH instead of the rows. Both
    select the dense search's winner (see the module's docstring for
    the rounding limit), so the image is the same. `med` (n_med, 8), the
    media's rows (`scene_table.medium_rows`; their payload rows are the
    last n_med of `pay`), launches the HAS_MED kernel: every route then
    also tests the media (a medium is a leaf of the walk, with its
    boundary's box). `fmad=True` selects a build compiled with FMA
    contraction, for numerics comparisons only. The CPU twin ignores
    `aabbs`, `nodes` and `fmad`.
    """
    _check_flat(sph, quad, pay, cam, aabbs, nodes, n_sph, n_quad, width,
                height, spp, max_bounces, med, n_med)
    pixel_range(width, height, pixels)
    kw = dict(n_sph=n_sph, n_quad=n_quad, width=width, height=height,
              spp=spp, max_bounces=max_bounces, seed=seed,
              spp_offset=spp_offset, has_met=has_met, has_die=has_die,
              sky=sky, pixels=pixels, med=med, n_med=n_med)
    if sph.device.type == "cpu":
        return render_flat_reference(sph, quad, pay, cam, **kw)
    if sph.device.type != "cuda":
        raise ValueError(f"no megakernel for device {sph.device}")
    rows = [t for t in (sph, quad, pay, aabbs, nodes, med) if t is not None]
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError("sph, quad, pay, aabbs, nodes and med must be "
                         "16-byte aligned: the kernel reads their rows as "
                         "float4")
    lib = _build.load(fmad=fmad)
    ns = sph.shape[0]
    flags = (int(has_met), int(has_die), int(sky))
    counts = counts_ptr(sph.device)

    def launch(out, samples, split, inv_spp, pix0, npix, stream):
        return lib.tinyrt_megakernel_flat(
            cam.data_ptr(), sph.data_ptr(), n_sph, ns, quad.data_ptr(),
            n_quad, pay.data_ptr(), ns if n_sph else 0,
            aabbs.data_ptr() if aabbs is not None else None,
            aabbs.shape[0] if aabbs is not None else 0,
            min(scene_table.ROW_CHUNK, ns),
            nodes.data_ptr() if nodes is not None else None,
            nodes.shape[0] if nodes is not None else 0, out, samples, width,
            height, seed & 0xFFFFFFFF, spp_offset & 0xFFFFFFFF, spp,
            max_bounces, inv_spp, split, *flags, pix0, npix, counts, stream,
            med.data_ptr() if med is not None else None, n_med,
            pay.shape[0] - n_med)

    out, err = launch_forward(
        lib, sph.device, width, height, spp, pixels,
        lambda rows: lib.tinyrt_megakernel_flat_split(
            width, rows, spp, *flags, int(nodes is not None),
            int(med is not None)),
        launch)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"megakernel_flat launch failed: CUDA error "
                           f"{err} ({msg})")
    profiling.count("launches.render_flat")
    return out


def flat_closest_hit(sph: torch.Tensor, quad: torch.Tensor,
                     pay: torch.Tensor, n_sph: int, n_quad: int,
                     med: torch.Tensor | None = None, n_med: int = 0):
    """`dense_closest_hit` over the real rows of K2's inputs, the media's
    last, the winner payload gathered from the (NA, 16) payload rows by
    index."""
    q0 = sph.shape[0] if n_sph else 0
    isq = pay[:, 0:1]
    pay13 = torch.cat([isq, torch.where(isq > 0.5, pay[:, 4:7], pay[:, 1:4]),
                       pay[:, 7:16]], 1)
    m0 = pay.shape[0] - n_med
    pay13 = torch.cat([pay13[:n_sph], pay13[q0:q0 + n_quad],
                       pay13[m0:m0 + n_med]], 0)
    return dense_closest_hit(sph[:n_sph], quad[:n_quad], pay13, med)


def render_flat_reference(sph: torch.Tensor, quad: torch.Tensor,
                          pay: torch.Tensor, cam: torch.Tensor,
                          nodes: torch.Tensor | None = None, *,
                          n_sph: int, n_quad: int, width: int, height: int,
                          spp: int, max_bounces: int, seed: int = 0,
                          spp_offset: int = 0, has_met: bool = True,
                          has_die: bool = True, sky: bool = False,
                          pixel_chunk: int = 0,
                          pixels: tuple | None = None,
                          med: torch.Tensor | None = None,
                          n_med: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of K2, dense on every route: the cull and the
    BVH walk select the dense search's winner, so this is what the
    kernel is held to on all three, and `nodes` is checked and ignored.
    Over the whole image or the flat pixel ids `pixels` (begin, count).

    The closest hit is `flat_closest_hit`, with the media `med` last (the
    HAS_MED kernel's). Pixels go in chunks of `pixel_chunk` (0: as many
    as keep the candidate matrix within CANDIDATE_BUDGET elements)."""
    _check_flat(sph, quad, pay, cam, None, nodes, n_sph, n_quad, width,
                height, spp, max_bounces, med, n_med)
    if not pixel_chunk:
        pixel_chunk = max(1, CANDIDATE_BUDGET // (n_sph + n_quad + n_med))
    return lockstep_render(
        cam, flat_closest_hit(sph, quad, pay, n_sph, n_quad, med, n_med),
        width=width, height=height, spp=spp,
        max_bounces=max_bounces, seed=seed, spp_offset=spp_offset,
        has_met=has_met, has_die=has_die, sky=sky, pixel_chunk=pixel_chunk,
        pixels=pixels, has_med=med is not None)


# --- the scene-bound renderer ---------------------------------------------

class MegakernelRenderer:
    """Scene-bound forward renderer: one kernel launch per image, or per
    mesh cell with `render(mesh=)`.

    `device` defaults to the card, as every entry point of the port does:
    the reference's three-argument call binds the renderer to CUDA.
    Nothing is lowered onto it or launched before `render`.
    `chunk_cull` (K2 only): None culls when the scene has more than
    AUTO_CULL_ROWS padded active rows and at least one sphere, as the JAX
    package does; True or False forces it. `bvh` (K2 only, for tests):
    None walks a BVH when the scene has at least BVH_MIN_PRIMS real
    primitives and at most AUTO_CULL_ROWS padded rows, and the cull is
    not forced on; True or False forces it (True turns the automatic
    cull off; with a forced cull it raises). A ConstantMedium counts as a
    primitive and a row, and a scene with media renders on K2 whatever
    its size (K1 raises). Host lowerings and their device copies are made
    at first use and kept, one copy per device.
    """

    def __init__(self, scene: SceneArrays, camera: Camera, background,
                 device="cuda", chunk_cull: bool | None = None,
                 bvh: bool | None = None):
        self.device = torch.device(device)
        self.scene = scene
        self.camera = camera
        self.background = background
        a = scene.numpy()
        self.n_sph = int(a["sph_valid"].sum())
        self.n_quad = int(a["quad_valid"].sum())
        self.n_med = scene.num_media
        prims = self.n_sph + self.n_quad + self.n_med
        if prims == 0:
            raise ValueError("scene has no primitives")
        rows = ((scene_table.pad8(self.n_sph) if self.n_sph else 0)
                + (scene_table.pad8(self.n_quad) if self.n_quad else 0)
                + self.n_med)
        if bvh is None:
            bvh = (not chunk_cull and rows <= AUTO_CULL_ROWS
                   and prims >= BVH_MIN_PRIMS)
        if chunk_cull is None:
            chunk_cull = rows > AUTO_CULL_ROWS and not bvh
        self.bvh = bool(bvh)
        self.chunk_cull = bool(chunk_cull) and self.n_sph > 0
        if self.bvh and self.chunk_cull:
            raise ValueError("K2 takes the chunk cull or the BVH walk, not "
                             "both")
        self._copies: dict = {}

    @functools.cached_property
    def lowered(self) -> scene_table.LoweredScene:
        """The packed kernel's host lowering."""
        return scene_table.lower(self.scene, self.camera, self.background)

    @functools.cached_property
    def flat(self) -> scene_table.FlatScene:
        """K2's host lowering."""
        return scene_table.lower_flat(self.scene, self.camera,
                                      self.background,
                                      chunk_cull=self.chunk_cull,
                                      bvh=self.bvh)

    def _on(self, name: str, device, make):
        key = (name, torch.device(device))
        if key not in self._copies:
            self._copies[key] = make(torch.device(device))
        return self._copies[key]

    def packed_tensors(self, device) -> tuple:
        """(table, cam) of the packed kernel on `device`."""
        low = self.lowered
        return self._on("packed", device, lambda d: (
            torch.from_numpy(low.table).to(d),
            torch.from_numpy(low.cam).to(d)))

    @property
    def table(self) -> torch.Tensor:
        return self.packed_tensors(self.device)[0]

    @property
    def cam(self) -> torch.Tensor:
        return self.packed_tensors(self.device)[1]

    def flat_tensors_on(self, device) -> dict:
        """K2's inputs on `device`, keyed as `render_flat` takes them."""
        f = self.flat

        def make(d):
            def dev(a):
                return None if a is None else torch.from_numpy(a).to(d)

            return dict(sph=dev(f.sph), quad=dev(f.quad), pay=dev(f.pay),
                        cam=dev(f.cam), aabbs=dev(f.aabbs),
                        nodes=dev(f.nodes), med=dev(f.med))

        return self._on("flat", device, make)

    @property
    def flat_tensors(self) -> dict:
        """K2's inputs on the renderer's device."""
        return self.flat_tensors_on(self.device)

    def flat_args(self, *, spp: int, max_bounces: int, seed: int = 0,
                  spp_offset: int = 0, device=None,
                  pixels: tuple | None = None) -> dict:
        """Keyword arguments of `render_flat` for this scene, on `device`
        (default: the renderer's)."""
        f = self.flat
        return dict(self.flat_tensors_on(device or self.device),
                    n_sph=f.n_sph, n_quad=f.n_quad,
                    width=self.camera.width, height=self.camera.height,
                    spp=spp, max_bounces=max_bounces, seed=seed,
                    spp_offset=spp_offset, has_met=f.has_met,
                    has_die=f.has_die, sky=f.sky, pixels=pixels,
                    n_med=f.n_med)

    def render_burst(self, *, spp: int, max_bounces: int, seeds,
                     **kw) -> torch.Tensor:
        """len(seeds) frames, (n, H, W, 3) f32 on the renderer's device;
        frame i is bit for bit `render(seed=seeds[i], **kw)`.

        The frames share this renderer's one lowering and launch back to
        back, one K1 or K2 launch per frame (per mesh cell with `mesh=`),
        with no host sync between them (megakernel.py:1434-1452, where
        JAX bakes the seeds into one program)."""
        with profiling.annotate("tinyrt.render"):
            frames = [self.render(spp=spp, max_bounces=max_bounces,
                                  seed=int(s), **kw).to(self.device)
                      for s in seeds]
            if not frames:
                return torch.zeros((0, self.camera.height,
                                    self.camera.width, 3),
                                   dtype=torch.float32, device=self.device)
            return torch.stack(frames)

    def render(self, *, spp: int, max_bounces: int, seed: int = 0,
               spp_offset: int = 0, packed: bool | None = None,
               mesh=None) -> torch.Tensor:
        """(H, W, 3) f32 mean radiance over samples [spp_offset,
        spp_offset + spp), on the renderer's device. `packed` None takes
        the packed kernel for at most PACKED_MAX_PRIMS real primitives and
        K2 above (megakernel.py:1455-1466), and K2 for a scene with media;
        True or False forces one (True raises on media).

        `mesh` (parallel/sharded.Mesh) renders cell by cell, one launch
        per cell on the cell's device, each over its tile's pixel range
        and its sample shard (megakernel.py:1298-1365); the image lands on
        `mesh.device`. Without one, the render is the one-cell mesh on the
        renderer's device: one launch over the whole image."""
        from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
        from tinyraytracer_tpu_torch.parallel import sharded

        if packed is None:
            packed = (self.n_sph + self.n_quad <= mkp.PACKED_MAX_PRIMS
                      and not self.n_med)
        if mesh is None:
            mesh = sharded.one_cell(self.device)
        w, h = self.camera.width, self.camera.height

        def part(device, begin, count, spp_part, offset):
            # the host lowering and its device copy, made at first use
            with profiling.annotate("tinyrt.render.lower"):
                if not packed:
                    args = self.flat_args(
                        spp=spp_part, max_bounces=max_bounces, seed=seed,
                        spp_offset=offset, device=device,
                        pixels=(begin, count))
                else:
                    low = self.lowered
                    table, cam = self.packed_tensors(device)
            with profiling.annotate("tinyrt.render.launch"):
                if not packed:
                    return render_flat(**args)
                return mkp.render_packed(
                    table, cam, n_sph=low.n_sph, n_quad=low.n_quad,
                    width=w, height=h, spp=spp_part,
                    max_bounces=max_bounces, seed=seed, spp_offset=offset,
                    has_met=low.has_met, has_die=low.has_die, sky=low.sky,
                    pixels=(begin, count))

        img = sharded.render_sharded(mesh, part, npix=w * h, spp=spp,
                                     spp_offset=spp_offset)
        return img.view(h, w, 3)


def render_image_megakernel(scene: SceneArrays, camera: Camera, *, spp: int,
                            max_bounces: int, background, device=None,
                            seed: int = 0, packed: bool | None = None,
                            mesh=None) -> torch.Tensor:
    """One-shot megakernel render. Returns (H, W, 3) linear radiance, on
    `device`, or with `mesh` sharded over it (megakernel.py:1475-1481);
    `device` then defaults to the mesh's."""
    if device is None:
        if mesh is None:
            raise ValueError("render_image_megakernel needs a device or a "
                             "mesh")
        device = mesh.device
    r = MegakernelRenderer(scene, camera, background, device)
    return r.render(spp=spp, max_bounces=max_bounces, seed=seed,
                    packed=packed, mesh=mesh)
