"""Forward megakernels: the shared per-pixel sampler, the classic-layout
kernel (K2) and the scene-bound renderer.

`shade_bounce` is the plain PyTorch twin of one bounce of the JAX
package's `megakernel._shade_bounce` (emission / background, the material
scatter lobes, throughput update), written op for op in the same order so
that the twins, the JAX kernels and the CUDA kernels (csrc/common.cuh)
run the same arithmetic per pixel. It works on tensors of any one shape.
`lockstep_render` is the sample and bounce loop both twins share, and
`dense_closest_hit` their closest-hit search.

`render_flat` is the wrapper of K2, the port of the JAX package's
`megakernel._make_kernel` (ops/megakernel.py:489) in its default regen
mode: the same sampler as the packed kernel over the compacted scene rows
of `scene_table.lower_flat`, for scenes of any size, with an optional
per-block AABB cull of the sphere rows. On a CPU tensor it runs
`render_flat_reference`, the plain twin; on a CUDA tensor it launches
csrc/megakernel.cu and raises if the launch fails. `render_flat.launches`
counts kernel launches.

`MegakernelRenderer` binds a scene and camera and renders (H, W, 3)
linear radiance: scenes of at most PACKED_MAX_PRIMS real primitives
through the packed kernel (ops/megakernel_packed.py), larger ones through
K2, as the JAX package routes them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.world import SceneArrays
from tinyraytracer_tpu_torch.ops import rng, scene_table

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

# Most elements of one candidate matrix (rows x pixels) the twin builds
# when no pixel chunk is given (16 MiB of f32 per intermediate).
CANDIDATE_BUDGET = 1 << 22


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
                 has_met=True, has_die=True):
    """One bounce's shading given the winner payload (cpu.rs:47-62).

    `w_a*` is the normal source: the quad's unit plane normal when
    `w_isq > 0.5`, the sphere center otherwise. `u1..u4` are this
    bounce's scatter uniforms. `bg` is the (r, g, b) background as 0-dim
    f32 tensors; `bg2`, when given, the top of a gradient sky lerped on
    the miss direction's y. `has_met`/`has_die` False drop a material
    kind's lobe, which no winner select can then take (value-preserving).
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
    sx, sy, sz = normalize3(sx, sy, sz)

    absorbed = w_kind >= 2.5          # LIGHT = 3
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


def dense_closest_hit(sph: torch.Tensor, quad: torch.Tensor,
                      pay: torch.Tensor):
    """Closest hit over a dense (rows, pixels) candidate matrix.

    `sph` is (S, 4+) with (cx, cy, cz, r^2) first, `quad` (Q, 12+) with
    (n, n.corner, av, ca, bv, cb) first, both real rows only; `pay` is
    (S + Q, 13): is_quad, normal source (3), kind, albedo (3), fuzz, ior,
    emission (3). argmin's first index over spheres-then-quads is the
    kernels' strict-`<` running minimum over the same order. Returns
    f(ox, oy, oz, dx, dy, dz) -> (best t, hit, 13 payload columns, all
    zero on a miss)."""
    n_sph, n_quad = sph.shape[0], quad.shape[0]

    def closest_hit(ox, oy, oz, dx, dy, dz):
        ts = []
        if n_sph:
            ts.append(sphere_ts(sph, ox, oy, oz, dx, dy, dz))
        if n_quad:
            # plane + planar coordinates, half-open [0, 1) (quad.rs:33-54)
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
            ts.append(torch.where(ok, tq, MISS))
        ts = torch.cat(ts, 0)
        win = torch.argmin(ts, 0)
        best = ts.gather(0, win[None])[0]
        hit = best < MISS
        w = torch.where(hit[:, None], pay[win], 0.0)
        return best, hit, w.unbind(1)

    return closest_hit


def lockstep_render(cam: torch.Tensor, closest_hit, *, width: int,
                    height: int, spp: int, max_bounces: int, seed: int,
                    spp_offset: int, has_met: bool, has_die: bool,
                    sky: bool, pixel_chunk: int = 0) -> torch.Tensor:
    """The twins' sampler: (H, W, 3) f32 mean radiance over samples
    [spp_offset, spp_offset + spp).

    Lockstep sample and bounce loops with every pixel of a chunk a lane.
    A pixel whose path ended adds +0.0 until its sample is folded, exactly
    as a lane of the JAX regeneration loop does, so each pixel sees the
    kernels' op sequence; chunking the pixels changes no bit.
    `closest_hit(ox, oy, oz, dx, dy, dz)` returns (best t, hit, the 13
    payload columns of `dense_closest_hit`). `pixel_chunk` 0 takes all
    pixels at once.
    """
    dev = cam.device
    n = width * height
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
        pid = torch.arange(p0, min(p0 + step, n), dtype=torch.int64,
                           device=dev)
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
                best, hit, w = closest_hit(ox, oy, oz, dx, dy, dz)
                u1, u2, u3, u4 = rng.uniform4(seed, pid, samp, 1 + b)
                (ox, oy, oz, dx, dy, dz, *tput, c_r, c_g, c_b,
                 alive_f) = shade_bounce(
                    ox, oy, oz, dx, dy, dz, *tput, *col, alive, best, hit,
                    *w, u1, u2, u3, u4, bg, bg2, has_met=has_met,
                    has_die=has_die)
                col = [c_r, c_g, c_b]
                alive = alive_f > 0.5
                if not bool(alive.any()):
                    break
            acc = [a + x for a, x in zip(acc, col)]
        out[p0:p0 + pid.shape[0]] = torch.stack([a * inv for a in acc], -1)
    return out.view(height, width, 3)


def launch_forward(lib, device, width: int, height: int, spp: int,
                   split_query, launch):
    """Runs one forward kernel (K1 or K2) and returns (out, CUDA error).

    `split_query()` returns the kernel's sample split for this image (see
    csrc/common.cuh, `sample_split`), or minus a CUDA error;
    `launch(out, samples, split, inv_spp, stream)` makes the kernel's own
    call with data pointers as ints. With more than one sample part per
    pixel, the kernel writes each sample's colour to a (spp, H * W, 3)
    scratch and a second kernel folds them in sample order, so the image
    has the same bits."""
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    inv = float(np.float32(1.0 / spp))
    with torch.cuda.device(device):
        split = split_query()
        if split < 1:
            return out, -split
        samples = (torch.empty((spp, height * width, 3), dtype=torch.float32,
                               device=device) if split > 1 else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(out.data_ptr(),
                     None if samples is None else samples.data_ptr(), split,
                     inv, stream)
        if err == 0 and samples is not None:
            err = lib.tinyrt_fold_samples(samples.data_ptr(), out.data_ptr(),
                                          height * width, spp, inv, stream)
    return out, err


# --- K2: the classic-layout megakernel ------------------------------------

def _check_flat(sph, quad, pay, cam, aabbs, n_sph, n_quad, width, height,
                spp, max_bounces):
    ts = dict(sph=sph, quad=quad, pay=pay, cam=cam)
    if aabbs is not None:
        ts["aabbs"] = aabbs
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
    if not (0 <= n_sph <= ns and 0 <= n_quad <= nq and n_sph + n_quad):
        raise ValueError(f"{n_sph} spheres and {n_quad} quads do not fit "
                         f"{ns} sphere and {nq} quad rows")
    na = (ns if n_sph else 0) + (nq if n_quad else 0)
    if tuple(pay.shape) != (na, 16):
        raise ValueError(f"pay must be ({na}, 16), got {tuple(pay.shape)}")
    if tuple(cam.shape) != (32,):
        raise ValueError(f"cam must be (32,), got {tuple(cam.shape)}")
    if aabbs is not None:
        k = -(-ns // min(scene_table.ROW_CHUNK, ns))
        if tuple(aabbs.shape) != (k, 8):
            raise ValueError(f"aabbs must be ({k}, 8), got "
                             f"{tuple(aabbs.shape)}")
    if width < 2 or height < 2:
        raise ValueError(f"image must be at least 2x2, got {width}x{height}")
    if spp < 1 or max_bounces < 1:
        raise ValueError(f"spp={spp} and max_bounces={max_bounces} must "
                         "be >= 1")


def render_flat(sph: torch.Tensor, quad: torch.Tensor, pay: torch.Tensor,
                cam: torch.Tensor, aabbs: torch.Tensor | None = None, *,
                n_sph: int, n_quad: int, width: int, height: int, spp: int,
                max_bounces: int, seed: int = 0, spp_offset: int = 0,
                has_met: bool = True, has_die: bool = True,
                sky: bool = False, fmad: bool = False) -> torch.Tensor:
    """(H, W, 3) f32 mean radiance over samples [spp_offset,
    spp_offset + spp) on the device of `sph`.

    The inputs are `scene_table.FlatScene`'s arrays as tensors. With
    `aabbs` the kernel skips a block of ROW_CHUNK sphere rows when the
    pixel's ray does not enter the block's AABB before its best hit so
    far; the cull is exact, so the image is the same. `fmad=True` selects
    a build compiled with FMA contraction, for numerics comparisons only.
    The CPU twin ignores `aabbs` and `fmad`.
    """
    _check_flat(sph, quad, pay, cam, aabbs, n_sph, n_quad, width, height,
                spp, max_bounces)
    kw = dict(n_sph=n_sph, n_quad=n_quad, width=width, height=height,
              spp=spp, max_bounces=max_bounces, seed=seed,
              spp_offset=spp_offset, has_met=has_met, has_die=has_die,
              sky=sky)
    if sph.device.type == "cpu":
        return render_flat_reference(sph, quad, pay, cam, **kw)
    if sph.device.type != "cuda":
        raise ValueError(f"no megakernel for device {sph.device}")
    rows = [t for t in (sph, quad, pay, aabbs) if t is not None]
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError("sph, quad, pay and aabbs must be 16-byte aligned: "
                         "the kernel reads their rows as float4")
    lib = _build.load(fmad=fmad)
    ns = sph.shape[0]
    flags = (int(has_met), int(has_die), int(sky))

    def launch(out, samples, split, inv_spp, stream):
        return lib.tinyrt_megakernel_flat(
            cam.data_ptr(), sph.data_ptr(), n_sph, ns, quad.data_ptr(),
            n_quad, pay.data_ptr(), ns if n_sph else 0,
            aabbs.data_ptr() if aabbs is not None else None,
            aabbs.shape[0] if aabbs is not None else 0,
            min(scene_table.ROW_CHUNK, ns), out, samples, width, height,
            seed & 0xFFFFFFFF, spp_offset & 0xFFFFFFFF, spp, max_bounces,
            inv_spp, split, *flags, stream)

    out, err = launch_forward(
        lib, sph.device, width, height, spp,
        lambda: lib.tinyrt_megakernel_flat_split(width, height, spp, *flags),
        launch)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"megakernel_flat launch failed: CUDA error "
                           f"{err} ({msg})")
    render_flat.launches += 1
    return out


render_flat.launches = 0


def flat_closest_hit(sph: torch.Tensor, quad: torch.Tensor,
                     pay: torch.Tensor, n_sph: int, n_quad: int):
    """`dense_closest_hit` over the real rows of K2's inputs, the winner
    payload gathered from the (NA, 16) payload rows by index."""
    q0 = sph.shape[0] if n_sph else 0
    isq = pay[:, 0:1]
    pay13 = torch.cat([isq, torch.where(isq > 0.5, pay[:, 4:7], pay[:, 1:4]),
                       pay[:, 7:16]], 1)
    pay13 = torch.cat([pay13[:n_sph], pay13[q0:q0 + n_quad]], 0)
    return dense_closest_hit(sph[:n_sph], quad[:n_quad], pay13)


def render_flat_reference(sph: torch.Tensor, quad: torch.Tensor,
                          pay: torch.Tensor, cam: torch.Tensor, *,
                          n_sph: int, n_quad: int, width: int, height: int,
                          spp: int, max_bounces: int, seed: int = 0,
                          spp_offset: int = 0, has_met: bool = True,
                          has_die: bool = True, sky: bool = False,
                          pixel_chunk: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of K2 (no cull: the cull is exact, so this is
    what the culled and the unculled kernel are both held to).

    The closest hit is `flat_closest_hit`. Pixels go in chunks of
    `pixel_chunk` (0: as many as keep the candidate matrix within
    CANDIDATE_BUDGET elements)."""
    _check_flat(sph, quad, pay, cam, None, n_sph, n_quad, width, height,
                spp, max_bounces)
    if not pixel_chunk:
        pixel_chunk = max(1, CANDIDATE_BUDGET // (n_sph + n_quad))
    return lockstep_render(
        cam, flat_closest_hit(sph, quad, pay, n_sph, n_quad),
        width=width, height=height, spp=spp,
        max_bounces=max_bounces, seed=seed, spp_offset=spp_offset,
        has_met=has_met, has_die=has_die, sky=sky, pixel_chunk=pixel_chunk)


# --- the scene-bound renderer ---------------------------------------------

class MegakernelRenderer:
    """Scene-bound forward renderer: one kernel launch per image.

    `chunk_cull` (K2 only): None culls when the scene has more than
    AUTO_CULL_ROWS padded active rows and at least one sphere, as the JAX
    package does; True or False forces it. Host lowerings and their
    device copies are made at first use and kept.
    """

    def __init__(self, scene: SceneArrays, camera: Camera, background,
                 device, chunk_cull: bool | None = None):
        self.device = torch.device(device)
        self.scene = scene
        self.camera = camera
        self.background = background
        a = scene.numpy()
        self.n_sph = int(a["sph_valid"].sum())
        self.n_quad = int(a["quad_valid"].sum())
        if self.n_sph + self.n_quad == 0:
            raise ValueError("scene has no primitives")
        if chunk_cull is None:
            rows = ((scene_table.pad8(self.n_sph) if self.n_sph else 0)
                    + (scene_table.pad8(self.n_quad) if self.n_quad else 0))
            chunk_cull = rows > AUTO_CULL_ROWS
        self.chunk_cull = bool(chunk_cull) and self.n_sph > 0

    @functools.cached_property
    def lowered(self) -> scene_table.LoweredScene:
        """The packed kernel's host lowering."""
        return scene_table.lower(self.scene, self.camera, self.background)

    @functools.cached_property
    def table(self) -> torch.Tensor:
        return torch.from_numpy(self.lowered.table).to(self.device)

    @functools.cached_property
    def cam(self) -> torch.Tensor:
        return torch.from_numpy(self.lowered.cam).to(self.device)

    @functools.cached_property
    def flat(self) -> scene_table.FlatScene:
        """K2's host lowering."""
        return scene_table.lower_flat(self.scene, self.camera,
                                      self.background,
                                      chunk_cull=self.chunk_cull)

    @functools.cached_property
    def flat_tensors(self) -> dict:
        """K2's inputs on the renderer's device, keyed as `render_flat`
        takes them."""
        f = self.flat
        dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return dict(sph=dev(f.sph), quad=dev(f.quad), pay=dev(f.pay),
                    cam=dev(f.cam),
                    aabbs=None if f.aabbs is None else dev(f.aabbs))

    def flat_args(self, *, spp: int, max_bounces: int, seed: int = 0,
                  spp_offset: int = 0) -> dict:
        """Keyword arguments of `render_flat` for this scene."""
        f = self.flat
        return dict(self.flat_tensors, n_sph=f.n_sph, n_quad=f.n_quad,
                    width=self.camera.width, height=self.camera.height,
                    spp=spp, max_bounces=max_bounces, seed=seed,
                    spp_offset=spp_offset, has_met=f.has_met,
                    has_die=f.has_die, sky=f.sky)

    def render(self, *, spp: int, max_bounces: int, seed: int = 0,
               spp_offset: int = 0, packed: bool | None = None
               ) -> torch.Tensor:
        """(H, W, 3) f32 mean radiance over samples [spp_offset,
        spp_offset + spp), on the renderer's device. `packed` None takes
        the packed kernel for at most PACKED_MAX_PRIMS real primitives and
        K2 above (megakernel.py:1455-1466); True or False forces one."""
        from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp

        if packed is None:
            packed = self.n_sph + self.n_quad <= mkp.PACKED_MAX_PRIMS
        if not packed:
            return render_flat(**self.flat_args(
                spp=spp, max_bounces=max_bounces, seed=seed,
                spp_offset=spp_offset))
        low = self.lowered
        return mkp.render_packed(
            self.table, self.cam,
            n_sph=low.n_sph, n_quad=low.n_quad,
            width=self.camera.width, height=self.camera.height,
            spp=spp, max_bounces=max_bounces,
            seed=seed, spp_offset=spp_offset,
            has_met=low.has_met, has_die=low.has_die, sky=low.sky)


def render_image_megakernel(scene: SceneArrays, camera: Camera, *, spp: int,
                            max_bounces: int, background, device,
                            seed: int = 0,
                            packed: bool | None = None) -> torch.Tensor:
    """One-shot megakernel render. Returns (H, W, 3) linear radiance."""
    r = MegakernelRenderer(scene, camera, background, device)
    return r.render(spp=spp, max_bounces=max_bounces, seed=seed,
                    packed=packed)
