"""Packed path-tracing megakernel: the whole forward sampler in one launch.

Port of the JAX package's sublane-packed Pallas kernel
(ops/megakernel_packed.py:125, `_make_packed_kernel`), the forward path of
every scene with at most PACKED_MAX_PRIMS real primitives. Per pixel it
computes: jittered thin-lens camera ray; pcg4d uniforms keyed on (pixel,
sample, stream) with stream 0 for the camera ray and 1 + b at bounce b;
closest hit over spheres then quads with a strict `<` first minimum and
half-open quad bounds; the winner's payload; `shade_bounce`; and the mean
radiance over the samples.

`render_packed` is the wrapper. On a CPU tensor it runs
`render_packed_reference`, the plain PyTorch twin; on a CUDA tensor it
launches the hand-written CUDA kernel (csrc/megakernel_packed.cu), built
at first use, and raises if the launch fails. `render_packed.launches`
counts kernel launches.

The RNG keys off the pixel id alone, so how pixels map to threads or
lanes never changes the image: the TPU's (S, L) tiling is not carried
over, and both the twin and the kernel write (H, W, 3) directly.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.ops import rng
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops.scene_table import QUAD_STRIDE, SPH_STRIDE

# Most real primitives the packed route takes; larger scenes belong to the
# classic-layout kernel. The kernel itself loops over the table at run
# time and has no such limit.
PACKED_MAX_PRIMS = 48

_CAM_WORDS = 32


def _check(table, cam, n_sph, n_quad, width, height, spp, max_bounces):
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError(f"table must be 1-d float32, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if cam.dtype != torch.float32 or tuple(cam.shape) != (_CAM_WORDS,):
        raise ValueError(f"cam must be ({_CAM_WORDS},) float32, got "
                         f"{cam.dtype} {tuple(cam.shape)}")
    if cam.device != table.device:
        raise ValueError(f"cam on {cam.device}, table on {table.device}")
    if not (table.is_contiguous() and cam.is_contiguous()):
        raise ValueError("table and cam must be contiguous")
    if n_sph < 0 or n_quad < 0 or (
            n_sph * SPH_STRIDE + n_quad * QUAD_STRIDE > table.numel()):
        raise ValueError(f"{n_sph} spheres + {n_quad} quads do not fit a "
                         f"table of {table.numel()} words")
    if width < 2 or height < 2:
        raise ValueError(f"image must be at least 2x2, got {width}x{height}")
    if spp < 1 or max_bounces < 1:
        raise ValueError(f"spp={spp} and max_bounces={max_bounces} must "
                         "be >= 1")


def render_packed(table: torch.Tensor, cam: torch.Tensor, *, n_sph: int,
                  n_quad: int, width: int, height: int, spp: int,
                  max_bounces: int, seed: int = 0, spp_offset: int = 0,
                  has_met: bool = True, has_die: bool = True,
                  sky: bool = False, fmad: bool = False) -> torch.Tensor:
    """(H, W, 3) f32 mean radiance over samples [spp_offset,
    spp_offset + spp) on the device of `table`.

    `table` is the scene table (scene_table.scene_table, flattened), `cam`
    the 32-word camera vector. `has_met`/`has_die`/`sky` specialise the
    kernel. `fmad=True` selects a build of the kernel compiled with FMA
    contraction, for numerics comparisons only; the CPU twin ignores it.
    """
    _check(table, cam, n_sph, n_quad, width, height, spp, max_bounces)
    kw = dict(n_sph=n_sph, n_quad=n_quad, width=width, height=height,
              spp=spp, max_bounces=max_bounces, seed=seed,
              spp_offset=spp_offset, has_met=has_met, has_die=has_die,
              sky=sky)
    if table.device.type == "cpu":
        return render_packed_reference(table, cam, **kw)
    if table.device.type != "cuda":
        raise ValueError(f"no megakernel for device {table.device}")
    lib = _build.load(fmad=fmad)
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.tinyrt_megakernel_packed(
            cam.data_ptr(), table.data_ptr(), table.numel(), n_sph, n_quad,
            out.data_ptr(), width, height,
            seed & 0xFFFFFFFF, spp_offset & 0xFFFFFFFF, spp, max_bounces,
            float(np.float32(1.0 / spp)),
            int(has_met), int(has_die), int(sky), stream)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"megakernel_packed launch failed: CUDA error "
                           f"{err} ({msg})")
    render_packed.launches += 1
    return out


render_packed.launches = 0


def render_packed_reference(table: torch.Tensor, cam: torch.Tensor, *,
                            n_sph: int, n_quad: int, width: int,
                            height: int, spp: int, max_bounces: int,
                            seed: int = 0, spp_offset: int = 0,
                            has_met: bool = True, has_die: bool = True,
                            sky: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, vectorised over all pixels.

    The same sample and bounce loops as the kernel, with every pixel of
    the image a lane. A pixel whose path ended adds +0.0 until its sample
    is folded, exactly as a lane of the JAX regeneration loop does, so each
    pixel sees the kernel's op sequence. The primitive axis is vectorised
    too: argmin's first-index rule over the stacked hit distances is the
    strict-`<` running minimum over the same order.
    """
    _check(table, cam, n_sph, n_quad, width, height, spp, max_bounces)
    dev = table.device
    n = width * height
    pid = torch.arange(n, dtype=torch.int64, device=dev)
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)
    c = cam.unbind(0)     # 0-dim f32 tensors: scalar math stays in f32
    pos, ul, hor, ver = c[0:3], c[3:6], c[6:9], c[9:12]
    du, dv = c[12:15], c[15:18]
    inv_w1, inv_h1 = c[18], c[19]
    bg = c[20:23]
    bg2 = c[24:27] if sky else None

    sph = table[: n_sph * SPH_STRIDE].view(n_sph, SPH_STRIDE)
    quad = table[n_sph * SPH_STRIDE:
                 n_sph * SPH_STRIDE + n_quad * QUAD_STRIDE].view(
                     n_quad, QUAD_STRIDE)
    # winner payload per primitive, table order: isq, normal source (3),
    # kind, albedo (3), fuzz, ior, emit (3)
    pay = torch.cat([
        torch.cat([torch.zeros_like(sph[:, :1]), sph[:, 0:3], sph[:, 4:]], 1),
        torch.cat([torch.ones_like(quad[:, :1]), quad[:, 12:]], 1),
    ], 0)

    def closest_hit(ox, oy, oz, dx, dy, dz):
        ts = []
        if n_sph:
            # sphere quadratic, near-then-far root (sphere.rs:29-54)
            ocx = ox - sph[:, 0:1]
            ocy = oy - sph[:, 1:2]
            ocz = oz - sph[:, 2:3]
            half_b = ocx * dx + ocy * dy + ocz * dz
            c_term = ocx * ocx + ocy * ocy + ocz * ocz - sph[:, 3:4]
            disc = half_b * half_b - c_term
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            t0 = -half_b - sq
            t1 = -half_b + sq
            t = torch.where(t0 >= mk.T_MIN, t0,
                            torch.where(t1 >= mk.T_MIN, t1, mk.MISS))
            ts.append(torch.where(disc >= 0.0, t, mk.MISS))
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
            ok = (ok_den & (tq >= mk.T_MIN) & (al >= 0.0) & (al < 1.0)
                  & (be >= 0.0) & (be < 1.0))
            ts.append(torch.where(ok, tq, mk.MISS))
        ts = torch.cat(ts, 0)
        win = torch.argmin(ts, 0)
        best = ts.gather(0, win[None])[0]
        hit = best < mk.MISS
        w = torch.where(hit[:, None], pay[win], 0.0)
        return best, hit, w.unbind(1)

    def gen_camera_ray(samp):
        r1, r2, r3, r4 = rng.uniform4(seed, pid, samp, 0)
        # pointgen.rs:41-42 (w-1)/(h-1) normalization
        u = (px + r1) * inv_w1
        v = (py + r2) * inv_h1
        # defocus disk, polar form (math/vec3extend.rs:45-53)
        rad = torch.sqrt(r3)
        th = mk.TWO_PI * r4
        cth, sth = torch.cos(th), torch.sin(th)
        o = [pos[k] + rad * cth * du[k] + rad * sth * dv[k] for k in range(3)]
        t = [ul[k] + u * hor[k] - v * ver[k] - o[k] for k in range(3)]
        return (*o, *mk.normalize3(*t))

    one = torch.ones(n, dtype=torch.float32, device=dev)
    acc = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3)]
    for s in range(spp):
        samp = (spp_offset + s) & 0xFFFFFFFF
        ox, oy, oz, dx, dy, dz = gen_camera_ray(samp)
        tput = [one, one, one]
        col = [torch.zeros_like(one) for _ in range(3)]
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for b in range(max_bounces):
            best, hit, w = closest_hit(ox, oy, oz, dx, dy, dz)
            u1, u2, u3, u4 = rng.uniform4(seed, pid, samp, 1 + b)
            (ox, oy, oz, dx, dy, dz, *tput, c_r, c_g, c_b,
             alive_f) = mk.shade_bounce(
                ox, oy, oz, dx, dy, dz, *tput, *col, alive, best, hit, *w,
                u1, u2, u3, u4, bg, bg2, has_met=has_met, has_die=has_die)
            col = [c_r, c_g, c_b]
            alive = alive_f > 0.5
            if not bool(alive.any()):
                break
        acc = [a + x for a, x in zip(acc, col)]
    inv = float(np.float32(1.0 / spp))
    return torch.stack([a * inv for a in acc], -1).view(height, width, 3)
