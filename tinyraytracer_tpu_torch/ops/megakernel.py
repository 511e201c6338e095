"""Forward megakernel: one bounce's shading and the scene-bound renderer.

`shade_bounce` is the plain PyTorch twin of one bounce of the JAX
package's `megakernel._shade_bounce` (emission / background, the material
scatter lobes, throughput update), written op for op in the same order so
that the twin, the JAX kernels and the CUDA kernel
(csrc/megakernel_packed.cu) run the same arithmetic per pixel. It works on
tensors of any one shape.

`MegakernelRenderer` binds a scene and camera and renders (H, W, 3)
linear radiance through the packed megakernel (ops/megakernel_packed.py):
on a CUDA device the hand-written kernel, on the CPU its plain twin. Only
the packed route (scenes of at most PACKED_MAX_PRIMS real primitives) is
ported; larger scenes need the classic-layout kernel, which is not.
"""

from __future__ import annotations

import torch

from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.world import SceneArrays
from tinyraytracer_tpu_torch.ops import scene_table

T_MIN = 1.0e-3      # sampler/cpu.rs:48
MISS = 3.0e38
TWO_PI = 6.283185307179586   # used as f32: 6.2831855


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


class MegakernelRenderer:
    """Scene-bound forward renderer: one kernel launch per image."""

    def __init__(self, scene: SceneArrays, camera: Camera, background,
                 device):
        # deferred: megakernel_packed imports this module's shading
        from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp

        self.device = torch.device(device)
        self.camera = camera
        low = scene_table.lower(scene, camera, background)
        n_real = low.n_sph + low.n_quad
        if n_real == 0:
            raise ValueError("scene has no primitives")
        if n_real > mkp.PACKED_MAX_PRIMS:
            raise NotImplementedError(
                f"scene has {n_real} primitives; scenes above "
                f"{mkp.PACKED_MAX_PRIMS} need the classic-layout megakernel "
                "(K2, ops/megakernel.py:_make_kernel), which is not ported "
                "yet")
        self.lowered = low
        self.table = torch.from_numpy(low.table).to(self.device)
        self.cam = torch.from_numpy(low.cam).to(self.device)

    def render(self, *, spp: int, max_bounces: int, seed: int = 0,
               spp_offset: int = 0) -> torch.Tensor:
        """(H, W, 3) f32 mean radiance over samples [spp_offset,
        spp_offset + spp), on the renderer's device."""
        from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp

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
                            seed: int = 0) -> torch.Tensor:
    """One-shot megakernel render. Returns (H, W, 3) linear radiance."""
    r = MegakernelRenderer(scene, camera, background, device)
    return r.render(spp=spp, max_bounces=max_bounces, seed=seed)
