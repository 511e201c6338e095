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
at first use, and raises if the launch fails. Each launch adds one to
the host counter `launches.render_packed` (utils/profiling.py); while a
profiler records, the counting kernel adds its lane segments and warp
passes to the device's counter buffer.

The RNG keys off the pixel id alone, so how pixels map to threads or
lanes never changes the image: the TPU's (S, L) tiling is not carried
over, and both the twin and the kernel write (H, W, 3) directly, or
(count, 3) for a range of flat pixel ids (`pixels`, a mesh shard's).
"""

from __future__ import annotations

import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops.scene_table import QUAD_STRIDE, SPH_STRIDE
from tinyraytracer_tpu_torch.utils import profiling

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
                  sky: bool = False, fmad: bool = False,
                  pixels: tuple | None = None) -> torch.Tensor:
    """(H, W, 3) f32 mean radiance over samples [spp_offset,
    spp_offset + spp) on the device of `table`; with `pixels` (begin,
    count), the (count, 3) radiance of those flat pixel ids (a mesh
    shard's range).

    `table` is the scene table (scene_table.scene_table, flattened), `cam`
    the 32-word camera vector. `has_met`/`has_die`/`sky` specialise the
    kernel. `fmad=True` selects a build of the kernel compiled with FMA
    contraction, for numerics comparisons only; the CPU twin ignores it.
    """
    _check(table, cam, n_sph, n_quad, width, height, spp, max_bounces)
    mk.pixel_range(width, height, pixels)
    kw = dict(n_sph=n_sph, n_quad=n_quad, width=width, height=height,
              spp=spp, max_bounces=max_bounces, seed=seed,
              spp_offset=spp_offset, has_met=has_met, has_die=has_die,
              sky=sky, pixels=pixels)
    if table.device.type == "cpu":
        return render_packed_reference(table, cam, **kw)
    if table.device.type != "cuda":
        raise ValueError(f"no megakernel for device {table.device}")
    lib = _build.load(fmad=fmad)
    flags = (int(has_met), int(has_die), int(sky))
    counts = mk.counts_ptr(table.device)

    def launch(out, samples, split, inv_spp, pix0, npix, stream):
        return lib.tinyrt_megakernel_packed(
            cam.data_ptr(), table.data_ptr(), table.numel(), n_sph, n_quad,
            out, samples, width, height, seed & 0xFFFFFFFF,
            spp_offset & 0xFFFFFFFF, spp, max_bounces, inv_spp, split,
            *flags, pix0, npix, counts, stream)

    out, err = mk.launch_forward(
        lib, table.device, width, height, spp, pixels,
        lambda rows: lib.tinyrt_megakernel_packed_split(
            table.numel(), width, rows, spp, *flags),
        launch)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"megakernel_packed launch failed: CUDA error "
                           f"{err} ({msg})")
    profiling.count("launches.render_packed")
    return out


def render_packed_reference(table: torch.Tensor, cam: torch.Tensor, *,
                            n_sph: int, n_quad: int, width: int,
                            height: int, spp: int, max_bounces: int,
                            seed: int = 0, spp_offset: int = 0,
                            has_met: bool = True, has_die: bool = True,
                            sky: bool = False,
                            pixels: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, vectorised over all pixels (or
    the flat pixel ids `pixels`, (begin, count)): the shared sampler
    (`megakernel.lockstep_render`) with the dense closest hit over the
    table's primitives (`megakernel.dense_closest_hit`)."""
    _check(table, cam, n_sph, n_quad, width, height, spp, max_bounces)
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
    return mk.lockstep_render(
        cam, mk.dense_closest_hit(sph[:, :4], quad[:, :12], pay),
        width=width, height=height, spp=spp, max_bounces=max_bounces,
        seed=seed, spp_offset=spp_offset, has_met=has_met, has_die=has_die,
        sky=sky, pixels=pixels)
