"""Rendering and training over a 2-D (tile x sample) mesh of devices.

Port of the JAX package's parallel/sharded.py. The JAX package lays its
devices out as a `jax.sharding.Mesh` and runs one program on every device
through `shard_map`; here a `Mesh` is a grid of shards ("cells"), each
with the device it runs on, and the port's renderers and train steps run
one cell after another in the process that holds them, then combine the
cells' results:

  - "tile" axis: the flat pixel ids are split over the tiles. Tile t takes
    the contiguous range `split_pixels(npix, n_tile)[t]` (the JAX package
    pads the ids to a multiple of the tile count by repeating the last
    pixel, and slices the pad off; ranges need no pad);
  - "sample" axis: sample shard s renders samples [spp_offset + s *
    spp_local, + spp_local) of its tile's pixels, spp_local = spp /
    n_sample, and the shards' means are summed in mesh order and divided
    by n_sample, as `pmean` does.

The counter RNG keys on the global (pixel, sample) ids, so every sample's
radiance is the same whatever cell renders it: a tile-only mesh gives the
one-device image bit for bit, and a sample split differs from it only by
the f32 summation order of the sample mean (an ulp at a few samples per
pixel; it grows with the samples summed: within 1e-6 x max(1, |value|)
at 200).

An explicit device list may name a device more than once: those cells
then run one after another on that device. That is how a one-card
machine, or the CPU, runs a mesh of any shape. A CUDA device that the
machine does not have raises; nothing falls back to the CPU.

Across processes (`make_mesh(group=)`, a `torch.distributed` process
group: NCCL on the card, gloo on the CPU) the mesh spans the ranks: rank
r holds cells r * k .. (r + 1) * k - 1 of a mesh of world * k cells, k =
len(devices). Each rank runs its own cells; the combine then gathers
every cell's result to every rank (`all_gather`) and reduces them there
in mesh order, so every rank ends with the same bytes, those the
one-process mesh of the same shape gives. Every rank must build the same
scene and camera (from the same seed).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.ops import trace as trace_ops

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"

_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Cell:
    """One shard of a mesh: its row-major index (t * n_sample + s), its
    tile t and sample shard s, and the device it runs on."""

    index: int
    tile: int
    sample: int
    device: torch.device


class Mesh:
    """A (n_tile, n_sample) grid of cells (see the module docstring).

    `cells` are the cells this process holds, in mesh order; `device` is
    its first device, where the combined results land. `shape` maps the
    axis names to their sizes, as a JAX mesh's does."""

    def __init__(self, devices: Sequence[torch.device], n_sample: int,
                 group=None):
        self.group = group
        self.rank, self.world = 0, 1
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        k = len(devices)
        self.n_sample = n_sample
        self.n_tile = k * self.world // n_sample
        first = self.rank * k
        self.cells = tuple(
            Cell(first + j, (first + j) // n_sample, (first + j) % n_sample,
                 d) for j, d in enumerate(devices))
        self.device = devices[0]

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: self.n_tile, SAMPLE_AXIS: self.n_sample}

    @property
    def size(self) -> int:
        return self.n_tile * self.n_sample

    def __repr__(self) -> str:
        where = "" if self.group is None else (
            f", rank {self.rank} of {self.world}")
        return (f"Mesh(tile={self.n_tile}, sample={self.n_sample}, "
                f"local={[str(c.device) for c in self.cells]}{where})")

    def _every_cell(self, local: Sequence[torch.Tensor],
                    numels: Sequence[int]) -> list:
        """Every cell's tensor, flattened, on `device`, in mesh order:
        `local` holds this process's cells' tensors, and `numels[c]` is
        cell c's element count."""
        flat = [t.reshape(-1).to(self.device) for t in local]
        if self.group is None:
            return flat
        import torch.distributed as dist

        # all_gather takes equal shapes: each rank sends its cells as the
        # rows of one zero-padded block
        buf = torch.zeros((len(flat), max(numels)), dtype=flat[0].dtype,
                          device=self.device)
        for j, t in enumerate(flat):
            buf[j, :t.numel()] = t
        blocks = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(blocks, buf, group=self.group)
        rows = torch.cat(blocks, 0)
        return [rows[c, :numels[c]] for c in range(self.size)]

    def image(self, parts: Sequence[torch.Tensor],
              ranges: Sequence[tuple]) -> torch.Tensor:
        """The (npix, 3) image from the cells' (count, 3) parts, tile t
        covering ranges[t]: each tile's sample shards summed in mesh order
        and divided by n_sample (`pmean`; a tile-only mesh adds nothing),
        the tiles in order."""
        n = self.n_sample
        every = self._every_cell(
            parts, [3 * ranges[c // n][1] for c in range(self.size)])
        tiles = []
        for t in range(self.n_tile):
            acc = every[t * n]
            for s in range(1, n):
                acc = acc + every[t * n + s]
            tiles.append(acc if n == 1 else acc / n)
        return _join(tiles).view(-1, 3)

    def concat(self, parts: Sequence[torch.Tensor],
               ranges: Sequence[tuple]) -> torch.Tensor:
        """The (npix, 3) image from parts that split the pixels over every
        cell (cell c covering ranges[c]), in mesh order."""
        every = self._every_cell(parts, [3 * r[1] for r in ranges])
        return _join(every).view(-1, 3)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The cells' equal-shaped tensors summed in mesh order (`psum`),
        flattened, on `device`."""
        every = self._every_cell(parts, [parts[0].numel()] * self.size)
        acc = every[0]
        for x in every[1:]:
            acc = acc + x
        return acc


def _join(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The flat parts concatenated in order; a single part is returned
    as it is (the one-cell mesh of a one-device call copies nothing)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def one_cell(device) -> Mesh:
    """The (1, 1) mesh on `device`: the one-device render or step, run
    through the same code as any other mesh. It gives the same bits as a
    whole-image launch: one range covering every pixel, no sample split,
    and each combine returns its single part unchanged."""
    return Mesh([torch.device(device)], 1)


def _mesh_device(device) -> torch.device:
    """`device` as a mesh cell's torch.device: a CUDA device this machine
    has (an index is filled in), or the CPU. Anything else raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device!r}: CUDA is not "
                               "available on this machine")
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        count = torch.cuda.device_count()
        if not 0 <= idx < count:
            raise RuntimeError(f"mesh device {device!r} does not exist: "
                               f"this machine has {count} CUDA device(s)")
        return torch.device("cuda", idx)
    if dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {device!r}")
    return dev


def make_mesh(devices: Optional[Sequence] = None, *,
              sample_parallel: int = 1, group=None) -> Mesh:
    """A (tile x sample) mesh over `devices`: `sample_parallel` cells
    cooperate on the same pixels (splitting spp), the rest split the
    pixel grid.

    `devices` None takes every visible CUDA device (with `group`, this
    rank's current CUDA device) and raises where there is no CUDA; it
    never gathers CPU devices on its own. A list may repeat a device. With
    `group` (a torch.distributed process group) the mesh spans its ranks,
    each holding len(devices) cells; the cell count must divide by
    sample_parallel."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() with no devices takes every visible CUDA "
                "device, and CUDA is not available on this machine; pass "
                "devices=[...] (e.g. ['cpu', 'cpu']) for a CPU mesh")
        if group is not None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [_mesh_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) > 1:
        raise ValueError("a mesh's devices must all be CUDA or all CPU")
    world = 1
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
    n = len(devices) * world
    if sample_parallel < 1 or n % sample_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"sample_parallel={sample_parallel}")
    return Mesh(devices, sample_parallel, group)


def split_pixels(npix: int, parts: int) -> list:
    """[(begin, count)] of `parts` contiguous ranges that cover the flat
    pixel ids [0, npix) in order, their counts differing by at most 1."""
    if parts < 1 or npix < parts:
        raise ValueError(f"cannot split {npix} pixels over {parts} shards")
    edges = [k * npix // parts for k in range(parts + 1)]
    return [(a, b - a) for a, b in zip(edges, edges[1:])]


def render_sharded(mesh: Mesh, render_part: Callable, *, npix: int,
                   spp: int, spp_offset: int = 0) -> torch.Tensor:
    """(npix, 3) mean radiance over samples [spp_offset, spp_offset + spp)
    on `mesh.device`, rendered cell by cell:
    `render_part(device, begin, count, spp_local, offset)` returns the
    (count, 3) mean over samples [offset, offset + spp_local) of the pixels
    [begin, begin + count) on `device`."""
    n = mesh.n_sample
    if spp % n:
        raise ValueError(f"spp={spp} not divisible by sample axis size {n}")
    spp_local = spp // n
    ranges = split_pixels(npix, mesh.n_tile)
    parts = [render_part(c.device, *ranges[c.tile], spp_local,
                         (spp_offset + c.sample * spp_local) & _MASK)
             for c in mesh.cells]
    return mesh.image(parts, ranges)


def render_image_sharded(scene, camera: Camera, *, spp: int,
                         max_bounces: int, background, seed: int = 0,
                         devices: Optional[Sequence] = None,
                         mesh: Optional[Mesh] = None,
                         sample_parallel: int = 1, exact: bool = False,
                         spp_offset: int = 0, bvh=None) -> torch.Tensor:
    """Full-image render with the modular tracer (ops/trace.py) sharded
    over a mesh (`make_mesh(devices, sample_parallel=)` unless `mesh` is
    given). Returns (H, W, 3) linear radiance on `mesh.device`: the
    one-device `trace.render_image` bit for bit on a tile-only mesh,
    within f32 summation rounding when spp is split. `bvh` (an
    ops/bvh.BVHArrays, or None for dense selection) is moved to each
    cell's device, as the scene is."""
    if mesh is None:
        mesh = make_mesh(devices, sample_parallel=sample_parallel)
    w, h = camera.width, camera.height

    def part(dev, begin, count, spp_local, offset):
        pixel_id = torch.arange(begin, begin + count, dtype=torch.int64,
                                device=dev)
        with torch.no_grad():
            return trace_ops.render_pixels(
                scene.to(dev), camera.to(dev), pixel_id, spp=spp_local,
                max_bounces=max_bounces, background=background, seed=seed,
                exact=exact, spp_offset=offset,
                bvh=None if bvh is None else bvh.to(dev))

    img = render_sharded(mesh, part, npix=w * h, spp=spp,
                         spp_offset=spp_offset)
    return img.view(h, w, 3)
