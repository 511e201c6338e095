"""Worker of tests/test_torch_sharded_mp.py: one rank of a two-process
gloo group, on the CPU, running the port's mesh routes over the group
(parallel/sharded.make_mesh(group=)). It imports neither JAX nor the JAX
package, and writes its results to `<out_dir>/rank<r>.json`.

The gates follow the JAX package's scripts/multiprocess_check.py:
  1. a tile-only mesh of 4 cells, 2 on each rank, gives the one-device
     image bit for bit;
  2. a (1 x 2) mesh whose sample shards sit on different ranks gives it
     within 1 ulp (only the sample mean's summation order differs);
  3. both ranks hold the same bytes (compared through the group);
  4. a modular train step over that (1 x 2) mesh takes the one-device
     step's loss within 1e-5 relative and its params within rtol 1e-3,
     atol 1e-6 (tests/test_diff.py's sharded-step tolerances), and leaves
     byte-identical params on both ranks.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch
import torch.distributed as dist

W, H, SPP, MB, SEED = 16, 12, 4, 3, 7


def _digests_equal(digest: bytes) -> bool:
    """Whether every rank holds this sha256 digest."""
    mine = torch.tensor(list(digest), dtype=torch.uint8)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return all(torch.equal(e, every[0]) for e in every)


def run(rank: int, world: int, rdv: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        results = _gates(rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def _gates(rank: int) -> dict:
    from tinyraytracer_tpu_torch.diff import inverse
    from tinyraytracer_tpu_torch.models import presets
    from tinyraytracer_tpu_torch.ops import trace as trace_ops
    from tinyraytracer_tpu_torch.parallel import sharded

    group = dist.group.WORLD
    world, cam, kw = presets.cornell_box(width=W, height=H)
    scene = world.build()
    bg = kw["background"]
    ref = trace_ops.render_image(scene, cam, spp=SPP, max_bounces=MB,
                                 background=torch.tensor(bg), seed=SEED)
    results = {}
    for name, devices, sample_parallel in (("tile4", ["cpu", "cpu"], 1),
                                           ("sample2", ["cpu"], 2)):
        mesh = sharded.make_mesh(devices, sample_parallel=sample_parallel,
                                 group=group)
        img = sharded.render_image_sharded(
            scene, cam, spp=SPP, max_bounces=MB, background=bg, seed=SEED,
            mesh=mesh)
        a = img.numpy().view(np.int32).astype(np.int64)
        b = ref.numpy().view(np.int32).astype(np.int64)
        results[name] = {
            "shape": list(img.shape), "mesh": dict(mesh.shape),
            "cells": [c.index for c in mesh.cells],
            "bitwise": bool(torch.equal(img, ref)),
            "max_ulp": int(np.abs(a - b).max()),
            "max_abs_diff": float((img - ref).abs().max()),
            "identical": _digests_equal(
                hashlib.sha256(img.numpy().tobytes()).digest()),
        }

    target = torch.zeros(H, W, 3)
    kws = dict(spp=SPP, max_bounces=MB, background=bg, seed=0,
               trainable=("sph_center", "mat_albedo"), use_kernel=True)
    mesh = sharded.make_mesh(["cpu"], sample_parallel=2, group=group)
    mstep, (mp, mo) = inverse.make_train_step(scene, cam, target, mesh=mesh,
                                              **kws)
    mp, mo, mloss = mstep(mp, mo, 0)
    sstep, (sp, so) = inverse.make_train_step(scene, cam, target,
                                              device="cpu", **kws)
    sp, so, sloss = sstep(sp, so, 0)
    pbytes = b"".join(mp[k].numpy().tobytes() for k in sorted(mp))
    results["train_step"] = {
        "loss_mesh": float(mloss), "loss_single": float(sloss),
        "loss_rel_diff": abs(float(mloss) - float(sloss))
        / max(abs(float(sloss)), 1e-12),
        "params_identical": _digests_equal(hashlib.sha256(pbytes).digest()),
        "params_close": all(
            bool(torch.allclose(mp[k], sp[k], rtol=1e-3, atol=1e-6))
            for k in mp),
    }
    results["rank"] = rank
    return results
