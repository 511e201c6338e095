"""Training traffic: one client fits the scene's parameters to a target
image, closed loop: a request is one step of the system's fused train
step (`make_fused_train_step`: render, MSE loss, backward, Adam), ended
by a host read of its loss. The client runs fits of `fit_steps` steps
one after another, each from the scene's own parameters and a fresh
optimizer state (the sample streams go on advancing): the parameters,
and with them the work of a step, stay within what `fit_steps` steps can
move, however many steps a faster system fits into the window.

Set-up builds the one step object, drives it through its first
`check.steps` steps (their samples all differ: the sample stream
advances a step at a time) and hands that same object to the window.
The target image is drawn on the device from the workload's
`target.seed` (a coarse grid of random colours, bilinearly upsampled)
and handed to the system and to the reference alike; --seed seeds the
sample streams. The target is the same for every --seed because it
steers the fit's whole path, and with it the work of every later step:
a target drawn from --seed moved the rate by 3 % from seed to seed.

The check: the plain reference (perfbench/reference/step.py) follows
the same first steps from the same scene and target, and
- `loss_gap`: the relative gap of the first step's loss;
- `grad_gap`: the first gradient as the optimizer got it (read back
  from Adam's first moment after one step), by the worst leaf: the gap
  between the system's norm of the leaf and the reference's, over the
  reference's norm of that leaf or of the median leaf, the larger;
- `change_gap`: the parameters' change after the steps, by the median
  leaf: each leaf's gap as above, the median over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (the
  others move under Adam by round-off alone).

The later steps' losses and the worst leaf's change are not compared:
from the second step on, Adam divides a first moment that can all but
cancel in one entry, and there the round-off of the gradient tables'
order of summation swings that entry's update (PERF.md, section 2).

Parameters: width, height, spp, max_bounces, learning_rate, fit_steps;
trainable
(fields, or null for all); trainable_rows ({"sph": n}: geometry trains
on the first n real sphere rows only); target.grid, .high and .seed;
check.steps; limits.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import scenes, workcount
from perfbench.reference import diff as ref_diff
from perfbench.reference import scene as ref_scene
from perfbench.reference import step as ref_step

_U64 = 1 << 64
_B1 = 0.9


def make_target(seed: int, width: int, height: int, grid: int, high: float,
                device) -> torch.Tensor:
    """(H, W, 3) f32 target on `device`, drawn from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    coarse = torch.rand((1, 3, grid, grid), generator=g, device=device)
    img = torch.nn.functional.interpolate(
        coarse * high, size=(height, width), mode="bilinear",
        align_corners=True)
    return img[0].permute(1, 2, 0).contiguous()


def sample_seed(seed: int) -> int:
    """The u32 seed of the sample streams, drawn from --seed."""
    return int(np.random.SeedSequence([seed % _U64, 3]).generate_state(1)[0])


class Cell:
    def __init__(self, config: dict, params: dict, *, seed: int,
                 device: str = "cuda"):
        self.p = params
        self.seed = int(seed)
        self.device = device
        self.desc = scenes.description(config)
        self.w, self.h = int(params["width"]), int(params["height"])
        self.spp = int(params["spp"])
        self.mb = int(params["max_bounces"])
        self.lr = float(params.get("learning_rate", 1e-2))
        self.trainable = params.get("trainable")
        self.steps0 = int(params["check"]["steps"])
        self.fit_steps = int(params["fit_steps"])
        if self.fit_steps <= self.steps0:
            raise ValueError("fit_steps must exceed check.steps: the "
                             "checked steps are the first of one fit")
        rows = params.get("trainable_rows")
        self.rows = None
        if rows is not None:
            a = ref_scene.arrays(self.desc).numpy()
            sph = np.nonzero(a["sph_valid"])[0][:int(rows.get("sph", 0))]
            quad = np.nonzero(a["quad_valid"])[0][:int(rows.get("quad", 0))]
            self.rows = {"sph": [int(r) for r in sph],
                         "quad": [int(r) for r in quad]}
        self.segments = None

    # -- the system under test ----------------------------------------------
    def make_inputs(self) -> None:
        """The target image, which the system and the reference share."""
        t = self.p["target"]
        self.target = make_target(int(t["seed"]), self.w, self.h,
                                  int(t["grid"]), float(t["high"]),
                                  self.device)

    def setup(self) -> None:
        from tinyraytracer_tpu_torch.diff.inverse import make_fused_train_step

        world, camera = scenes.port_scene(self.desc, self.w, self.h)
        self.make_inputs()
        kw = {}
        if self.trainable is not None:
            kw["trainable"] = tuple(self.trainable)
        if self.rows is not None:
            kw["trainable_rows"] = self.rows
        self.step, (self.params, self.opt) = make_fused_train_step(
            world.build(), camera, self.target, spp=self.spp,
            max_bounces=self.mb, background=tuple(self.desc["background"]),
            seed=sample_seed(self.seed), learning_rate=self.lr,
            device=self.device, **kw)
        self.n = 0
        self.start = ({k: v.clone() for k, v in self.params.items()},
                      self.opt)
        p0 = self.start[0]
        self.losses = []
        for i in range(self.steps0):
            self.losses.append(self._step())
            if i == 0:
                adam = self.opt[0]
                self.grad1 = {k: m / (1 - _B1) for k, m in adam.mu.items()}
        self.change = {k: self.params[k] - p0[k] for k in p0}
        self.grad_norms = ref_step.leaf_norms(self.grad1)
        self.change_norms = ref_step.leaf_norms(self.change)

    def _step(self) -> float:
        if self.n and self.n % self.fit_steps == 0:
            # the next fit starts from the scene's parameters
            self.params = {k: v.clone() for k, v in self.start[0].items()}
            self.opt = self.start[1]
        self.params, self.opt, loss = self.step(self.params, self.opt,
                                                self.n)
        self.n += 1
        return loss.item()

    def request(self, i: int) -> None:
        self._step()

    def work_per_request(self) -> float:
        """Camera rays of a step."""
        return float(self.w * self.h * self.spp)

    def release(self) -> None:
        self.step = self.params = self.opt = self.start = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def reference(self, dtype=torch.float32, half_image: bool = False):
        """The reference's first steps: (losses, the first gradient's
        norms, the change's norms, mean segments a camera ray)."""
        r = self.reference_step(dtype, half_image)
        losses, g, change, seg = r.run(self.steps0)
        return (losses, ref_step.leaf_norms(g), ref_step.leaf_norms(change),
                seg)

    def reference_step(self, dtype=torch.float32, half_image=False):
        chunk = self.w * self.h if self.device == "cuda" else 0
        return ref_step.Step(
            self.desc, self.target, width=self.w, height=self.h,
            spp=self.spp, max_bounces=self.mb, seed=sample_seed(self.seed),
            trainable=self.trainable, trainable_rows=self.rows,
            learning_rate=self.lr, device=self.device, dtype=dtype,
            pixel_chunk=chunk, half_image=half_image)

    @staticmethod
    def gaps(prog, ref, detail: bool = False) -> dict:
        """The numbers compared, from (losses, grad norms, change norms) of
        the system and of the reference; with `detail` also the later
        steps' loss gap and the worst leaf's change gap."""
        (pl, pg, pc), (rl, rg, rc) = prog, ref
        rel = [abs(a - b) / abs(b) if b else abs(a - b)
               for a, b in zip(pl, rl)]
        moved = ref_step.moved_leaves(rg)
        out = {"loss_gap": rel[0],
               "grad_gap": ref_step.worst_leaf_gap(pg, rg),
               "change_gap": ref_step.median_leaf_gap(pc, rc, moved)}
        if detail:
            out["loss_gap_all_steps"] = max(rel)
            out["change_gap_worst_leaf"] = ref_step.worst_leaf_gap(pc, rc,
                                                                   moved)
        return out

    def check(self) -> dict:
        self.ref_readings = self.reference()
        rl, rg, rc, self.segments = self.ref_readings
        values = self.gaps((self.losses, self.grad_norms, self.change_norms),
                           (rl, rg, rc))
        lim = self.p["limits"]
        return {k: {"value": float(v), "limit": float(lim[k])}
                for k, v in values.items()}

    def kernel_ops_per_request(self) -> float | None:
        """The work of a step (perfbench/workcount.py, the adjoint charged
        once per forward segment) at the segments the reference counted
        in its first step."""
        if self.segments is None:
            return None
        r = self.reference_step()
        st = r.st
        has_met, has_die = ref_diff.static_kind_flags(st)
        n_sph, n_quad = len(st.sph_rows), len(st.quad_rows)
        scope = lambda s, n: n if s is True else (  # noqa: E731
            0 if s is False else len(s))
        return self.work_per_request() * workcount.ops_per_camera_ray_diff(
            n_sph, n_quad, self.segments,
            n_surr_sph=scope(r.surr_s, n_sph),
            n_surr_quad=scope(r.surr_q, n_quad),
            has_met=has_met, has_die=has_die)
