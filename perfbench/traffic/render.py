"""Render traffic: one client renders the scene again and again, each
request with a new seed, closed loop.

A request is one `Renderer(samples_per_pixel, max_bounces=...,
progressbar=False, background_color=..., seed=s).render(camera, world)`
call, ended when its gamma-2.2 Image is on the host. The seeds are drawn
from --seed, so every seed gives the same sizes and the same number of
samples, in another random stream.

The check: a sample of the window's renders (a reservoir drawn from
--seed) and of each one's pixels is traced again by the plain reference
(perfbench/reference/forward.py) at the render's own spp, bounces and
seed, and the images compared as the PNG holds them: `png_diff_share` is
the share of the sampled pixels' 8-bit channel values that differ.

Parameters (perfbench/workloads/<cell>.json): width, height, spp,
max_bounces; warm, the renders of set-up (a few where a render is short,
so that the host's allocations have settled when the window opens);
check.renders and check.pixels, the sample's size; limits.png_diff_share.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import scenes, workcount
from perfbench.reference import forward
from perfbench.reference import scene as ref_scene

_U64 = 1 << 64


def request_seed(seed: int, i: int) -> int:
    """The render seed of request i: a u32 drawn from (--seed, i)."""
    ss = np.random.SeedSequence([seed % _U64, i])
    return int(ss.generate_state(1)[0])


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
        self.keep_n = int(params["check"]["renders"])
        self.kept: list = []        # (request index, seed, sampled pixels)
        self._keep_rng = np.random.default_rng([self.seed % _U64, 1])
        self.segments = None        # mean segments a camera ray, reference

    # -- the system under test ----------------------------------------------
    def setup(self) -> None:
        import tinyraytracer_tpu_torch as rt

        self._rt = rt
        self.world, self.camera = scenes.port_scene(self.desc, self.w,
                                                    self.h)
        # warm renders at the cell's shapes, with seeds of no request
        for k in range(int(self.p["warm"])):
            self._render(request_seed(self.seed, (1 << 40) + k))

    def _render(self, s: int):
        r = self._rt.Renderer(
            samples_per_pixel=self.spp, max_bounces=self.mb,
            progressbar=False, background_color=tuple(self.desc["background"]),
            seed=s, device=self.device)
        return r.render(self.camera, self.world)

    def request(self, i: int) -> None:
        s = request_seed(self.seed, i)
        img = self._render(s)
        # reservoir sample of the window's renders, drawn from --seed; of
        # each only the sampled pixels are kept, so that no image outlives
        # its request
        if len(self.kept) < self.keep_n:
            j = len(self.kept)
            self.kept.append(None)
        else:
            j = int(self._keep_rng.integers(0, i + 1))
        if j < self.keep_n:
            got = img.data.reshape(-1, 3)[self.pixel_sample(i)]
            self.kept[j] = (i, s, got)

    def work_per_request(self) -> float:
        """Camera rays of a render."""
        return float(self.w * self.h * self.spp)

    def release(self) -> None:
        """Frees the system's state before the reference runs."""
        self.world = self.camera = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def pixel_sample(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed % _U64, i, 2])
        n = min(int(self.p["check"]["pixels"]), self.w * self.h)
        return np.sort(rng.choice(self.w * self.h, n, replace=False))

    def reference(self, s: int, pix: np.ndarray, dtype=torch.float32):
        """(P, 3) gamma image of the flat pixel ids `pix` of the render
        with seed `s`, by the plain reference in `dtype`, and the mean
        segments a camera ray executed."""
        low = ref_scene.lower(ref_scene.arrays(self.desc)).to(
            self.device, dtype)
        cam = torch.from_numpy(ref_scene.camera_vector(
            self.desc, self.w, self.h)).to(self.device, dtype)
        lin, seg = forward.render_pixels(
            low, cam, torch.from_numpy(pix), width=self.w, spp=self.spp,
            seed=s, max_bounces=self.mb)
        return forward.gamma(lin.float().cpu().numpy()), seg

    def check(self) -> dict:
        diff, segs = [], []
        for i, s, got in sorted(self.kept, key=lambda k: k[0]):
            ref, seg = self.reference(s, self.pixel_sample(i))
            diff.append(forward.to_u8(got) != forward.to_u8(ref))
            segs.append(seg)
        self.segments = float(np.mean(segs)) if segs else None
        value = float(np.mean(diff)) if diff else 1.0
        lim = float(self.p["limits"]["png_diff_share"])
        return {"png_diff_share": {"value": value, "limit": lim}}

    def kernel_ops_per_request(self) -> float | None:
        """The forward work of a render (perfbench/workcount.py) at the
        segments the reference counted."""
        if self.segments is None:
            return None
        low = ref_scene.lower(ref_scene.arrays(self.desc))
        return self.work_per_request() * workcount.ops_per_camera_ray(
            low.n_sph, low.n_quad, self.segments, has_met=low.has_met,
            has_die=low.has_die)
