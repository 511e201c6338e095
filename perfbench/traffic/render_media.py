"""Render traffic over a scene with participating media: traffic/render.py's
closed loop (one client, a new seed a render, the check of a sample of
the window's renders and pixels by `png_diff_share`), over a scene whose
description also lists `media`.

A medium is `{"boundary": {"center", "radius", "material"}, "density",
"albedo"}`: a constant-density medium inside the boundary sphere with an
isotropic phase function. The system builds it through its public API
(`ConstantMedium(Sphere(...), density, albedo)` added to the World; the
boundary is a surface too only where the geometry list also holds it),
and the plain reference (perfbench/reference/media.py) traces it from
the book's equations.

Scene generators (a configuration's `scene.generator`):
- `rtnw_final`: Ray Tracing: The Next Week's final scene
  (`final_scene`, section "A Scene Testing All New Features"): a 20 x 20
  grid of ground boxes 100 wide and [1, 101) high, an area light, a
  (static) moving sphere, a glass, a metal and a glass ball holding a
  medium, a fog medium around everything, an "earth" and a "noise"
  sphere in constant colours, and 1 000 white spheres drawn in
  [0, 165)^3, turned 15 degrees about y and moved by (-100, 270, 395).
  The box heights and the spheres' centres are drawn by numpy
  default_rng(layout_seed), heights first.

Parameters as traffic/render.py's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import scenes
from perfbench.reference import forward
from perfbench.reference import media as ref_media
from perfbench.reference import scene as ref_scene
from perfbench.traffic import render as render_traffic


def _rtnw_final(p: dict) -> dict:
    """The final scene of Ray Tracing: The Next Week (see the module's
    docstring); the materials and sizes of the book's `final_scene`, the
    cuts of the configuration's `assumed`."""
    rng = np.random.default_rng(int(p["layout_seed"]))
    mats = [{"name": "ground", "kind": "lambertian",
             "albedo": [0.48, 0.83, 0.53]},
            {"name": "light", "kind": "light", "emission": [7.0, 7.0, 7.0]},
            {"name": "moving", "kind": "lambertian",
             "albedo": [0.7, 0.3, 0.1]},
            {"name": "glass", "kind": "dielectric", "albedo": [1.0, 1.0, 1.0],
             "ior": 1.5},
            {"name": "metal", "kind": "metal", "albedo": [0.8, 0.8, 0.9],
             "fuzz": 1.0},
            {"name": "earth", "kind": "lambertian",
             "albedo": list(p["earth_albedo"])},
            {"name": "noise", "kind": "lambertian",
             "albedo": [0.5, 0.5, 0.5]},
            {"name": "white", "kind": "lambertian",
             "albedo": [0.73, 0.73, 0.73]}]
    sph = lambda c, r, m: {"sphere": {"center": [float(v) for v in c],  # noqa: E731
                                      "radius": float(r), "material": m}}
    geo = []
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + i * 100.0, -1000.0 + j * 100.0
            y1 = 1.0 + 100.0 * rng.random()
            geo.append({"box": {"a": [x0, 0.0, z0],
                                "b": [x0 + 100.0, y1, z0 + 100.0],
                                "material": "ground"}})
    geo.append({"quad": {"corner": [123.0, 554.0, 147.0],
                         "u": [300.0, 0.0, 0.0], "v": [0.0, 0.0, 265.0],
                         "material": "light"}})
    geo.append(sph((400.0, 400.0, 200.0), 50.0, "moving"))
    geo.append(sph((260.0, 150.0, 45.0), 50.0, "glass"))
    geo.append(sph((0.0, 150.0, 145.0), 50.0, "metal"))
    ball = sph((360.0, 150.0, 145.0), 70.0, "glass")
    geo.append(ball)
    geo.append(sph((400.0, 200.0, 400.0), 100.0, "earth"))
    geo.append(sph((220.0, 280.0, 300.0), 80.0, "noise"))
    a = math.radians(15.0)
    ca, sa = math.cos(a), math.sin(a)
    for _ in range(1000):
        x, y, z = 165.0 * rng.random(3)
        geo.append(sph((ca * x + sa * z - 100.0, y + 270.0,
                        -sa * x + ca * z + 395.0), 10.0, "white"))
    media = [{"boundary": dict(ball["sphere"]), "density": 0.2,
              "albedo": [0.2, 0.4, 0.9]},
             {"boundary": {"center": [0.0, 0.0, 0.0], "radius": 5000.0,
                           "material": "glass"},
              "density": 0.0001, "albedo": [1.0, 1.0, 1.0]}]
    return {"materials": mats, "geometry": geo, "media": media}


GENERATORS = {"rtnw_final": _rtnw_final}


def description(config: dict) -> dict:
    """The scene description of a configuration, media included."""
    scene = dict(config["scene"])
    gen = scene.pop("generator", None)
    if gen is not None:
        scene.update(GENERATORS[gen](scene))
    return scene


def port_scene(desc: dict, width: int, height: int):
    """(World, Camera) of the system under test, its media added through
    the public API after the surfaces (perfbench/scenes.py)."""
    import tinyraytracer_tpu_torch as rt

    world, camera = scenes.port_scene(desc, width, height)
    for m in desc.get("media", []):
        b = m["boundary"]
        world.add_geometry(rt.ConstantMedium(
            rt.Sphere(tuple(b["center"]), b["radius"], b["material"]),
            m["density"], tuple(m["albedo"])))
    return world, camera


class Cell(render_traffic.Cell):
    def __init__(self, config: dict, params: dict, *, seed: int,
                 device: str = "cuda"):
        super().__init__(dict(config, scene=description(config)), params,
                         seed=seed, device=device)

    def setup(self) -> None:
        import tinyraytracer_tpu_torch as rt

        self._rt = rt
        self.world, self.camera = port_scene(self.desc, self.w, self.h)
        for k in range(int(self.p["warm"])):
            self._render(render_traffic.request_seed(self.seed,
                                                     (1 << 40) + k))

    def reference(self, s: int, pix: np.ndarray, dtype=torch.float32):
        """(P, 3) gamma image of the flat pixel ids `pix` of the render
        with seed `s`, by the plain reference with media in `dtype`, and
        the mean segments a camera ray executed."""
        low = ref_scene.lower(ref_scene.arrays(self.desc)).to(
            self.device, dtype)
        med = ref_media.media(self.desc).to(self.device, dtype)
        cam = torch.from_numpy(ref_scene.camera_vector(
            self.desc, self.w, self.h)).to(self.device, dtype)
        lin, seg, _ = ref_media.render_pixels(
            low, med, cam, torch.from_numpy(pix), width=self.w,
            spp=self.spp, seed=s, max_bounces=self.mb)
        return forward.gamma(lin.float().cpu().numpy()), seg
