"""Seeded scenes with participating media (ConstantMedium), one builder
for the CPU tests (tests/test_torch_media.py) and the card tests
(tests/test_torch_media_cuda.py): each a benchmark-style description
(perfbench/traffic/render_media.py), which the port builds through its
public API and the plain reference (perfbench/reference/media.py) traces
on its own."""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SKY = [0.6, 0.7, 0.9]


def _camera(position, look_at, vfov=40.0):
    return {"focus_distance": 10.0, "defocus_angle": 0.0,
            "position": list(position), "look_at": list(look_at),
            "up": [0.0, 1.0, 0.0], "vertical_fov": vfov}


def _mats():
    return [{"name": "grey", "kind": "lambertian", "albedo": [0.5, 0.5, 0.5]},
            {"name": "red", "kind": "lambertian", "albedo": [0.7, 0.2, 0.1]},
            {"name": "glass", "kind": "dielectric", "albedo": [1.0, 1.0, 1.0],
             "ior": 1.5},
            {"name": "metal", "kind": "metal", "albedo": [0.8, 0.8, 0.9],
             "fuzz": 0.3},
            {"name": "light", "kind": "light", "emission": [6.0, 6.0, 6.0]}]


def _sphere(c, r, m):
    return {"sphere": {"center": list(c), "radius": r, "material": m}}


def _medium(c, r, density, albedo, m="grey"):
    return {"boundary": {"center": list(c), "radius": r, "material": m},
            "density": density, "albedo": list(albedo)}


GROUND = {"quad": {"corner": [-6.0, 0.0, -6.0], "u": [12.0, 0.0, 0.0],
                   "v": [0.0, 0.0, 12.0], "material": "grey"}}
LAMP = {"quad": {"corner": [-1.0, 4.0, -1.0], "u": [2.0, 0.0, 0.0],
                 "v": [0.0, 0.0, 2.0], "material": "light"}}


def _grid(n):
    """n small spheres of every material kind on a grid on the ground."""
    kinds = ["grey", "red", "glass", "metal"]
    return [_sphere((-3.0 + 0.75 * (k % 9), 0.25, -2.0 + 0.75 * (k // 9)),
                    0.25, kinds[k % 4]) for k in range(n)]


# name -> description: a medium alone under a sky; the camera inside a
# fog; a medium inside a glass sphere of the same boundary; two
# overlapping media; and 60 spheres with two media, which the route
# rule sends to the walk
DESCS = {
    "alone": dict(materials=_mats(), geometry=[],
                  media=[_medium((0.0, 1.0, 0.0), 1.0, 1.5,
                                 (0.7, 0.5, 0.3))],
                  camera=_camera((0.0, 1.5, -4.0), (0.0, 1.0, 0.0)),
                  background=SKY),
    "inside": dict(materials=_mats(),
                   geometry=[GROUND, LAMP, _sphere((0.0, 1.0, 0.0), 1.0,
                                                   "red")],
                   media=[_medium((0.0, 0.0, 0.0), 30.0, 0.08,
                                  (1.0, 1.0, 1.0))],
                   camera=_camera((0.0, 2.0, -5.0), (0.0, 1.0, 0.0)),
                   background=[0.0, 0.0, 0.0]),
    "glass": dict(materials=_mats(),
                  geometry=[GROUND, _sphere((0.0, 1.0, 0.0), 1.0, "glass")],
                  media=[_medium((0.0, 1.0, 0.0), 1.0, 2.0,
                                 (0.2, 0.4, 0.9), "glass")],
                  camera=_camera((0.0, 1.5, -4.0), (0.0, 1.0, 0.0)),
                  background=SKY),
    "overlap": dict(materials=_mats(), geometry=[GROUND],
                    media=[_medium((-0.3, 1.0, 0.0), 1.0, 1.0,
                                   (0.9, 0.3, 0.3)),
                           _medium((0.3, 1.0, 0.2), 1.0, 3.0,
                                   (0.3, 0.9, 0.3))],
                    camera=_camera((0.0, 1.5, -4.0), (0.0, 1.0, 0.0)),
                    background=SKY),
    "walk": dict(materials=_mats(), geometry=[GROUND, LAMP, *_grid(60)],
                 media=[_medium((0.0, 1.0, 0.0), 1.2, 1.0, (0.2, 0.4, 0.9),
                                "glass"),
                        _medium((0.0, 0.0, 0.0), 40.0, 0.02,
                                (1.0, 1.0, 1.0))],
                 camera=_camera((0.0, 2.5, -6.0), (0.0, 0.5, 0.0)),
                 background=[0.0, 0.0, 0.0]),
}

# the "walk" scene with 600 spheres, for K2's block cull: three blocks of
# ROW_CHUNK sphere rows, then the quads and the media
CULL = dict(DESCS["walk"], geometry=[GROUND, LAMP, *_grid(600)])


def port_world(name, width, height, desc=None):
    """(world, camera, background) of the description `name` (or `desc`)
    through the port's public API."""
    from perfbench.traffic import render_media

    desc = desc or DESCS[name]
    world, camera = render_media.port_scene(desc, width, height)
    return world, camera, tuple(desc["background"])


def reference(name, width, height, pixels, *, spp, max_bounces, seed,
              device="cpu", desc=None):
    """(linear (P, 3), mean segments, medium share) of the flat pixel ids
    `pixels` by the plain reference with media."""
    import torch

    from perfbench.reference import media, scene

    desc = desc or DESCS[name]
    low = scene.lower(scene.arrays(desc)).to(device)
    med = media.media(desc).to(device)
    cam = torch.from_numpy(scene.camera_vector(desc, width, height)).to(
        device)
    return media.render_pixels(low, med, cam,
                               torch.from_numpy(np.asarray(pixels)),
                               width=width, spp=spp, seed=seed,
                               max_bounces=max_bounces)
