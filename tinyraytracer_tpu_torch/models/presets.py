"""Benchmark / parity scenes (BASELINE.md configs 1-4).

Each builder returns (World, Camera, render kwargs). Scene definitions mirror
the reference's checked-in scenes:
  - cornell_box:   src/main.rs:6-87 (Cornell walls + light + two boxes)
  - three_spheres: renderer/renderer.rs:88-150 test scene (metal+dielectric)
  - sphere_ground: RTiOW ch.1-style diffuse sphere + ground (config 1)
  - random_spheres: ~500-primitive BVH stress scene (config 4); procedural
    with a fixed numpy seed so it is reproducible.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.geometry import Quad, Sphere, make_box
from tinyraytracer_tpu_torch.models.materials import (
    Dielectric,
    Lambertian,
    Light,
    Metal,
)
from tinyraytracer_tpu_torch.models.world import World


def cornell_box(width: int = 600, height: int = 600) -> Tuple[World, Camera, Dict]:
    """The reference binary's Cornell box (src/main.rs:29-125)."""
    world = World()
    world.add_material("red", Lambertian((0.65, 0.05, 0.05)))
    world.add_material("white", Lambertian((0.73, 0.73, 0.73)))
    world.add_material("green", Lambertian((0.12, 0.45, 0.15)))
    world.add_material("light", Light((15.0, 15.0, 15.0)))

    world.add_geometry(Quad((100.0, 0.0, 0.0), (0.0, 100.0, 0.0), (0.0, 0.0, 100.0), "green"))
    world.add_geometry(Quad((0.0, 0.0, 0.0), (0.0, 100.0, 0.0), (0.0, 0.0, 100.0), "red"))
    world.add_geometry(Quad((65.0, 100.0, 60.0), (-30.0, 0.0, 0.0), (0.0, 0.0, -20.0), "light"))
    world.add_geometry(Quad((0.0, 0.0, 0.0), (100.0, 0.0, 0.0), (0.0, 0.0, 100.0), "white"))
    world.add_geometry(Quad((100.0, 100.0, 100.0), (-100.0, 0.0, 0.0), (0.0, 0.0, -100.0), "white"))
    world.add_geometry(Quad((0.0, 0.0, 100.0), (100.0, 0.0, 0.0), (0.0, 100.0, 0.0), "white"))
    world.add_geometry(make_box((25.0, 0.0, 50.0), (55.0, 60.0, 80.0), "white"))
    world.add_geometry(make_box((45.0, 0.0, 10.0), (75.0, 30.0, 40.0), "white"))

    camera = Camera.new(
        focus_distance=140.0,
        defocus_angle=0.6,
        position=(50.0, 50.0, -140.0),
        look_at=(50.0, 50.0, 0.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=40.0,
        width=width,
        height=height,
    )
    kwargs = dict(max_bounces=20, background=(0.001, 0.001, 0.001))
    return world, camera, kwargs


def three_spheres(width: int = 400, height: int = 300) -> Tuple[World, Camera, Dict]:
    """The reference's golden render_test scene (renderer.rs:88-150):
    diffuse ground+center, hollow dielectric, fuzzy metal; sky background."""
    world = World()
    world.add_material("ground", Lambertian((0.0, 1.0, 0.0)))
    world.add_material("center", Lambertian((1.0, 0.0, 0.0)))
    world.add_material("left_outer", Dielectric((1.0, 1.0, 1.0), 1.5))
    world.add_material("left_inner", Dielectric((1.0, 1.0, 1.0), 1.0 / 1.5))
    world.add_material("right", Metal((0.4, 0.4, 1.0), 0.3))

    world.add_geometry(Sphere((0.0, -100.5, -1.0), 100.0, "ground"))
    world.add_geometry(Sphere((0.0, 0.0, -1.2), 0.5, "center"))
    world.add_geometry(Sphere((1.0, 0.0, -1.0), 0.5, "left_outer"))
    world.add_geometry(Sphere((1.0, 0.0, -1.0), 0.4, "left_inner"))
    world.add_geometry(Sphere((-1.0, 0.0, -1.0), 0.5, "right"))

    camera = Camera.new(
        focus_distance=3.4,
        defocus_angle=10.0,
        position=(-2.0, 2.0, 1.0),
        look_at=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=20.0,
        width=width,
        height=height,
    )
    kwargs = dict(max_bounces=10, background=(0.7, 0.8, 1.0))
    return world, camera, kwargs


def sphere_ground(width: int = 400, height: int = 225) -> Tuple[World, Camera, Dict]:
    """Config 1: single diffuse sphere + ground sphere, sky background."""
    world = World()
    world.add_material("ground", Lambertian((0.8, 0.8, 0.0)))
    world.add_material("center", Lambertian((0.1, 0.2, 0.5)))
    world.add_geometry(Sphere((0.0, -100.5, -1.0), 100.0, "ground"))
    world.add_geometry(Sphere((0.0, 0.0, -1.0), 0.5, "center"))

    camera = Camera.new(
        focus_distance=1.0,
        defocus_angle=0.0,
        position=(0.0, 0.0, 0.0),
        look_at=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=90.0,
        width=width,
        height=height,
    )
    kwargs = dict(max_bounces=8, background=(0.7, 0.8, 1.0))
    return world, camera, kwargs


def cornell_spheres(width: int = 300, height: int = 300) -> Tuple[World, Camera, Dict]:
    """Cornell walls + light with two spheres instead of boxes — the
    inverse-rendering scene (BASELINE config 5 recovers sphere positions
    and albedos from a target image). The light is inset 0.01 below the
    ceiling plane so the render is free of the z-fighting degeneracy of the
    reference scene (important for clean gradients)."""
    world = World()
    world.add_material("red", Lambertian((0.65, 0.05, 0.05)))
    world.add_material("white", Lambertian((0.73, 0.73, 0.73)))
    world.add_material("green", Lambertian((0.12, 0.45, 0.15)))
    world.add_material("light", Light((15.0, 15.0, 15.0)))
    world.add_material("sphere_a", Lambertian((0.2, 0.4, 0.8)))
    world.add_material("sphere_b", Lambertian((0.8, 0.6, 0.2)))

    world.add_geometry(Quad((100.0, 0.0, 0.0), (0.0, 100.0, 0.0), (0.0, 0.0, 100.0), "green"))
    world.add_geometry(Quad((0.0, 0.0, 0.0), (0.0, 100.0, 0.0), (0.0, 0.0, 100.0), "red"))
    world.add_geometry(Quad((65.0, 99.99, 60.0), (-30.0, 0.0, 0.0), (0.0, 0.0, -20.0), "light"))
    world.add_geometry(Quad((0.0, 0.0, 0.0), (100.0, 0.0, 0.0), (0.0, 0.0, 100.0), "white"))
    world.add_geometry(Quad((100.0, 100.0, 100.0), (-100.0, 0.0, 0.0), (0.0, 0.0, -100.0), "white"))
    world.add_geometry(Quad((0.0, 0.0, 100.0), (100.0, 0.0, 0.0), (0.0, 100.0, 0.0), "white"))
    world.add_geometry(Sphere((35.0, 18.0, 60.0), 18.0, "sphere_a"))
    world.add_geometry(Sphere((68.0, 14.0, 30.0), 14.0, "sphere_b"))

    camera = Camera.new(
        focus_distance=140.0,
        defocus_angle=0.0,
        position=(50.0, 50.0, -140.0),
        look_at=(50.0, 50.0, 0.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=40.0,
        width=width,
        height=height,
    )
    kwargs = dict(max_bounces=20, background=(0.001, 0.001, 0.001))
    return world, camera, kwargs


def five_quads(width: int = 400, height: int = 300) -> Tuple[World, Camera, Dict]:
    """The reference's quad golden-test scene (hittable/quad.rs:98-151):
    five colored quads seen head-on, sky background."""
    world = World()
    world.add_material("red", Lambertian((1.0, 0.2, 0.2)))
    world.add_material("green", Lambertian((0.2, 1.0, 0.2)))
    world.add_material("blue", Lambertian((0.2, 0.2, 1.0)))
    world.add_material("orange", Lambertian((1.0, 0.5, 0.0)))
    world.add_material("teal", Lambertian((0.2, 0.8, 0.8)))

    world.add_geometry(Quad((-3.0, -2.0, 5.0), (0.0, 0.0, -4.0), (0.0, 4.0, 0.0), "red"))
    world.add_geometry(Quad((-2.0, -2.0, 0.0), (4.0, 0.0, 0.0), (0.0, 4.0, 0.0), "green"))
    world.add_geometry(Quad((3.0, -2.0, 1.0), (0.0, 0.0, 4.0), (0.0, 4.0, 0.0), "blue"))
    world.add_geometry(Quad((-2.0, 3.0, 1.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), "orange"))
    world.add_geometry(Quad((-2.0, -3.0, 5.0), (4.0, 0.0, 0.0), (0.0, 0.0, -4.0), "teal"))

    camera = Camera.new(
        focus_distance=1.0,
        defocus_angle=0.0,
        position=(0.0, 0.0, 9.0),
        look_at=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=80.0,
        width=width,
        height=height,
    )
    kwargs = dict(max_bounces=10, background=(0.7, 0.8, 1.0))
    return world, camera, kwargs


def random_spheres(
    width: int = 1200, height: int = 675, n: int = 500, seed: int = 7
) -> Tuple[World, Camera, Dict]:
    """Config 4: ~n-primitive random-spheres scene (RTiOW final-scene style),
    exercising the acceleration structure."""
    rng = np.random.default_rng(seed)
    world = World()
    world.add_material("ground", Lambertian((0.5, 0.5, 0.5)))
    world.add_material("glass", Dielectric((1.0, 1.0, 1.0), 1.5))
    world.add_geometry(Sphere((0.0, -1000.0, 0.0), 1000.0, "ground"))
    world.add_geometry(Sphere((0.0, 1.0, 0.0), 1.0, "glass"))
    world.add_material("big_diffuse", Lambertian((0.4, 0.2, 0.1)))
    world.add_geometry(Sphere((-4.0, 1.0, 0.0), 1.0, "big_diffuse"))
    world.add_material("big_metal", Metal((0.7, 0.6, 0.5), 0.0))
    world.add_geometry(Sphere((4.0, 1.0, 0.0), 1.0, "big_metal"))

    count = 0
    grid = int(np.ceil(np.sqrt(max(1, n - 4))))
    for a in range(-grid // 2, grid - grid // 2):
        for b in range(-grid // 2, grid - grid // 2):
            if count >= n - 4:
                break
            center = (
                a + 0.9 * rng.random(),
                0.2,
                b + 0.9 * rng.random(),
            )
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
                continue
            choice = rng.random()
            name = f"m{count}"
            if choice < 0.8:
                albedo = tuple((rng.random(3) * rng.random(3)).tolist())
                world.add_material(name, Lambertian(albedo))
            elif choice < 0.95:
                albedo = tuple((0.5 + 0.5 * rng.random(3)).tolist())
                world.add_material(name, Metal(albedo, 0.5 * rng.random()))
            else:
                world.add_material(name, Dielectric((1.0, 1.0, 1.0), 1.5))
            world.add_geometry(Sphere(center, 0.2, name))
            count += 1

    camera = Camera.new(
        focus_distance=10.0,
        defocus_angle=0.6,
        position=(13.0, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=20.0,
        width=width,
        height=height,
    )
    kwargs = dict(max_bounces=50, background=(0.7, 0.8, 1.0))
    return world, camera, kwargs


def rtiow_sky(width: int = 400, height: int = 225) -> Tuple[World, Camera, Dict]:
    """The reference's checked-in /root/reference/output.png artifact
    class: RTiOW-style gray diffuse sphere + ground under the GRADIENT
    SKY the surveyed snapshot itself dropped (renderer.rs:21-35 only
    supports a constant background; the artifact predates that). The
    background is the (bottom, top) pair lerped on the unit miss
    direction's y — RTiOW's white -> (0.5, 0.7, 1.0) blend."""
    world = World()
    world.add_material("gray", Lambertian((0.5, 0.5, 0.5)))
    world.add_geometry(Sphere((0.0, 0.0, -1.0), 0.5, "gray"))
    world.add_geometry(Sphere((0.0, -100.5, -1.0), 100.0, "gray"))
    camera = Camera.new(
        focus_distance=1.0,
        defocus_angle=0.0,
        position=(0.0, 0.0, 0.0),
        look_at=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=90.0,
        width=width,
        height=height,
    )
    kwargs = dict(
        max_bounces=50,
        background=((1.0, 1.0, 1.0), (0.5, 0.7, 1.0)),
    )
    return world, camera, kwargs


def mixed_materials(width: int = 32, height: int = 24) -> Tuple[World, Camera, Dict]:
    """The fused diff kernel's parity scene (tests/test_diffkernel.py
    `_mixed_world`): every material kind and a quad light, so each
    gradient chain (metal fuzz, dielectric ior, emission, NEE) is live."""
    world = World()
    world.add_material("ground", Lambertian((0.6, 0.5, 0.4)))
    world.add_material("met", Metal((0.8, 0.8, 0.9), 0.3))
    world.add_material("glass", Dielectric((0.95, 0.95, 0.95), 1.5))
    world.add_material("lamp", Light((10.0, 10.0, 10.0)))
    world.add_geometry(Sphere((0.0, -100.5, -1.0), 100.0, "ground"))
    world.add_geometry(Sphere((-0.7, 0.0, -1.2), 0.5, "met"))
    world.add_geometry(Sphere((0.7, 0.0, -1.2), 0.5, "glass"))
    world.add_geometry(Quad((-1.5, 2.0, -2.5), (3.0, 0.0, 0.0), (0.0, 0.0, 2.0), "lamp"))
    camera = Camera.new(
        focus_distance=1.0,
        defocus_angle=0.0,
        position=(0.0, 0.3, 1.0),
        look_at=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        vertical_fov=60.0,
        width=width,
        height=height,
    )
    kwargs = dict(max_bounces=5, background=(0.05, 0.06, 0.08))
    return world, camera, kwargs


PRESETS = {
    "sphere_ground": sphere_ground,
    "three_spheres": three_spheres,
    "five_quads": five_quads,
    "cornell_box": cornell_box,
    "cornell_spheres": cornell_spheres,
    "random_spheres": random_spheres,
    "rtiow_sky": rtiow_sky,
}
