"""Scene descriptions from configuration files, and the port's scene
built from one.

A configuration's `scene` is either a description itself (materials,
geometry, camera, background) or names a generator here that draws one
from its parameters. The description is plain data: the harness builds
the system's World and Camera from it through the public API, and the
reference (perfbench/reference/) lowers it on its own.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def _rtiow_final(p: dict) -> dict:
    """Ray Tracing in One Weekend's final scene: the ground, three large
    spheres (glass, diffuse, metal) and small spheres of random material
    on a grid, drawn by numpy default_rng(layout_seed)."""
    rng = np.random.default_rng(int(p["layout_seed"]))
    n = int(p["n_spheres"])
    mats = [{"name": "ground", "kind": "lambertian", "albedo": [0.5, 0.5, 0.5]},
            {"name": "glass", "kind": "dielectric", "albedo": [1.0, 1.0, 1.0],
             "ior": 1.5},
            {"name": "big_diffuse", "kind": "lambertian",
             "albedo": [0.4, 0.2, 0.1]},
            {"name": "big_metal", "kind": "metal", "albedo": [0.7, 0.6, 0.5],
             "fuzz": 0.0}]
    sph = lambda c, r, m: {"sphere": {"center": list(c),  # noqa: E731
                                      "radius": r, "material": m}}
    geo = [sph((0.0, -1000.0, 0.0), 1000.0, "ground"),
           sph((0.0, 1.0, 0.0), 1.0, "glass"),
           sph((-4.0, 1.0, 0.0), 1.0, "big_diffuse"),
           sph((4.0, 1.0, 0.0), 1.0, "big_metal")]
    count = 0
    grid = int(math.ceil(math.sqrt(max(1, n - 4))))
    for a in range(-grid // 2, grid - grid // 2):
        for b in range(-grid // 2, grid - grid // 2):
            if count >= n - 4:
                break
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
                continue
            choice = rng.random()
            name = f"m{count}"
            if choice < 0.8:
                mats.append({"name": name, "kind": "lambertian",
                             "albedo": (rng.random(3) * rng.random(3)).tolist()})
            elif choice < 0.95:
                mats.append({"name": name, "kind": "metal",
                             "albedo": (0.5 + 0.5 * rng.random(3)).tolist(),
                             "fuzz": 0.5 * rng.random()})
            else:
                mats.append({"name": name, "kind": "dielectric",
                             "albedo": [1.0, 1.0, 1.0], "ior": 1.5})
            geo.append(sph(center, 0.2, name))
            count += 1
    return {"materials": mats, "geometry": geo}


GENERATORS = {"rtiow_final": _rtiow_final}


def load_config(path) -> dict:
    with open(ROOT.parent / path) as f:
        return json.load(f)


def description(config: dict) -> dict:
    """The scene description of a configuration."""
    scene = dict(config["scene"])
    gen = scene.pop("generator", None)
    if gen is not None:
        scene.update(GENERATORS[gen](scene))
    return scene


def port_scene(desc: dict, width: int, height: int):
    """(World, Camera) of the system under test, built from the
    description through its public API."""
    import tinyraytracer_tpu_torch as rt

    world = rt.World()
    for m in desc["materials"]:
        kind = m["kind"]
        if kind == "lambertian":
            mat = rt.Lambertian(tuple(m["albedo"]))
        elif kind == "metal":
            mat = rt.Metal(tuple(m["albedo"]), m.get("fuzz", 0.0))
        elif kind == "dielectric":
            mat = rt.Dielectric(tuple(m["albedo"]), m["ior"])
        elif kind == "light":
            mat = rt.Light(tuple(m["emission"]))
        else:
            raise ValueError(f"unknown material kind {kind!r}")
        world.add_material(m["name"], mat)
    for g in desc["geometry"]:
        if "sphere" in g:
            s = g["sphere"]
            world.add_geometry(rt.Sphere(tuple(s["center"]), s["radius"],
                                         s["material"]))
        elif "quad" in g:
            q = g["quad"]
            world.add_geometry(rt.Quad(tuple(q["corner"]), tuple(q["u"]),
                                       tuple(q["v"]), q["material"]))
        else:
            b = g["box"]
            world.add_geometry(rt.make_box(tuple(b["a"]), tuple(b["b"]),
                                           b["material"]))
    c = desc["camera"]
    camera = rt.Camera.new(
        focus_distance=c["focus_distance"], defocus_angle=c["defocus_angle"],
        position=tuple(c["position"]), look_at=tuple(c["look_at"]),
        up=tuple(c["up"]), vertical_fov=c["vertical_fov"], width=width,
        height=height)
    return world, camera
