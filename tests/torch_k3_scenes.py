"""The closest-hit kernel K3's edge scenes, one builder for its CPU tests
(tests/test_torch_k3_plan.py) and its card tests (tests/test_torch_cuda.py),
and the benchmark's scenes for K2's tests."""

import json
import os
import sys

from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.models.geometry import Sphere
from tinyraytracer_tpu_torch.models.materials import Lambertian


def k3_world(name, n=None, extra=0, coincident=False, width=32, height=24):
    """A preset's world (random_spheres' `n` when given) with `extra`
    small spheres in a grid inside the Cornell box, or with a copy of its
    last sphere under another material after it (of the two coincident
    rows the first must win every tie). Returns (world, camera, kw)."""
    kw = {} if n is None else dict(n=n)
    world, camera, pkw = presets.PRESETS[name](width=width, height=height,
                                               **kw)
    if extra or coincident:
        world.add_material("k3_extra", Lambertian((0.3, 0.5, 0.7)))
    for k in range(extra):
        world.add_geometry(Sphere((10.0 + 12.0 * (k % 7),
                                   8.0 + 12.0 * (k // 7), 70.0), 4.0,
                                  "k3_extra"))
    if coincident:
        last = [g for g in world.geometries if isinstance(g, Sphere)][-1]
        world.add_geometry(Sphere(last.center, last.radius, "k3_extra"))
    return world, camera, pkw


def bench_world(config, width, height):
    """The benchmark's scene `config` (perfbench/configs/) through the
    port's public API, at width x height: (world, camera, kw), kw holding
    its background."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from perfbench import scenes

    with open(os.path.join(root, "perfbench", "configs",
                           f"{config}.json")) as f:
        desc = scenes.description(json.load(f))
    world, camera = scenes.port_scene(desc, width, height)
    return world, camera, dict(background=tuple(desc["background"]))
