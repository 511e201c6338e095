"""PyTorch port's batch and asynchronous render entry points on the CPU:
`Renderer.render_batch` and `Renderer.render_async` give, frame for frame,
the image `Renderer.render` gives with the same seed. The card's versions
of these checks are in tests/test_torch_cuda.py."""

import numpy as np
import pytest

from tinyraytracer_tpu_torch import Image, Renderer, RenderHandle
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.utils import profiling

# one scene for each kernel route: packed (K1) and classic layout (K2)
SCENES = [("sphere_ground", {}), ("random_spheres", dict(n=60))]


def _setup(name, pkw, seed=0):
    world, camera, kw = presets.PRESETS[name](width=12, height=8, **pkw)
    r = Renderer(2, max_bounces=4, background_color=kw["background"],
                 seed=seed, device="cpu")
    return r, world, camera


@pytest.mark.parametrize("name, pkw", SCENES)
def test_render_batch_frames_equal_single_renders(name, pkw):
    r, world, camera = _setup(name, pkw, seed=7)
    before = (profiling.counter("launches.render_packed"),
              profiling.counter("launches.render_flat"))
    frames = r.render_batch(camera, world, [3, 0, 3])
    assert len(frames) == 3 and all(isinstance(f, Image) for f in frames)
    for s, img in zip([3, 0, 3], frames):
        single, _, _ = _setup(name, pkw, seed=s)
        np.testing.assert_array_equal(img.data,
                                      single.render(camera, world).data)
    assert not np.array_equal(frames[0].data, frames[1].data)
    assert r.seed == 7                      # the renderer's seed is kept
    assert (profiling.counter("launches.render_packed"),
            profiling.counter("launches.render_flat")) == before
    assert r.render_batch(camera, world, []) == []


@pytest.mark.parametrize("name, pkw", SCENES)
def test_render_async_result_equals_render(name, pkw):
    """On the CPU the render is finished when the handle is made, and
    done() says so."""
    r, world, camera = _setup(name, pkw, seed=4)
    handle = r.render_async(camera, world)
    assert isinstance(handle, RenderHandle)
    assert handle.done()
    img = handle.result()
    np.testing.assert_array_equal(img.data, r.render(camera, world).data)
    assert handle.done()
