"""The port's entry points take the reference's calls: the same positional
parameters bind the same way, or the call raises.

- `MegakernelRenderer(scene, camera, background)` (the JAX package's
  three-argument form, bench.py:66) builds a renderer bound to the card
  and launches nothing until `render`.
- `ops/trace.trace` takes the reference's positional parameters through
  `compact` (tinyraytracer_tpu/ops/trace.py:49-60); the rest are keyword
  only, so a positional `nee` raises instead of landing elsewhere.

On the CPU, at 8x6: the images and radiances are compared bit for bit.
"""

import inspect

import pytest
import torch

from tinyraytracer_tpu.ops import trace as jtr
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import bvh as tbvh
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops import trace as ttr
from tinyraytracer_tpu_torch.parallel import sharded
from tinyraytracer_tpu_torch.utils import profiling

W, H = 8, 6


@pytest.fixture(scope="module")
def spheres():
    world, camera, kw = presets.three_spheres(width=W, height=H)
    return world.build(), camera, kw["background"]


def _launches():
    return (profiling.counter("launches.render_packed")
            + profiling.counter("launches.render_flat"))


def test_megakernel_renderer_defaults_to_the_card(spheres):
    """Three arguments, as the reference takes them: bound to the card,
    nothing lowered onto it and nothing launched."""
    scene, camera, bg = spheres
    before = _launches()
    r = mk.MegakernelRenderer(scene, camera, bg)
    assert r.device.type == "cuda"
    assert r._copies == {}
    assert _launches() == before


def test_megakernel_renderer_on_the_cpu_renders_as_before(spheres):
    """device="cpu" by keyword renders the four-argument call's image, and
    the three-argument renderer gives the same image through a CPU mesh
    cell."""
    scene, camera, bg = spheres
    kw = dict(spp=2, max_bounces=3, seed=1)
    want = mk.MegakernelRenderer(scene, camera, bg, "cpu").render(**kw)
    got = mk.MegakernelRenderer(scene, camera, bg, device="cpu").render(**kw)
    three = mk.MegakernelRenderer(scene, camera, bg).render(
        mesh=sharded.one_cell("cpu"), **kw)
    assert want.shape == (H, W, 3) and bool(torch.isfinite(want).all())
    assert torch.equal(got, want)
    assert torch.equal(three, want)


def test_trace_positional_parameters_are_the_references():
    """Each parameter the port takes by position has the reference's name
    at that position; the rest are keyword only."""
    port = inspect.signature(ttr.trace).parameters.values()
    ref = list(inspect.signature(jtr.trace).parameters)
    positional = [p.name for p in port
                  if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD]
    assert positional == ref[:len(positional)]
    assert positional[-2:] == ["bvh", "compact"]
    keyword = {p.name for p in port if p.kind == inspect.Parameter.KEYWORD_ONLY}
    assert keyword == {"nee", "silhouette", "count_alive", "tape", "rows"}


@pytest.fixture(scope="module")
def wavefront(spheres):
    scene, camera, bg = spheres
    pid = torch.arange(W * H)
    o, d = generate_rays(camera, pid, 0, 0)
    bg = torch.as_tensor(bg, dtype=torch.float32)
    return scene, o, d, pid, bg, tbvh.build_bvh(scene)


def test_trace_reference_positional_call_binds_bvh(wavefront):
    """trace(scene, o, d, pid, 0, 0, 4, bg, False, True, bvh), the
    reference's positional form: the BVH is walked, and the radiance is
    the keyword call's bit for bit."""
    scene, o, d, pid, bg, bvh = wavefront
    with torch.no_grad():
        walks = tbvh.walk_counts.walks
        got = ttr.trace(scene, o, d, pid, 0, 0, 4, bg, False, True, bvh)
        assert tbvh.walk_counts.walks > walks
        want = ttr.trace(scene, o, d, pid, 0, 0, 4, bg, exact=False,
                         remat=True, bvh=bvh)
    assert got.shape == (W * H, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_trace_positional_nee_raises(wavefront):
    """The reference's 13th positional parameter is `interpret`, its 14th
    `nee`: past `compact` the port takes no positional argument."""
    scene, o, d, pid, bg, bvh = wavefront
    with pytest.raises(TypeError):
        ttr.trace(scene, o, d, pid, 0, 0, 4, bg, False, True, bvh, None, True)
