"""PyTorch port's public surface: Renderer, Image/PNG, CLI, device rules,
and that the port never imports JAX."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from tinyraytracer_tpu_torch import Image, Renderer
from tinyraytracer_tpu_torch.__main__ import main as cli_main
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops import megakernel_packed as mkp
from tinyraytracer_tpu_torch.ops import tonemap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decode_png(blob: bytes) -> np.ndarray:
    """Minimal decoder for what the writer emits: 8-bit RGB, filter 0."""
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", data)
            assert (depth, ctype) == (8, 2)
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_render_matches_kernel_twin():
    world, camera, kw = presets.three_spheres(width=20, height=14)
    r = Renderer(3, max_bounces=4, background_color=kw["background"],
                 seed=2, device="cpu")
    img = r.render(camera, world)
    assert isinstance(img, Image) and img.size() == (20, 14)
    m = mk.MegakernelRenderer(world.build(), camera, kw["background"], "cpu")
    low = m.lowered
    fb = mkp.render_packed_reference(
        m.table, m.cam, n_sph=low.n_sph, n_quad=low.n_quad, width=20,
        height=14, spp=3, max_bounces=4, seed=2, has_met=low.has_met,
        has_die=low.has_die, sky=low.sky)
    np.testing.assert_array_equal(
        img.data, np.maximum(fb.numpy(), 0.0) ** (1.0 / tonemap.GAMMA))


def test_progress_rounds_partition_samples(capsys):
    world, camera, kw = presets.cornell_box(width=12, height=12)
    args = dict(max_bounces=3, background_color=kw["background"], seed=4,
                device="cpu")
    one = Renderer(6, **args).render_array(camera, world.build())
    rounds = Renderer(6, progressbar=True, spp_per_round=2, **args)
    img = rounds.render(camera, world)
    assert "6/6 spp" in capsys.readouterr().err
    np.testing.assert_allclose(
        img.data, np.maximum(one.numpy(), 0) ** (1 / tonemap.GAMMA),
        atol=1e-5)


def test_png_round_trip(tmp_path):
    rgb = np.random.default_rng(0).random((7, 5, 3)).astype(np.float32)
    img = Image(rgb)
    path = tmp_path / "x.png"
    img.save(str(path))
    np.testing.assert_array_equal(_decode_png(path.read_bytes()),
                                  img.to_u8())


def test_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "cli.png"
    rc = cli_main(["--preset", "sphere_ground", "--width", "10", "--height",
                   "8", "--spp", "2", "--max-bounces", "3", "--device",
                   "cpu", "--out", str(out)])
    assert rc == 0
    assert _decode_png(out.read_bytes()).shape == (8, 10, 3)
    assert "Mrays/s" in capsys.readouterr().out


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """Without CUDA the default device raises; it does not render on the
    CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--width", "4", "--height", "4", "--spp", "1"])


@pytest.mark.parametrize("device,want", [
    ("cuda", dict(devices=[torch.device("cuda", 0), torch.device("cuda", 1)],
                  device=None)),
    ("cuda:1", dict(devices=None, device="cuda:1")),
    ("cpu", dict(devices=None, device="cpu")),
])
def test_cli_mesh_only_for_bare_cuda(monkeypatch, device, want):
    """On a two-card machine, --device cuda renders over a mesh of every
    card, while --device cuda:k names one card, which is used alone."""
    from tinyraytracer_tpu_torch import renderer

    seen = {}

    class Stop(Exception):
        pass

    def recording(*a, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(renderer, "Renderer", recording)
    with pytest.raises(Stop):
        cli_main(["--width", "4", "--height", "4", "--spp", "2",
                  "--sample-parallel", "2", "--device", device])
    assert {k: seen[k] for k in want} == want
    assert seen["sample_parallel"] == 2


@pytest.mark.parametrize("kw", [
    dict(accelerator="bvh"), dict(accelerator="none", devices=["cpu", "cpu"]),
    dict(devices=["cpu", "cpu"]), dict(sample_parallel=2),
])
def test_unported_options_raise(kw):
    """Every option is ported now. accelerator="bvh" (ops/bvh.py) renders
    the dense modular image (accelerator="none") bit for bit on the CPU.
    Multi-device rendering (parallel/sharded.py): a mesh of two CPU cells
    renders the one-device image bit for bit on the modular route
    (accelerator="none") and on the megakernel's, and sample_parallel=2
    on one device only checks that spp divides, as in the JAX package."""
    world, camera, pkw = presets.cornell_box(width=12, height=10)
    if kw.get("accelerator") == "bvh":
        common = dict(max_bounces=3, background_color=pkw["background"],
                      seed=2, device="cpu")
        got = Renderer(4, **common, **kw).render_array(camera, world.build())
        want = Renderer(4, accelerator="none", **common).render_array(
            camera, world.build())
        assert torch.equal(got, want)
        return
    common = dict(max_bounces=3, background_color=pkw["background"], seed=2,
                  accelerator=kw.get("accelerator", "auto"))
    want = Renderer(4, device="cpu", **common).render_array(camera,
                                                            world.build())
    r = Renderer(4, **{**common, **kw},
                 **({} if "devices" in kw else {"device": "cpu"}))
    assert (r.mesh is None) == ("devices" not in kw)
    assert torch.equal(r.render_array(camera, world.build()), want)
    with pytest.raises(ValueError, match="divisible"):
        Renderer(3, **{**common, **kw, "sample_parallel": 2},
                 **({} if "devices" in kw else {"device": "cpu"}))


def test_unported_entry_points_raise():
    """An unknown accelerator is refused (render_batch and render_async
    are ported: tests/test_torch_render_api.py)."""
    with pytest.raises(ValueError):
        Renderer(1, device="cpu", accelerator="warp")


def test_port_imports_no_jax():
    """With `jax` made unimportable, the port imports (Ray, Transform,
    ops/bvh.py and the profiler too) and renders 8x6 on the CPU, with the
    megakernel's twin and with the BVH, and neither JAX nor the JAX
    package gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import tinyraytracer_tpu_torch as t\n"
        "from tinyraytracer_tpu_torch import Ray, Transform\n"
        "from tinyraytracer_tpu_torch.ops import bvh\n"
        "from tinyraytracer_tpu_torch.utils import profiling\n"
        "from tinyraytracer_tpu_torch.models import presets\n"
        "w, c, kw = presets.cornell_box(width=8, height=6)\n"
        "img = t.Renderer(2, max_bounces=3, background_color=kw['background'],"
        " device='cpu').render(c, w)\n"
        "assert img.data.shape == (6, 8, 3)\n"
        "img = t.Renderer(2, max_bounces=3, background_color=kw['background'],"
        " device='cpu', accelerator='bvh').render(c, w)\n"
        "assert img.data.shape == (6, 8, 3)\n"
        "assert Transform.translate((1, 2, 3), 'cpu').apply([0.0, 0, 0])"
        ".shape == (3,)\n"
        "assert Ray.new([0.0, 0, 0], [0.0, 2, 0], 'cpu').at(1.0)[1] == 1.0\n"
        "bad = [m for m in sys.modules if m == 'tinyraytracer_tpu' or "
        "m.startswith(('tinyraytracer_tpu.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_tonemap_matches_jax():
    """Gamma within 2 ulp at unit scale (pow differs by an ulp between the
    frameworks' libraries); u8 quantisation equal on the same input."""
    import jax.numpy as jnp

    from tinyraytracer_tpu.ops import tonemap as jtonemap

    x = np.random.default_rng(3).random((64, 48, 3), dtype=np.float32) * 1.5
    x[0, 0] = -0.25
    g = tonemap.gamma_correct(torch.from_numpy(x))
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jtonemap.gamma_correct(jnp.asarray(x))),
        rtol=0, atol=2 * 2.0**-23 * 1.5)
    np.testing.assert_array_equal(
        tonemap.to_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jtonemap.to_u8(jnp.asarray(x))))
