"""The port's examples (examples/torch_inverse_render.py and
examples/torch_manysphere_fit.py) on the CPU at a tiny size, with jax and
optax made unimportable, and their scenes against the JAX examples'
recipes, built inline here (examples/manysphere_fit.py is not imported: it
sets a compilation-cache directory inside the repository).
"""

import os
import runpy
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.models.geometry import Quad as JQuad
from tinyraytracer_tpu.models.materials import Light as JLight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INVERSE = os.path.join(REPO, "examples", "torch_inverse_render.py")
MANYSPHERE = os.path.join(REPO, "examples", "torch_manysphere_fit.py")
INVERSE_TINY = ["--device", "cpu", "--size", "12", "--spp", "2",
                "--target-spp", "2", "--refine-spp", "0", "--steps", "3",
                "--max-bounces", "2"]
MANYSPHERE_TINY = ["--device", "cpu", "--size", "8", "--spp", "1",
                   "--steps", "2"]

_NO_JAX = (
    "import sys\n"
    "sys.modules['jax'] = sys.modules['optax'] = None\n"
    "import runpy\n")
_CHECK_NO_JAX = (
    "bad = [m for m in sys.modules if m == 'tinyraytracer_tpu' or "
    "m.startswith(('tinyraytracer_tpu.', 'jax.', 'jaxlib', 'optax.'))]\n"
    "assert not bad, bad\n")


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def _run_main(path: str, argv: list) -> subprocess.CompletedProcess:
    return _run(_NO_JAX
                + f"sys.argv = {[os.path.basename(path)] + argv!r}\n"
                + f"runpy.run_path({path!r}, run_name='__main__')\n"
                + _CHECK_NO_JAX)


def test_inverse_example_runs_without_jax(tmp_path):
    out = str(tmp_path / "inverse")
    proc = _run_main(INVERSE, INVERSE_TINY + ["--out", out])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for want in ("true centers:", "engine: modular", "step    0  loss",
                 "step    2  loss", "recovered centers:",
                 "max center error:", "recovered albedos"):
        assert any(line.startswith(want) for line in lines), want
    for png in ("target.png", "initial.png", "fitted.png"):
        with open(os.path.join(out, png), "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", png


def test_inverse_example_resumes_bit_for_bit(tmp_path):
    """The fused engine (K5's twin) over 52 steps with a checkpoint: a
    second run resumes at step 50 through load_checkpoint(path,
    opt_state), and its losses and last iterate equal the first run's
    bit for bit (the refine phase starts at 41 in both)."""
    argv = ["--device", "cpu", "--size", "8", "--spp", "1", "--target-spp",
            "1", "--refine-spp", "2", "--steps", "52", "--max-bounces", "2",
            "--engine", "fused", "--checkpoint", str(tmp_path / "fit.ckpt"),
            "--out", str(tmp_path / "inverse")]
    proc = _run(
        _NO_JAX + "import torch\n"
        f"main = runpy.run_path({INVERSE!r})['main']\n"
        f"a = main({argv!r})\n"
        f"b = main({argv!r})\n"
        "assert a['engine'] == 'fused' and a['start'] == 0, a['start']\n"
        "assert b['start'] == 50 and len(b['losses']) == 2\n"
        "assert b['losses'] == a['losses'][50:], (a['losses'], b)\n"
        "for k, v in a['last_params'].items():\n"
        "    assert torch.equal(v, b['last_params'][k]), k\n"
        + _CHECK_NO_JAX + "print('resumed ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert "resumed from step 50" in proc.stdout
    assert proc.stdout.strip().endswith("resumed ok")


def test_manysphere_example_runs_without_jax():
    proc = _run_main(MANYSPHERE, MANYSPHERE_TINY)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("scene: 128 spheres; training row")
    assert any(line.startswith("step   1  loss") for line in lines)
    assert any(line.startswith("final position error:") for line in lines)
    assert lines[-1] == "max untrained-row drift: 0.0 (must be 0.0)"


def _jax_manysphere_build(offset, n=128, width=128, height=128):
    """examples/manysphere_fit.py's build()."""
    world, cam, kw = jpresets.random_spheres(width=width, height=height, n=n)
    world.add_material("lamp", JLight((12.0, 12.0, 12.0)))
    world.add_geometry(JQuad((-4.0, 11.99, -4.0), (8.0, 0.0, 0.0),
                             (0.0, 0.0, 8.0), "lamp"))
    scene = world.build()
    centers = np.asarray(scene.sph_center)
    valid = np.asarray(scene.sph_valid)
    rows = np.nonzero(valid)[0]
    target_row = int(rows[np.argmin(np.linalg.norm(
        centers[rows] - np.array([-4.0, 1.0, 0.0]), axis=-1))])
    scene = scene.replace(sph_center=scene.sph_center.at[target_row, 2].add(
        float(offset)))
    return scene, cam, kw, target_row


@pytest.mark.parametrize("offset", [0.0, 1.5])
def test_manysphere_build_equals_jax_recipe(offset):
    build = runpy.run_path(MANYSPHERE)["build"]
    ts, _, _, trow = build(offset, width=8, height=8)
    js, _, _, jrow = _jax_manysphere_build(offset, width=8, height=8)
    assert trow == jrow
    for f, want in js.__dict__.items():
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(want), err_msg=f)


def test_inverse_perturbed_scene_equals_jax_recipe():
    """examples/inverse_render.py's perturbation of cornell_spheres."""
    from tinyraytracer_tpu_torch.models import presets as tpresets

    perturb = runpy.run_path(INVERSE)["perturb"]
    scene = jpresets.cornell_spheres(width=8, height=8)[0].build()
    s_valid = np.asarray(scene.sph_valid)
    want = scene.replace(
        sph_center=scene.sph_center
        + jnp.where(jnp.asarray(s_valid)[:, None],
                    jnp.asarray([[2.5, -1.5, 3.0]], jnp.float32), 0.0),
        mat_albedo=scene.mat_albedo.at[4].set(jnp.asarray([0.6, 0.2, 0.3]))
        .at[5].set(jnp.asarray([0.3, 0.3, 0.7])))
    got = perturb(tpresets.cornell_spheres(width=8, height=8)[0].build())
    for f, w in want.__dict__.items():
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(w), err_msg=f)
