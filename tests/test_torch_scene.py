"""PyTorch port's scene API and host lowering against the JAX package.

Scene arrays, compaction, payload, scene table, camera vector and
material flags are computed with numpy on both sides and must be bitwise
equal. Camera frames are f32 math in two frameworks: within 1 ulp.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models import camera as jcam
from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.ops import intersect_pallas as jip
from tinyraytracer_tpu.ops import megakernel as jmk
from tinyraytracer_tpu.ops import megakernel_packed as jmkp
from tinyraytracer_tpu_torch import Lambertian, Sphere, World, scene_from_numpy
from tinyraytracer_tpu_torch.models import camera as tcam
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.ops import scene_table as st

PRESETS = sorted(jpresets.PRESETS)
_CAM_FIELDS = ("position", "viewport_upper_left", "forward", "horizontal",
               "vertical", "defocus_disk_u", "defocus_disk_v")


def _pair(name, width=16, height=12):
    return (jpresets.PRESETS[name](width=width, height=height),
            tpresets.PRESETS[name](width=width, height=height))


def _jax_leaves(scene) -> dict:
    return {f.name: np.asarray(getattr(scene, f.name))
            for f in dataclasses.fields(scene)}


def _ulps(a, b) -> int:
    """Largest distance in units in the last place between two f32 arrays."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max())


@pytest.mark.parametrize("name", PRESETS)
def test_world_build_equals_jax(name):
    (jw, _, _), (tw, _, _) = _pair(name)
    want = _jax_leaves(jw.build())
    got = tw.build().numpy()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_is_cached_per_version():
    _, (tw, _, _) = _pair("three_spheres")
    a = tw.build()
    assert tw.build() is a
    tw.add_geometry(Sphere((0.0, 3.0, -1.0), 0.25, "center"))
    b = tw.build()
    assert b is not a and int(b.sph_valid.sum()) == 6


def test_scene_from_numpy_round_trip():
    """JAX leaves -> port SceneArrays -> numpy is the identity, and a
    converted JAX scene equals the port's own World.build()."""
    (jw, _, _), (tw, _, _) = _pair("cornell_box")
    leaves = _jax_leaves(jw.build())
    scene = scene_from_numpy(leaves, "cpu")
    back = scene.numpy()
    own = tw.build().numpy()
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        np.testing.assert_array_equal(own[k], v, err_msg=k)
        assert back[k].dtype == v.dtype
    with pytest.raises(TypeError):
        scene_from_numpy({**leaves, "sph_mat": leaves["sph_mat"] * 1.0},
                         "cpu")
    with pytest.raises(KeyError):
        scene_from_numpy({k: v for k, v in leaves.items()
                          if k != "mat_ior"}, "cpu")


@pytest.mark.parametrize("case", ["duplicate", "unknown", "empty"])
def test_world_errors(case):
    w = World()
    if case == "duplicate":
        w.add_material("a", Lambertian((0.5, 0.5, 0.5)))
        with pytest.raises(ValueError):
            w.add_material("a", Lambertian((0.1, 0.1, 0.1)))
    elif case == "unknown":
        w.add_material("a", Lambertian((0.5, 0.5, 0.5)))
        w.add_geometry(Sphere((0.0, 0.0, 0.0), 1.0, "nope"))
        with pytest.raises(KeyError):
            w.build()
    else:
        with pytest.raises(ValueError):
            w.build()


@pytest.mark.parametrize("name", PRESETS)
def test_lowering_bitwise(name):
    """compact_scene, payload, scene_table, camera vector and material
    flags equal the JAX functions bit for bit."""
    (jw, jc, kw), (tw, tc, tkw) = _pair(name)
    js, ts = jw.build(), tw.build()
    jcs, tcs = jip.compact_scene(js), st.compact_scene(ts)
    for f in ("sph_c", "sph_r2", "quad_n", "quad_dp", "quad_av", "quad_ca",
              "quad_bv", "quad_cb", "index_map"):
        np.testing.assert_array_equal(getattr(tcs, f),
                                      np.asarray(getattr(jcs, f)), err_msg=f)
    assert (tcs.n_sph_real, tcs.n_quad_real) == (jcs.n_sph_real,
                                                 jcs.n_quad_real)
    jpay = np.asarray(jmk._payload_matrix(js, jcs))
    tpay = st.payload_matrix(ts, tcs)
    np.testing.assert_array_equal(tpay, jpay)
    jtab, jprims = jmkp.scene_table(jcs, jpay)
    ttab, tprims = st.scene_table(tcs, tpay)
    np.testing.assert_array_equal(ttab, jtab)
    assert tprims == jprims
    np.testing.assert_array_equal(
        st.camera_vector(tc, tkw["background"]),
        np.asarray(jmk._camera_vector(jc, kw["background"])))
    assert st.used_kind_flags(ts) == jmk.used_kind_flags(js)


@pytest.mark.parametrize("name", PRESETS)
def test_camera_new_within_one_ulp(name):
    (_, jc, _), (_, tc, _) = _pair(name, 40, 30)
    for f in _CAM_FIELDS:
        got = getattr(tc, f)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
        assert _ulps(got.numpy(), np.asarray(getattr(jc, f))) <= 1, f
    assert (tc.width, tc.height) == (jc.width, jc.height)


def test_camera_from_numpy_round_trip():
    (_, jc, _), _ = _pair("cornell_box")
    fields = {f: np.asarray(getattr(jc, f)) for f in _CAM_FIELDS}
    c = tcam.Camera.from_numpy(fields, jc.width, jc.height)
    for f in _CAM_FIELDS:
        np.testing.assert_array_equal(getattr(c, f).numpy(), fields[f])
    with pytest.raises(ValueError):
        tcam.Camera.from_numpy({**fields, "forward": np.zeros(3)}, 4, 4)


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box"])
def test_generate_rays_agree(name):
    """Rays from the same camera fields and counters: origins within
    2e-5 and unit directions within 2e-6 absolute. Both sides draw the
    same uniforms; sin/cos/sqrt and the normalisation's reduction order
    differ by an ulp or two between the frameworks, and Cornell's
    origins sit ~140 units from zero (ulp 1.5e-5)."""
    (_, jc, _), _ = _pair(name, 24, 18)
    fields = {f: np.asarray(getattr(jc, f)) for f in _CAM_FIELDS}
    tc = tcam.Camera.from_numpy(fields, jc.width, jc.height)
    pid = np.arange(jc.width * jc.height, dtype=np.uint32)
    jo, jd = jcam.generate_rays(jc, jnp.asarray(pid), jnp.uint32(5),
                                jnp.uint32(3))
    to, td = tcam.generate_rays(tc, torch.from_numpy(pid.astype(np.int64)),
                                5, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2e-6)
    norms = np.linalg.norm(td.numpy(), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)
