"""The port's last public names against the JAX package: SceneArrays.replace,
num_spheres and num_quads; intersect_scene and its gradients;
MegakernelRenderer.render_burst on the kernels' CPU twins; and
profiling.trace around a region that raises.

Inputs are made with numpy from a seed (or JAX's own camera rays) and fed
to both sides; torch runs single-threaded next to JAX (see
tests/test_torch_intersect.py). Tolerances are test_torch_intersect.py's:
winners and hit masks equal, t within T_RTOL (the sphere discriminant's
cancellation turns XLA's fused multiply-adds into tens of ulps),
derived vectors within VEC_ATOL. Gradients through intersect_scene within
GRAD_RTOL of each field's largest entry (measured: 1.0e-7 at most, both
scenes).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.models.camera import generate_rays as jgenerate_rays
from tinyraytracer_tpu.models.geometry import Quad as JQuad
from tinyraytracer_tpu.models.geometry import Sphere as JSphere
from tinyraytracer_tpu.models.materials import Lambertian as JLambertian
from tinyraytracer_tpu.models.world import World as JWorld
from tinyraytracer_tpu.ops import intersect as jis
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.models.geometry import Quad as TQuad
from tinyraytracer_tpu_torch.models.geometry import Sphere as TSphere
from tinyraytracer_tpu_torch.models.materials import Lambertian as TLambertian
from tinyraytracer_tpu_torch.models.world import World as TWorld
from tinyraytracer_tpu_torch.ops import intersect as tis
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.parallel.sharded import make_mesh
from tinyraytracer_tpu_torch.utils import profiling

T_RTOL = 1e-5
VEC_ATOL = 1e-5
GRAD_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# --- SceneArrays --------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("cornell_spheres", {}),
                                     ("random_spheres", {"n": 40})])
def test_scene_replace_and_padded_counts_match_jax(name, kw):
    js = jpresets.PRESETS[name](width=8, height=8, **kw)[0].build()
    ts = tpresets.PRESETS[name](width=8, height=8, **kw)[0].build()
    # the padded row counts, as JAX gives them: not the valid counts
    assert ts.num_spheres == js.num_spheres == ts.sph_center.shape[0]
    assert ts.num_quads == js.num_quads == ts.quad_corner.shape[0]
    assert ts.num_spheres > int(ts.sph_valid.sum())
    rs = np.random.RandomState(1)
    c = rs.normal(size=(js.num_spheres, 3)).astype(np.float32)
    a = rs.uniform(size=js.mat_albedo.shape).astype(np.float32)
    jr = js.replace(sph_center=jnp.asarray(c), mat_albedo=jnp.asarray(a))
    tc, ta = torch.from_numpy(c), torch.from_numpy(a)
    tr = ts.replace(sph_center=tc, mat_albedo=ta)
    # no tensor is copied, and the original is unchanged
    assert tr.sph_center is tc and tr.mat_albedo is ta
    assert tr.quad_u is ts.quad_u and ts.sph_center is not tc
    for f, want in jr.__dict__.items():
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(want), err_msg=f)


# --- intersect_scene ----------------------------------------------------

def _worlds(geoms):
    """The same scene in both packages from (kind, args) specs."""
    out = []
    for world, sphere, quad, lamb in ((JWorld, JSphere, JQuad, JLambertian),
                                      (TWorld, TSphere, TQuad, TLambertian)):
        w = world()
        w.add_material("m", lamb((0.5, 0.5, 0.5)))
        for kind, args in geoms:
            w.add_geometry((sphere if kind == "s" else quad)(*args, "m"))
        out.append(w.build())
    return out


def _random_case():
    rng = np.random.default_rng(0)
    geoms = [("s", (tuple(rng.uniform(-5, 5, 3).tolist()),
                    float(rng.uniform(0.2, 2.0)))) for _ in range(40)]
    o = rng.uniform(-8, 8, (512, 3))
    d = rng.normal(size=(512, 3))
    return geoms, list(zip(o.tolist(), d.tolist())), 1e-3


# tests/test_intersect.py's scenes and rays: (geometry, (o, d) pairs, t_min)
INTERSECT_CASES = {
    "sphere": ([("s", ((0.0, 0.0, -1.0), 0.5))],
               [([0, 0, 0], [0, 0, -1]), ([0, 0, 0], [0, np.sqrt(3.0), -3]),
                ([0, 0, 0], [0, -1, -1])], 0.0),
    "inside sphere": ([("s", ((0.0, 0.0, 0.0), 1.0))],
                      [([0, 0, 0], [0, 0, -1])], 1e-3),
    "quad": ([("q", ((0, 0, 0), (1, 0, 0), (0, 0, 3)))],
             [([0, 1, 0], [0, -1, 0]), ([0, 1, 1], [0, -1, -1]),
              ([0, 1, 1], [0, -1, -1.1])], 0.0),
    "quad half-open": ([("q", ((0, 0, 0), (1, 0, 0), (0, 0, 1)))],
                       [([0.0, 1.0, 0.0], [0, -1, 0]),
                        ([1.0, 1.0, 0.5], [0, -1, 0]),
                        ([1.0 - 1e-4, 1.0, 0.5], [0, -1, 0]),
                        ([0.5, 1.0, 1.0], [0, -1, 0]),
                        ([0.5, 1.0, 0.5], [1, 0, 0])], 0.0),
    "across kinds": ([("s", ((0.0, 0.0, -2.0), 0.5)),
                      ("q", ((-1.0, -1.0, -1.0), (2, 0, 0), (0, 2, 0)))],
                     [([0, 0, 0], [0, 0, -1]), ([5, 5, 5], [1, 0, 0]),
                      ([0, 0, -1 + 1e-5], [0, 0, -1])], 1e-3),
    "grazing": ([("q", ((-1.0, 0.0, -1.0), (2, 0, 0), (0, 0, 2)))],
                [([0.0, 0.0, 2.0], [0.0, 0.0, -1.0])], 1e-3),
    "40 spheres": _random_case(),
}


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", list(INTERSECT_CASES))
def test_intersect_scene_matches_jax(case, exact):
    geoms, rays, t_min = INTERSECT_CASES[case]
    js, ts = _worlds(geoms)
    o = np.array([r[0] for r in rays], np.float32)
    d = np.array([r[1] for r in rays], np.float64)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jrec = jis.intersect_scene(js, jo, jd, t_min=t_min, exact=exact)
    trec = tis.intersect_scene(ts, to, td, t_min=t_min, exact=exact)
    _, jj = jis.closest_select(js, jo, jd, t_min, exact=exact)
    _, tj = tis.closest_select(ts, to, td, t_min, exact=exact)
    hit = np.asarray(jrec.hit)
    np.testing.assert_array_equal(trec.hit.numpy(), hit)
    np.testing.assert_array_equal(tj.numpy()[hit], np.asarray(jj)[hit])
    np.testing.assert_allclose(trec.t.numpy(), np.asarray(jrec.t),
                               rtol=T_RTOL)
    for f in ("front_face", "mat_kind", "is_quad"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)),
                                      err_msg=f)
    for f in ("point", "normal", "albedo"):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)),
                                   atol=VEC_ATOL, rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_spheres"])
def test_intersect_scene_gradients_match_jax_grad(name):
    """tests/test_bvh.py's loss, sum of point * albedo over the hits, on
    JAX's primary rays: the gradient of sph_center, quad_u and
    sph_radius."""
    jw, jcam, _ = jpresets.PRESETS[name](width=32, height=24)
    js = jw.build()
    ts = tpresets.PRESETS[name](width=32, height=24)[0].build()
    o, d = jgenerate_rays(jcam, jnp.arange(32 * 24, dtype=jnp.uint32),
                          jnp.uint32(0), jnp.uint32(3))

    def jloss(c, u, rad):
        r = jis.intersect_scene(js.replace(sph_center=c, quad_u=u,
                                           sph_radius=rad), o, d, exact=True)
        return jnp.sum(jnp.where(r.hit[:, None], r.point * r.albedo, 0.0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(js.sph_center, js.quad_u,
                                              js.sph_radius)
    leaves = [ts.sph_center.clone().requires_grad_(),
              ts.quad_u.clone().requires_grad_(),
              ts.sph_radius.clone().requires_grad_()]
    s = ts.replace(sph_center=leaves[0], quad_u=leaves[1],
                   sph_radius=leaves[2])
    r = tis.intersect_scene(s, torch.from_numpy(np.array(o)),
                            torch.from_numpy(np.array(d)), exact=True)
    torch.where(r.hit[:, None], r.point * r.albedo, 0.0).sum().backward()
    for f, leaf, w in zip(("sph_center", "quad_u", "sph_radius"), leaves,
                          want):
        w = np.asarray(w)
        got = leaf.grad.numpy()
        assert np.isfinite(got).all(), f
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(w).max(), 1),
                                   err_msg=f)
    assert np.abs(np.asarray(want[1])).max() > 0


# --- render_burst -------------------------------------------------------

BURST_SEEDS = [0, 5, 9]


@pytest.mark.parametrize("name,kw,packed", [
    ("three_spheres", {}, None),                 # K1's twin
    ("random_spheres", {"n": 60}, False),        # K2's twin, forced flat
])
def test_render_burst_frames_are_single_renders(name, kw, packed):
    world, camera, pkw = tpresets.PRESETS[name](width=12, height=10, **kw)
    r = mk.MegakernelRenderer(world.build(), camera, pkw["background"],
                              "cpu")
    args = dict(spp=2, max_bounces=3, packed=packed)
    burst = r.render_burst(seeds=BURST_SEEDS, **args)
    assert burst.shape == (len(BURST_SEEDS), 10, 12, 3)
    for i, s in enumerate(BURST_SEEDS):
        assert torch.equal(burst[i], r.render(seed=s, **args)), s
    assert not torch.equal(burst[0], burst[1])
    mesh = make_mesh(["cpu", "cpu"])
    meshed = r.render_burst(seeds=BURST_SEEDS[:2], mesh=mesh, **args)
    for i, s in enumerate(BURST_SEEDS[:2]):
        assert torch.equal(meshed[i], r.render(seed=s, mesh=mesh, **args))
    assert r.render_burst(seeds=[], **args).shape == (0, 10, 12, 3)


# --- profiling.trace ----------------------------------------------------

def test_trace_is_written_when_the_region_raises(tmp_path):
    log_dir = str(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="inside the trace"):
        with profiling.trace(log_dir):
            torch.ones(4).sum()
            raise RuntimeError("inside the trace")
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0


# --- a tensor background ------------------------------------------------

@pytest.mark.parametrize("requires_grad", [False, True])
def test_fused_step_takes_a_tensor_background(requires_grad):
    """The fused step, its routing and fit take the background as a
    tensor (the JAX examples pass a device array), with the same bits as
    the tuple; a tensor that requires grad is read without its graph."""
    from tinyraytracer_tpu_torch.diff import inverse as tinv
    from tinyraytracer_tpu_torch.ops import diffkernel as tdk

    tw, tc, kw = tpresets.cornell_spheres(width=8, height=8)
    scene = tw.build()
    target = torch.from_numpy(np.random.RandomState(3).rand(
        8, 8, 3).astype(np.float32))
    bg = torch.tensor(kw["background"], dtype=torch.float32,
                      requires_grad=requires_grad)
    assert tdk.routes_packed(tdk.build_diff_static(scene), bg)
    runs = []
    for b in (kw["background"], bg):
        step, (p, o) = tinv.make_fused_train_step(
            scene, tc, target, spp=2, max_bounces=2, background=b, seed=1,
            trainable=("sph_center", "mat_albedo"), device="cpu")
        runs.append(step(p, o, 0))
    for a, b in zip(runs[0][0].values(), runs[1][0].values()):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][2], runs[1][2])
    _, losses = tinv.fit(scene, tc, target, steps=1, spp=2, max_bounces=2,
                         background=bg, engine="auto", device="cpu")
    assert np.isfinite(losses).all()
