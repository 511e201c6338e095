"""The PyTorch port's BVH (ops/bvh.py) against the JAX package's and
against the port's dense selection, on cornell_box, three_spheres and
random_spheres (64 and config 4b's 8 000 spheres) at 32x24.

Tolerances, measured on these inputs (CPU):
  - primitive AABBs and the built arrays: bit for bit;
  - the walk against a literal every-iteration transcription of the JAX
    loop, whose leaf test is prim_t as JAX's is: (t, j) bit for bit;
  - the walk against the port's dense `closest_select`: hit masks equal;
    winners equal on all but DENSE_MAX_FLIP of the hits (measured 0 on
    every scene, primary and scattered rays; JAX's own gate is 5 %,
    tests/test_bvh.py:56-58), t within DENSE_T_RTOL where they agree
    (measured 1.9e-5: the dense screening formula rounds differently);
    the Cornell light/ceiling tie: j equal on every ray;
  - the walk against JAX's `traverse` on the same rays: winners equal on
    all but JAX_MAX_FLIP of the rays (measured 1 of 768 rays at 8 000
    spheres, a near-tangent contact), t within JAX_T_RTOL where they
    agree (measured 5.9e-5 at 8 000 spheres: XLA fuses multiply-adds in
    the sphere discriminant, ROADMAP.md's parity tiers);
  - gradients through `intersect_scene_bvh` against the dense path:
    rtol 1e-5, atol 1e-6 (as tests/test_bvh.py:73-93);
  - `Renderer(accelerator="bvh")` on the CPU: the port's dense
    (`accelerator="none"`) image bit for bit (measured), and JAX's BVH
    image within test_torch_trace.py's image tolerances.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu import Renderer as JRenderer
from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.models.camera import generate_rays as jgen
from tinyraytracer_tpu.ops import bvh as jbvh
from tinyraytracer_tpu_torch import Renderer
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import bvh as tbvh
from tinyraytracer_tpu_torch.ops import intersect as tis
from tinyraytracer_tpu_torch.ops import trace as ttr
from tinyraytracer_tpu_torch.ops.scatter import scatter
from tinyraytracer_tpu_torch.parallel import sharded

W, H = 32, 24
SCENES = [("cornell_box", {}), ("three_spheres", {}),
          ("random_spheres", dict(n=64)), ("random_spheres", dict(n=8000))]
IDS = ["cornell_box", "three_spheres", "random_spheres_64",
       "random_spheres_8000"]
DENSE_MAX_FLIP = 0.01
DENSE_T_RTOL = 5e-5
JAX_MAX_FLIP = 0.005
JAX_T_RTOL = 1e-4
IMG_ATOL = 1e-5
IMG_MAX_FRAC = 0.05
IMG_MEAN_RTOL = 0.02
FIELDS = ("node_min", "node_max", "hit_link", "miss_link", "leaf_prim")


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_side():
    """Per scene: JAX's AABBs, its BVH (its default builder and the numpy
    one), the primary rays of tests/test_bvh.py (seed 3) and JAX's walk
    over them, all as numpy."""
    out = {}
    pid = jnp.arange(W * H, dtype=jnp.uint32)
    for key, (name, kw) in zip(IDS, SCENES):
        world, camera, _ = jpresets.PRESETS[name](width=W, height=H, **kw)
        scene = world.build()
        bvh = jbvh.build_bvh(scene)
        aabbs = jbvh.primitive_aabbs(scene)
        o, d = jgen(camera, pid, jnp.uint32(0), jnp.uint32(3))
        t, j = jbvh.traverse(scene, bvh, o, d)
        out[key] = dict(
            aabbs=aabbs,
            bvh={f: np.asarray(getattr(bvh, f)) for f in FIELDS},
            host=jbvh._build_host(*aabbs),
            o=np.array(o), d=np.array(d), t=np.asarray(t),
            j=np.asarray(j))
    return out


def _port(key):
    name, kw = SCENES[IDS.index(key)]
    world, camera, _ = tpresets.PRESETS[name](width=W, height=H, **kw)
    return world.build()


def _scattered(scene, bvh, o, d):
    """The scattered rays of one traced bounce (hits that scatter)."""
    t, j = tbvh.traverse(scene, bvh, o, d)
    rec = tis.select_to_record(scene, o, d, torch.where(j >= 0, t, tis.MISS_T),
                               j)
    pid = torch.arange(o.shape[0])
    new_d, _, absorbed = scatter(d, rec, 3, pid, 0, 0)
    keep = rec.hit & ~absorbed
    return rec.point[keep].contiguous(), new_d[keep].contiguous()


def every_iteration(scene, bvh, o, d, t_min=tis.T_MIN, t_max=tis.MISS_T):
    """A literal transcription of the JAX loop (ops/bvh.py:219-259): every
    ray every iteration, the exit condition read each time, a parked ray
    re-testing node M-1."""
    m = bvh.node_min.shape[0]
    inv = tbvh._safe_inv(d)
    hl, ml, lps = (x.long() for x in (bvh.hit_link, bvh.miss_link,
                                      bvh.leaf_prim))
    node = torch.zeros(o.shape[0], dtype=torch.int64)
    bt = torch.full((o.shape[0],), t_max)
    bj = torch.full((o.shape[0],), -1, dtype=torch.int64)
    while bool((node < m).any()):
        nc = node.clamp(max=m - 1)
        t0 = (bvh.node_min[nc] - o) * inv
        t1 = (bvh.node_max[nc] - o) * inv
        lo = tis.maximum(torch.minimum(t0, t1).amax(-1), t_min)
        hi = torch.minimum(torch.maximum(t0, t1).amin(-1), bt)
        lp = lps[nc]
        leaf = lp >= 0
        pt = tis.prim_t(scene, o, d, lp.clamp(min=0), t_min, t_max)
        better = (leaf & (pt < tis.MISS_T)
                  & ((pt < bt) | ((pt == bt) & (lp < bj))))
        bt = torch.where(better, pt, bt)
        bj = torch.where(better, lp, bj)
        nxt = torch.where(leaf, ml[nc], torch.where(lo < hi, hl[nc], ml[nc]))
        node = torch.where(node >= m, m, nxt)
    return bt, bj


@pytest.mark.parametrize("key", IDS)
def test_aabbs_and_build_bitwise_equal_jax(jax_side, key):
    """The port builds the JAX package's arrays from its own World.build(),
    bit for bit and dtype for dtype, whichever builder JAX took."""
    scene = _port(key)
    want = jax_side[key]
    for got, ref in zip(tbvh.primitive_aabbs(scene), want["aabbs"]):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    bvh = tbvh.build_bvh(scene)
    for f, host in zip(FIELDS, want["host"]):
        got = getattr(bvh, f).numpy()
        assert got.dtype == want["bvh"][f].dtype, f
        np.testing.assert_array_equal(got, want["bvh"][f], err_msg=f)
        np.testing.assert_array_equal(got, host, err_msg=f)
    again = tbvh.bvh_from_numpy(want["bvh"], "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(again, f), getattr(bvh, f))


@pytest.mark.parametrize("key", IDS)
def test_threaded_layout_wellformed(key):
    """As tests/test_bvh.py:110-130: M = 2N - 1, links move forward and
    stay within the sentinel, every inner box holds its left child's."""
    bvh = {f: v for f, v in tbvh.build_bvh(_port(key)).numpy().items()}
    lp, hl, ml = bvh["leaf_prim"], bvh["hit_link"], bvh["miss_link"]
    m = lp.shape[0]
    assert m == 2 * int((lp >= 0).sum()) - 1
    assert (hl > np.arange(m)).all() and (ml > np.arange(m)).all()
    assert (ml <= m).all() and (hl <= m).all()
    nm, nx = bvh["node_min"], bvh["node_max"]
    assert (nm <= nx).all()
    inner = lp < 0
    left = (np.arange(m) + 1)[inner]
    assert (nm[inner] <= nm[left] + 1e-6).all()
    assert (nx[inner] >= nx[left] - 1e-6).all()


@pytest.mark.parametrize("check_every", [1, 3, 8])
@pytest.mark.parametrize("key", IDS)
def test_walk_equals_every_iteration_loop(jax_side, monkeypatch, key,
                                          check_every):
    """The packed walk, whatever the cadence of its exit check, gives the
    every-iteration loop's (t, j) bit for bit on primary rays and on one
    bounce's scattered rays."""
    monkeypatch.setattr(tbvh, "CHECK_EVERY", check_every)
    scene = _port(key)
    bvh = tbvh.build_bvh(scene)
    o = torch.from_numpy(jax_side[key]["o"])
    d = torch.from_numpy(jax_side[key]["d"])
    for oo, dd in ((o, d), _scattered(scene, bvh, o, d)):
        t, j = tbvh.traverse(scene, bvh, oo, dd)
        t_ref, j_ref = every_iteration(scene, bvh, oo, dd)
        assert torch.equal(j, j_ref) and torch.equal(t, t_ref)


def _sphere_world(pkg, centers):
    w = pkg.World()
    w.add_material("m", pkg.Lambertian((0.5, 0.5, 0.5)))
    for c in centers:
        w.add_geometry(pkg.Sphere(c, 1.0, "m"))
    return w.build()


def test_parked_rays_retest_the_last_leaf():
    """The JAX loop's parked rays keep testing node M-1 while any ray
    walks. Hand-made arrays where that decides a hit: ray X misses the
    root box and parks after one step, ray Y parks after two (its leaf
    skips node M-1); both point at node M-1's sphere. X finds it in the
    second iteration, Y (the slowest) never does. The port, JAX and the
    every-iteration loop agree."""
    import tinyraytracer_tpu as jt
    import tinyraytracer_tpu_torch as tt

    centers = [(100.0, 0.0, 0.0), (0.0, 0.0, -10.0)]
    js, ts = _sphere_world(jt, centers), _sphere_world(tt, centers)
    rows, valid = ts.sph_center.numpy(), ts.sph_valid.numpy()
    far, near = (int(np.flatnonzero((rows == c).all(1) & valid)[0])
                 for c in centers[::-1])
    arrays = dict(
        node_min=np.array([[5, -1, -1], [99, -1, -1], [-1, -1, -11]],
                          np.float32),
        node_max=np.array([[6, 1, 1], [101, 1, 1], [1, 1, -9]], np.float32),
        hit_link=np.array([1, 3, 3], np.int32),
        miss_link=np.array([3, 3, 3], np.int32),
        leaf_prim=np.array([-1, near, far], np.int32))
    o = np.array([[0, 0, 0], [5.5, 0, 0]], np.float32)
    d = np.array([[0, 0, -1], [-5.5, 0, -10]], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bvh = tbvh.bvh_from_numpy(arrays, "cpu")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, j = tbvh.traverse(ts, bvh, to, td)
    t_ref, j_ref = every_iteration(ts, bvh, to, td)
    jb = jbvh.BVHArrays(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jt_, jj = jbvh.traverse(js, jb, jnp.asarray(o), jnp.asarray(d))
    assert j.tolist() == [far, -1] == j_ref.tolist()
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    assert torch.equal(t, t_ref)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt_), rtol=JAX_T_RTOL)
    assert float(t[0]) == pytest.approx(9.0)


@pytest.mark.parametrize("key", IDS)
def test_walk_matches_dense_selection(jax_side, key):
    scene = _port(key)
    bvh = tbvh.build_bvh(scene)
    o = torch.from_numpy(jax_side[key]["o"])
    d = torch.from_numpy(jax_side[key]["d"])
    for oo, dd in ((o, d), _scattered(scene, bvh, o, d)):
        t, j = tbvh.traverse(scene, bvh, oo, dd)
        t_d, j_d = tis.closest_select(scene, oo, dd, exact=True)
        hit = t_d < tis.MISS_T
        assert torch.equal(j >= 0, hit)
        same = hit & (j == j_d)
        assert 1 - same.sum() / max(int(hit.sum()), 1) <= DENSE_MAX_FLIP
        np.testing.assert_allclose(t[same].numpy(), t_d[same].numpy(),
                                   rtol=DENSE_T_RTOL)
        if key == "cornell_box":      # the light/ceiling coplanar tie
            assert torch.equal(j[hit], j_d[hit])


@pytest.mark.parametrize("key", IDS)
def test_walk_matches_jax_traverse(jax_side, key):
    """The port's walk and JAX's on the same rays (JAX's, as numpy)."""
    ref = jax_side[key]
    scene = _port(key)
    t, j = tbvh.traverse(scene, tbvh.build_bvh(scene),
                         torch.from_numpy(ref["o"]),
                         torch.from_numpy(ref["d"]))
    j, t = j.numpy(), t.numpy()
    same = j == ref["j"]
    assert 1 - same.mean() <= JAX_MAX_FLIP
    np.testing.assert_array_equal(j >= 0, ref["j"] >= 0)
    np.testing.assert_allclose(t[same], ref["t"][same], rtol=JAX_T_RTOL)


@pytest.mark.parametrize("name", ["cornell_box", "random_spheres"])
def test_gradients_through_bvh_match_dense(jax_side, name):
    """As tests/test_bvh.py:73-93: the same loss through the BVH record
    and the dense one has the same gradients."""
    key = "cornell_box" if name == "cornell_box" else "random_spheres_64"
    base = _port(key)
    bvh = tbvh.build_bvh(base)
    o = torch.from_numpy(jax_side[key]["o"])
    d = torch.from_numpy(jax_side[key]["d"])

    def grads(record):
        leaves = [getattr(base, f).clone().requires_grad_(True)
                  for f in ("sph_center", "quad_u", "sph_radius")]
        s = dataclasses.replace(base, sph_center=leaves[0],
                                quad_u=leaves[1], sph_radius=leaves[2])
        r = record(s)
        loss = torch.where(r.hit[:, None], r.point * r.albedo, 0.0).sum()
        return torch.autograd.grad(loss, leaves)

    def dense(s):
        t, j = tis.closest_select(s, o, d, exact=True)
        return tis.select_to_record(s, o, d, t, j)

    for a, b in zip(grads(dense),
                    grads(lambda s: tbvh.intersect_scene_bvh(s, bvh, o, d))):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def jax_images():
    """JAX's Renderer(accelerator="bvh") at 16x12 spp=2 mb=4."""
    out = {}
    for name, kw in (("cornell_box", {}), ("random_spheres", dict(n=64))):
        w, c, pk = jpresets.PRESETS[name](width=16, height=12, **kw)
        r = JRenderer(2, max_bounces=4, background_color=pk["background"],
                      accelerator="bvh", seed=5)
        out[name] = np.asarray(r.render_array(c, w.build()))
    return out


@pytest.mark.parametrize("name, kw", [("cornell_box", {}),
                                      ("random_spheres", dict(n=64))])
def test_renderer_bvh_matches_dense_and_jax(jax_images, name, kw):
    w, c, pk = tpresets.PRESETS[name](width=16, height=12, **kw)
    args = dict(max_bounces=4, background_color=pk["background"], seed=5,
                device="cpu")
    got = Renderer(2, accelerator="bvh", **args).render_array(c, w.build())
    dense = Renderer(2, accelerator="none", **args).render_array(
        c, w.build())
    assert torch.equal(got, dense)
    want = jax_images[name]
    diff = np.abs(got.numpy() - want).max(-1)
    assert (diff > IMG_ATOL).mean() <= IMG_MAX_FRAC
    assert abs(got.numpy().mean() - want.mean()) <= IMG_MEAN_RTOL * want.mean()


def test_sharded_bvh_bit_for_bit():
    """render_image_sharded(bvh=) over a (2, 1) CPU mesh gives the
    one-device image bit for bit, and so does Renderer over the mesh."""
    w, c, pk = tpresets.random_spheres(width=20, height=10, n=64)
    scene = w.build()
    bvh = tbvh.build_bvh(scene)
    kw = dict(spp=3, max_bounces=4, background=pk["background"], seed=2)
    one = sharded.render_image_sharded(scene, c, mesh=sharded.one_cell("cpu"),
                                       bvh=bvh, **kw)
    two = sharded.render_image_sharded(scene, c, devices=["cpu", "cpu"],
                                       bvh=bvh, **kw)
    assert torch.equal(one, two)
    r = Renderer(3, max_bounces=4, background_color=pk["background"], seed=2,
                 accelerator="bvh", devices=["cpu", "cpu"])
    assert torch.equal(r.render_array(c, scene), one)


def test_selection_tape_over_bvh():
    """A SelectionTape records the BVH walk's selections (shadow rays keep
    only t) and replays them without walking. render_pixels with `tapes`
    keeps one round a sample on the BVH route (no sample groups) and
    gives the grouped render's bits."""
    w, c, pk = tpresets.cornell_box(width=12, height=10)
    scene = w.build()
    bvh = tbvh.build_bvh(scene)
    bg = torch.as_tensor(pk["background"], dtype=torch.float32)
    pid = torch.arange(12 * 10)
    o, d = generate_rays(c, pid, 0, 4)
    tape = ttr.SelectionTape()
    with torch.no_grad():
        first = ttr.trace(scene, o, d, pid, 0, 4, 3, bg, bvh=bvh, nee=True,
                          tape=tape)
        assert len(tape.entries) == 2 * 3
        assert tape.entries[1][1] is None
        walks = tbvh.walk_counts.walks
        again = ttr.trace(scene, o, d, pid, 0, 4, 3, bg, nee=True,
                          tape=tape.replay())
        assert tbvh.walk_counts.walks == walks
        kw = dict(spp=3, max_bounces=3, background=bg, seed=4, bvh=bvh)
        grouped = ttr.render_pixels(scene, c, pid, **kw)
        tapes = []
        taped = ttr.render_pixels(scene, c, pid, tapes=tapes, **kw)
    assert torch.equal(first, again)
    assert len(tapes) == 3 and torch.equal(grouped, taped)
