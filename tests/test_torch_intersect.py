"""The PyTorch port's intersection, scatter and closest-hit kernel twin
against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. Torch runs
single-threaded here: with JAX initialised in the same process, torch's
first multi-threaded CPU op was seen to compute one chunk wrongly. The
CUDA kernel (K3) is held to its twin on the card in
tests/test_torch_cuda.py.

Tolerances. XLA on the CPU contracts a*b + c into one fused multiply-add
inside a jitted computation and inside a dot (measured: 24 % of a*b + c
results differ from the separately rounded ones), and the port never
fuses (its CUDA kernels are built with --fmad=false, so the twins must
not either). Where JAX's formula goes through a dot or a jitted kernel
body, the cancellation in the sphere discriminant turns that into tens
of ulps of t; there t is held within T_RTOL and the winners are equal
(measured: 3.1e-6 relative at most; every winner equal), and within
K3_RTOL for the kernel, whose random_spheres scene has a ground sphere
of radius 1000 (discriminant terms ~1e6; measured 6.0e-5).
Elsewhere t is within T_ULP units in the last place (measured: 0).
Derived vectors of a hit record are within VEC_ATOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models import presets as jpresets
from tinyraytracer_tpu.ops import intersect as jis
from tinyraytracer_tpu.ops import intersect_pallas as jip
from tinyraytracer_tpu.ops import scatter as jsc
from tinyraytracer_tpu_torch.models import presets as tpresets
from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import intersect as tis
from tinyraytracer_tpu_torch.ops import intersect_kernel as tik
from tinyraytracer_tpu_torch.ops import scatter as tsc
from tinyraytracer_tpu_torch.ops import trace as ttr
from tinyraytracer_tpu_torch.utils import profiling

T_ULP = 4
T_RTOL = 1e-5
K3_RTOL = 1e-4
VEC_ATOL = 1e-5
# The four scenes chip_smoke.py holds K3 to its twin on.
K3_SCENES = [("cornell_spheres", {}), ("cornell_box", {}),
             ("three_spheres", {}), ("random_spheres", dict(n=500))]


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if a.size else 0


def _scenes(name="cornell_spheres", **kw):
    jw, _, _ = jpresets.PRESETS[name](width=8, height=8, **kw)
    tw, tc, tkw = tpresets.PRESETS[name](width=8, height=8, **kw)
    return jw.build(), tw.build()


def _rays(n=400, seed=0):
    """Rays from around the Cornell camera toward the two spheres and the
    walls, some from inside the box."""
    rs = np.random.RandomState(seed)
    o = np.concatenate([
        np.array([50, 50, -140]) + rs.normal(0, 1, (n // 2, 3)),
        rs.uniform(5, 95, (n - n // 2, 3))]).astype(np.float32)
    aim = rs.uniform(0, 100, (n, 3))
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("exact", [False, True])
def test_sphere_and_quad_ts_match_jax(exact):
    js, ts = _scenes()
    o, d = _rays()
    want_s = np.asarray(jis.sphere_ts(js, jnp.asarray(o), jnp.asarray(d),
                                      jis.T_MIN, jis.MISS_T, exact=exact))
    got_s = tis.sphere_ts(ts, torch.from_numpy(o), torch.from_numpy(d),
                          exact=exact).numpy()
    want_q = np.asarray(jis.quad_ts(js, jnp.asarray(o), jnp.asarray(d),
                                    jis.T_MIN, jis.MISS_T))
    got_q = tis.quad_ts(ts, torch.from_numpy(o), torch.from_numpy(d)).numpy()
    for got, want in ((got_s, want_s), (got_q, want_q)):
        np.testing.assert_array_equal(got < 1e38, want < 1e38)
    # exact=True: jnp.einsum's dot fuses; the expanded form's matmul and
    # the quad planes do not
    if exact:
        np.testing.assert_allclose(got_s, want_s, rtol=T_RTOL)
    else:
        assert _ulps(got_s, want_s) <= T_ULP
    assert _ulps(got_q, want_q) <= T_ULP


def test_closest_select_prim_t_and_record_match_jax():
    """The dense oracle (exact=True): winners equal, t within T_ULP; the
    differentiable recompute and the hit record agree."""
    js, ts = _scenes()
    o, d = _rays(seed=1)
    jt, jj = jis.closest_select(js, jnp.asarray(o), jnp.asarray(d),
                                exact=True)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tt, tj = tis.closest_select(ts, to, td, exact=True)
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=T_RTOL)
    assert (tt.numpy() < 1e38).mean() > 0.5
    want = np.asarray(jis.prim_t(js, jnp.asarray(o), jnp.asarray(d), jj))
    got = tis.prim_t(ts, to, td, tj).numpy()
    assert _ulps(got, want) <= T_ULP
    jrec = jis.select_to_record(js, jnp.asarray(o), jnp.asarray(d), jt, jj)
    trec = tis.select_to_record(ts, to, td, tt, tj)
    for f in ("hit", "front_face", "mat_kind", "is_quad"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), err_msg=f)
    for f in ("point", "normal", "albedo", "fuzz", "ior", "emit"):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)),
                                   atol=VEC_ATOL, rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("shape", [(10,), (10, 3)])
def test_take_rows_backward_matches_jax_vjp(shape):
    rs = np.random.RandomState(2)
    table = rs.normal(size=shape).astype(np.float32)
    j = rs.randint(0, shape[0], 64).astype(np.int32)
    ct = rs.normal(size=(64,) + shape[1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jis.take_rows(t, jnp.asarray(j)),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tt = torch.from_numpy(table).requires_grad_(True)
    out = tis.take_rows(tt, torch.from_numpy(j))
    np.testing.assert_array_equal(out.detach().numpy(), table[j])
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_max_min_clip_split_ties_like_jax():
    x = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    hi = np.array([2.0, 2.0, 2.0, 2.0], np.float32)

    def jf(x, hi):
        return (jnp.maximum(x, 1.0) + jnp.minimum(x, 1.0)
                + jnp.clip(x, 1.0, hi)).sum()

    want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(hi))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(hi).requires_grad_(True)
    (tis.maximum(tx, 1.0) + tis.minimum(tx, 1.0)
     + tis.clip(tx, 1.0, th)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(th.grad.numpy(), np.asarray(want[1]))


def test_prim_t_gradient_is_finite_at_a_tangent():
    """disc == 0 exactly: JAX's derivative of the root is infinite (the
    step then zeroes that field); the port's is 0 for that ray only."""
    _, ts = _scenes()
    c = ts.sph_center[0].clone()
    r = float(ts.sph_radius[0])
    o = (c + torch.tensor([-50.0, r, 0.0]))[None]       # grazes the top
    d = torch.tensor([[1.0, 0.0, 0.0]])
    center = ts.sph_center.clone().requires_grad_(True)
    s = dataclasses.replace(ts, sph_center=center)
    t = tis.prim_t(s, o, d, torch.tensor([0]))
    assert float(t.detach()) == pytest.approx(50.0)
    t.sum().backward()
    assert torch.isfinite(center.grad).all()


@pytest.mark.parametrize("kind", ["lambertian", "metal", "dielectric",
                                  "light"])
def test_scatter_matches_jax(kind):
    """Each material on the records of real hits, the same RNG stream."""
    names = {"lambertian": "cornell_spheres", "metal": "three_spheres",
             "dielectric": "three_spheres", "light": "cornell_box"}
    code = {"lambertian": 0, "metal": 1, "dielectric": 2, "light": 3}[kind]
    js, ts = _scenes(names[kind])
    rs = np.random.RandomState(3)
    n = 256
    o = np.zeros((n, 3), np.float32) + (
        np.array([50, 50, -140], np.float32) if "cornell" in names[kind]
        else np.array([0, 0, 1], np.float32))
    centers = np.asarray(js.sph_center)[np.asarray(js.sph_valid)]
    tgt = (np.asarray(js.quad_corner)[np.asarray(js.quad_valid)].mean(0)
           if not len(centers) else centers[rs.randint(0, len(centers), n)])
    d = tgt + rs.normal(0, 0.3 if len(centers) else 20, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jt, jj = jis.closest_select(js, jnp.asarray(o), jnp.asarray(d),
                                exact=True)
    jrec = jis.select_to_record(js, jnp.asarray(o), jnp.asarray(d), jt, jj)
    jrec = dataclasses.replace(jrec,
                               mat_kind=jnp.full_like(jrec.mat_kind, code))
    pid = np.arange(n, dtype=np.uint32)
    want = jsc.scatter(jnp.asarray(d), jrec, jnp.uint32(5),
                       jnp.asarray(pid), jnp.uint32(2), jnp.uint32(1))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tt, tj = tis.closest_select(ts, to, td, exact=True)
    trec = tis.select_to_record(ts, to, td, tt, tj)
    trec.mat_kind = torch.full_like(trec.mat_kind, code)
    got = tsc.scatter(td, trec, 5, torch.from_numpy(pid.astype(np.int64)),
                      2, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=VEC_ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


class _RayCapture:
    """A selection tape keeping every ray batch trace selects for."""

    def __init__(self):
        self.rays = []

    def __call__(self, select, o, d, need_j=True):
        self.rays.append((o.clone(), d.clone()))
        return select(o, d)


@pytest.mark.parametrize("name, kw", K3_SCENES)
def test_k3_twin_equals_jax_interpret_kernel(name, kw):
    """Primary rays (16x12, 2 samples) and the shadow, scattered and
    shadow rays of a traced bounce through the JAX kernel in interpret
    mode: j equal, t within K3_RTOL (interpret mode jits the kernel body,
    so XLA fuses its multiply-adds; the twin is held to K3 bit for bit on
    the card)."""
    jw, _, _ = jpresets.PRESETS[name](width=16, height=12, **kw)
    tw, tc, tkw = tpresets.PRESETS[name](width=16, height=12, **kw)
    js, ts = jw.build(), tw.build()
    jcs = jip.compact_scene(js)
    tcs = tik.compact_rows(ts, "cpu")
    for f, got in (("sph_c", tcs.sph[:, :3]), ("sph_r2", tcs.sph[:, 3:]),
                   ("quad_n", tcs.quad[:, :3]), ("quad_cb", tcs.quad[:, 11:]),
                   ("index_map", tcs.index_map)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jcs, f)))
    pid, sid = ttr.round_ids(torch.arange(16 * 12), 2, 0)
    o, d = generate_rays(tc, pid, sid, 3)
    cap = _RayCapture()
    with torch.no_grad():
        ttr.trace(ts, o, d, pid, sid, 3, 2, tkw["background"], compact=tcs,
                  nee=True, tape=cap)
    assert len(cap.rays) == 4
    for ro, rd in cap.rays:
        t, j = tik.closest_hit(tcs, ro, rd)
        want_t, want_j = jip.closest_hit_pallas(
            jcs, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
            interpret=True)
        np.testing.assert_array_equal(j.numpy(), np.asarray(want_j))
        np.testing.assert_allclose(t.numpy(), np.asarray(want_t),
                                   rtol=K3_RTOL)


def test_closest_hit_wrapper_checks_and_counts_only_kernel_launches():
    _, ts = _scenes()
    cs = tik.compact_rows(ts, "cpu")
    o, d = _rays(64, seed=4)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    before = profiling.counter("launches.closest_hit")
    t, j = tik.closest_hit(cs, o, d)
    # the twin is no launch
    assert profiling.counter("launches.closest_hit") == before
    assert t.dtype == torch.float32 and j.dtype == torch.int32
    # strided views (components of a wider array) give the same answer
    wide = torch.cat([o, d], 1)
    t2, j2 = tik.closest_hit(cs, wide[:, :3], wide[:, 3:])
    assert torch.equal(t, t2) and torch.equal(j, j2)
    rec = tik.intersect_scene_compact(ts, cs, o, d)
    want = tis.select_to_record(ts, o, d, t, j)
    assert torch.equal(rec.t, want.t) and torch.equal(rec.point, want.point)
    for bad in (dict(o=o.double()), dict(o=o[:, :2]), dict(d=d[:-1])):
        args = {"o": o, "d": d, **bad}
        with pytest.raises(ValueError):
            tik.closest_hit(cs, args["o"], args["d"])
    with pytest.raises(ValueError):
        tik.closest_hit(cs, o.to("meta"), d.to("meta"))
