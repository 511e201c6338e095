"""The port's Ray and Transform (models/ray.py, models/transform.py)
against the JAX package's classes, as tests/test_transform.py checks
those: the same matrices within 1 ulp-scale tolerances (both round
cos/sin of the same float to f32), the same points and vectors, and a
gradient through `apply` equal to jax.grad's. Both build on the card
unless the CPU is asked for, and a tensor is computed on where it lies
(the card half is in tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyraytracer_tpu.models.ray import Ray as JRay
from tinyraytracer_tpu.models.transform import Transform as JTransform
from tinyraytracer_tpu_torch import Ray, Transform

ATOL = 1e-6
CPU = "cpu"

CASES = [
    ("identity", ()), ("translate", ((1.0, 2.0, 3.0),)),
    ("scale", ((2.0, 3.0, 4.0),)), ("rotate_x", (90.0,)),
    ("rotate_y", (90.0,)), ("rotate_z", (37.5,)),
    ("new", ((1.0, -2.0, 0.5), (2.0, 1.5, 0.5), (10.0, 20.0, 30.0))),
]


@pytest.mark.parametrize("name, args", CASES)
def test_constructors_match_jax(name, args):
    got = getattr(Transform, name)(*args, device="cpu").matrix
    want = np.asarray(getattr(JTransform, name)(*args).matrix)
    assert got.dtype == torch.float32 and got.shape == (4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ATOL)


def test_points_and_vectors_match_jax():
    pts = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
    args = ((1.0, -2.0, 0.5), (2.0, 1.5, 0.5), (10.0, 20.0, 30.0))
    t, jt = Transform.new(*args, device="cpu"), JTransform.new(*args)
    got = t.apply(pts)
    assert got.shape == (5, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.apply(pts)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.apply_vector(pts).numpy(),
                               np.asarray(jt.apply_vector(pts)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((t @ t).matrix.numpy(),
                               np.asarray((jt @ jt).matrix), rtol=1e-5,
                               atol=1e-5)


def test_reference_units():
    """tests/test_transform.py's cases on the port."""
    np.testing.assert_allclose(
        Transform.translate((1.0, 2.0, 3.0), CPU).apply([0.0, 0.0, 0.0]),
        [1.0, 2.0, 3.0], atol=ATOL)
    np.testing.assert_allclose(Transform.scale((2.0, 3.0, 4.0), CPU).apply(
        [1.0, 1.0, 1.0]), [2.0, 3.0, 4.0], atol=ATOL)
    np.testing.assert_allclose(Transform.rotate_z(90.0, CPU).apply(
        [1.0, 0.0, 0.0]), [0.0, 1.0, 0.0], atol=ATOL)
    np.testing.assert_allclose(Transform.rotate_x(90.0, CPU).apply(
        [0.0, 1.0, 0.0]), [0.0, 0.0, 1.0], atol=ATOL)
    np.testing.assert_allclose(Transform.rotate_y(90.0, CPU).apply(
        [0.0, 0.0, 1.0]), [1.0, 0.0, 0.0], atol=ATOL)
    t = Transform.new((1.0, 0.0, 0.0), (2.0, 2.0, 2.0), (0.0, 0.0, 90.0),
                      CPU)
    np.testing.assert_allclose(t.apply([1.0, 0.0, 0.0]), [1.0, 2.0, 0.0],
                               atol=1e-5)
    out = Transform.translate((5.0, 0.0, 0.0), CPU).apply(np.zeros((4, 3),
                                                               np.float32))
    np.testing.assert_allclose(out[:, 0], 5.0)
    np.testing.assert_allclose(Transform.translate((5.0, 0.0, 0.0), CPU)
                               .apply_vector([0.0, 1.0, 0.0]),
                               [0.0, 1.0, 0.0])


def test_ray_matches_jax():
    rng = np.random.default_rng(1)
    o = rng.normal(size=(6, 3)).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32) * 3.0
    t = rng.random(6).astype(np.float32)
    r, jr = Ray.new(o, d, CPU), JRay.new(o, d)
    np.testing.assert_array_equal(r.origin.numpy(), np.asarray(jr.origin))
    np.testing.assert_allclose(r.direction.numpy(), np.asarray(jr.direction),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(torch.linalg.vector_norm(r.direction, dim=-1),
                               1.0, rtol=1e-6)
    np.testing.assert_allclose(r.at(t).numpy(), np.asarray(jr.at(t)),
                               rtol=1e-6, atol=1e-6)
    one = Ray.new([0.0, 0.0, 0.0], [0.0, 3.0, 0.0], CPU)     # ray.rs:29-41
    np.testing.assert_allclose(one.at(2.0), [0.0, 2.0, 0.0], atol=ATOL)


def test_apply_gradient_matches_jax():
    """d sum(apply(p) * w) / d matrix through autograd equals jax.grad's."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(8, 3)).astype(np.float32)
    w = rng.normal(size=(8, 3)).astype(np.float32)
    m0 = np.asarray(JTransform.new((1.0, 2.0, 3.0), (1.5, 0.5, 2.0),
                                   (15.0, -40.0, 75.0)).matrix)
    m0 = m0.copy()
    m0[3] = [0.01, -0.02, 0.03, 1.0]     # a projective row: the divide
    want = jax.grad(lambda m: jnp.sum(JTransform(m).apply(pts) * w))(
        jnp.asarray(m0))
    m = torch.tensor(m0, requires_grad=True)
    (Transform(m).apply(pts) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    v = torch.tensor(m0, requires_grad=True)
    Transform(v).apply_vector(pts).sum().backward()
    assert torch.isfinite(v.grad).all() and (v.grad[3] == 0).all()


@pytest.mark.parametrize("make", [
    lambda: Transform.identity(), lambda: Transform.new(
        (1.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0.0, 0.0, 0.0)),
    lambda: Ray.new([0.0, 0.0, 0.0], [0.0, 1.0, 0.0])])
def test_card_by_default(monkeypatch, make):
    """With no device named, Ray and Transform are built on the card: on
    a machine without CUDA they raise instead of falling back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_tensors_stay_where_they_lie():
    """Host data goes to the value's device; a tensor is computed on its
    own device, the matrix or the ray coming to it (the meta device
    stands in for a second device here)."""
    t = Transform.new((1.0, 2.0, 3.0), (2.0, 2.0, 2.0), (0.0, 0.0, 90.0),
                      CPU)
    assert t.apply([[1.0, 0.0, 0.0]]).device.type == "cpu"
    pts = torch.zeros((4, 3), device="meta")
    assert t.apply(pts).device.type == "meta"
    assert t.apply_vector(pts).device.type == "meta"
    r = Ray.new([0.0, 0.0, 0.0], [0.0, 1.0, 0.0], CPU)
    assert r.at(torch.zeros(5, device="meta")).shape == (5, 3)
    assert r.at(torch.zeros(5, device="meta")).device.type == "meta"
