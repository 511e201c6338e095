"""Host side of the closest-hit kernel K3 (csrc/closest_hit.cu): the route
a scene takes (its rows in the kernel's parameter bank, or read from
device memory), the bank's bytes, the launch grid, and the t-only
selection of NEE shadow rays. Needs no card: the kernel itself is held to
its twin on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import intersect_kernel as ik
from tinyraytracer_tpu_torch.ops import trace as ttr
from torch_k3_scenes import k3_world


def _scene(name, n=None, extra=0, coincident=False):
    """An edge scene of K3 (16x12), built: (scene, camera, kw)."""
    world, camera, kw = k3_world(name, n, extra, coincident, 16, 12)
    return world.build(), camera, kw


# (preset, random_spheres' n, extra spheres, real rows, route)
ROUTES = [
    ("cornell_spheres", None, 0, 8, "bank"),
    ("cornell_box", None, 0, 18, "bank"),          # no spheres
    ("random_spheres", 48, 0, 48, "bank"),         # no quads, the limit
    ("random_spheres", 49, 0, 49, "global"),       # one row over
    ("cornell_box", None, 30, 48, "bank"),         # spheres and quads
    ("cornell_box", None, 31, 49, "global"),
    ("random_spheres", 500, 0, 500, "global"),
]


@pytest.mark.parametrize("name, n, extra, rows, route", ROUTES)
def test_route_follows_the_real_row_count(name, n, extra, rows, route):
    scene, _, _ = _scene(name, n, extra)
    cs = ik.compact_rows(scene, "cpu")
    assert cs.n_sph + cs.n_quad == rows
    assert cs.route == route
    assert (cs.bank is None) == (rows > ik.BANK_MAX_ROWS)


@pytest.mark.parametrize("name, n, extra, rows, route",
                         [r for r in ROUTES if r[-1] == "bank"])
def test_bank_bytes_are_the_real_rows_and_their_ids(name, n, extra, rows,
                                                    route):
    """Sphere k's row at float4 k, quad k's at float4s 48 + 3k..3k+2, the
    global ids after them (sphere k's at k, quad k's at 48 + k), bit for
    bit; every other word zero."""
    scene, _, _ = _scene(name, n, extra)
    cs = ik.compact_rows(scene, "cpu")
    m = ik.BANK_MAX_ROWS
    assert len(cs.bank) == ik.BANK_BYTES == 3456
    words = np.frombuffer(cs.bank, np.int32)
    rows_w = words[:16 * m].reshape(4 * m, 4)
    gid = words[16 * m:]
    sph = cs.sph[:cs.n_sph].numpy().view(np.int32)
    quad = cs.quad[:cs.n_quad].numpy().view(np.int32)
    np.testing.assert_array_equal(rows_w[:cs.n_sph], sph)
    np.testing.assert_array_equal(
        rows_w[m:m + 3 * cs.n_quad].reshape(-1, 12), quad)
    assert not rows_w[cs.n_sph:m].any()
    assert not rows_w[m + 3 * cs.n_quad:].any()
    im = cs.index_map.numpy()
    np.testing.assert_array_equal(gid[:cs.n_sph], im[:cs.n_sph])
    np.testing.assert_array_equal(gid[m:m + cs.n_quad],
                                  im[cs.ns:cs.ns + cs.n_quad])
    assert not gid[cs.n_sph:m].any() and not gid[m + cs.n_quad:].any()


def test_pack_bank_and_the_wrapper_refuse_what_the_bank_cannot_hold():
    with pytest.raises(ValueError, match="exceed"):
        ik.pack_bank(np.zeros((30, 4), np.float32),
                     np.zeros((19, 12), np.float32), np.arange(30),
                     np.arange(19))
    import dataclasses
    scene, camera, _ = _scene("cornell_spheres")
    cs = ik.compact_rows(scene, "cpu")
    o, d = generate_rays(camera, torch.arange(16 * 12), 0, 0)
    for bad in (dict(bank=cs.bank[:-4]),
                dict(bank=cs.bank, n_sph=cs.n_sph + 41)):
        with pytest.raises(ValueError, match="malformed"):
            ik.closest_hit(dataclasses.replace(cs, **bad), o, d)


@pytest.mark.parametrize("need_j", [True, False])
def test_no_rays_select_nothing(need_j):
    """R = 0 rays: empty t (and j) on either route, and no launch."""
    import dataclasses
    scene, _, _ = _scene("cornell_spheres")
    cs = ik.compact_rows(scene, "cpu")
    none = torch.zeros((0, 3))
    before = ik.closest_hit.launches
    for c in (cs, dataclasses.replace(cs, bank=None)):
        t, j = ik.closest_hit(c, none, none, need_j)
        assert t.shape == (0,) and t.dtype == torch.float32
        assert (j is None) if not need_j else (j.shape == (0,))
    assert ik.closest_hit.launches == before


def test_coincident_spheres_first_row_wins():
    """Of two coincident sphere rows the first wins every tie: the
    camera sees it, and the second is never selected."""
    scene, camera, _ = _scene("sphere_ground", coincident=True)
    cs = ik.compact_rows(scene, "cpu")
    assert cs.route == "bank"
    o, d = generate_rays(camera, torch.arange(16 * 12), 0, 0)
    _, j = ik.closest_hit(cs, o, d)
    sph, im = cs.sph[:cs.n_sph], cs.index_map
    a, b = next((a, b) for a in range(cs.n_sph)
                for b in range(a + 1, cs.n_sph)
                if torch.equal(sph[a], sph[b]))
    assert (j == int(im[a])).any() and not (j == int(im[b])).any()


@pytest.mark.parametrize("route", ["bank", "global"])
def test_t_only_selection_gives_the_same_t_and_no_j(route):
    """need_j=False returns (t, None), t the full selection's bits; on a
    CPU tensor the twin answers and no launch is counted, whatever the
    route."""
    import dataclasses
    scene, camera, _ = _scene("cornell_spheres")
    cs = ik.compact_rows(scene, "cpu")
    if route == "global":
        cs = dataclasses.replace(cs, bank=None)
    pid = torch.arange(16 * 12)
    o, d = generate_rays(camera, pid, 0, 0)
    before = ik.closest_hit.launches
    t, j = ik.closest_hit(cs, o, d)
    t1, j1 = ik.closest_hit(cs, o, d, need_j=False)
    t2, j2 = ik.closest_hit_reference(cs, o, d, False)
    assert ik.closest_hit.launches == before
    assert j1 is None and j2 is None and j.dtype == torch.int32
    assert torch.equal(t, t1) and torch.equal(t, t2)
    assert ((j >= 0) == (t < ik.MISS_T)).all()


def test_trace_selects_shadow_rays_t_only(monkeypatch):
    """With a compaction, each bounce of an NEE trace selects its rays
    with j and its shadow rays without: 2 selections a bounce."""
    scene, camera, kw = _scene("cornell_spheres")
    cs = ik.compact_rows(scene, "cpu")
    calls = []
    real = ik.closest_hit

    def recording(c, o, d, need_j=True):
        calls.append(need_j)
        return real(c, o, d, need_j)

    monkeypatch.setattr(ttr, "closest_hit", recording)
    pid = torch.arange(16 * 12)
    o, d = generate_rays(camera, pid, 0, 1)
    with torch.no_grad():
        ttr.trace(scene, o, d, pid, 0, 1, 3, kw["background"], compact=cs,
                  nee=True)
    assert calls == [True, False] * 3
