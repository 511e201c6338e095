"""Participating media (ConstantMedium) in the port, on the CPU: K2's twin
against the plain reference (perfbench/reference/media.py) on seeded
tiny scenes, dense and walk routes; a plain walk over the lowered tree,
medium leaves included, held to the dense selection; the route rule; the
clear refusals of every other entry point; the lowering; and the
`rtnw_final` configuration's scene against the port's `World.build()`.
K2 itself is held to the twin on the card in
tests/test_torch_media_cuda.py."""

import json

import numpy as np
import pytest
import torch

import tinyraytracer_tpu_torch as rt
from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops import rng
from tinyraytracer_tpu_torch.ops import scene_table as st
from torch_media_scenes import CULL, DESCS, ROOT, port_world, reference

from perfbench.reference import forward


@pytest.fixture(scope="module", autouse=True)
def single_thread_torch():
    # small per-bounce ops: threads only contend with the suite's workers
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _renderer(name, w, h, **kw):
    world, camera, bg = port_world(name, w, h)
    return mk.MegakernelRenderer(world.build(), camera, bg, "cpu", **kw)


@pytest.mark.parametrize("bvh", [False, True], ids=["dense", "walk"])
@pytest.mark.parametrize("name", ["alone", "inside", "glass", "overlap"])
def test_twin_matches_the_reference(name, bvh):
    """The twin's image (Renderer.render's K2 route on the CPU) equals the
    plain reference's at every sampled pixel, to 1e-6 after gamma, with
    the walk forced or not; some paths scatter in a medium."""
    w, h, spp, mb, seed = 12, 10, 3, 10, 2 ** 31 + 5
    r = _renderer(name, w, h, bvh=bvh)
    assert r.bvh == bvh and r.flat.n_med == len(DESCS[name]["media"])
    assert (r.flat.nodes is not None) == bvh
    img = r.render(spp=spp, max_bounces=mb, seed=seed).reshape(-1, 3)
    pix = np.arange(0, w * h, 3)
    lin, seg, share = reference(name, w, h, pix, spp=spp, max_bounces=mb,
                                seed=seed)
    np.testing.assert_allclose(forward.gamma(lin.numpy()),
                               forward.gamma(img[pix].numpy()), rtol=0,
                               atol=1e-6)
    assert 1.0 <= seg <= mb and 0.0 < share < 1.0


def test_public_render_routes_media_to_k2():
    """Renderer.render takes a world with media to K2 on its own: a scene
    of under 49 primitives too (K1's size), and the dense search there;
    from BVH_MIN_PRIMS primitives, media counted, the walk."""
    world, camera, bg = port_world("glass", 8, 6)
    img = rt.Renderer(2, max_bounces=6, background_color=bg, seed=3,
                      device="cpu").render(camera, world)
    r = mk.MegakernelRenderer(world.build(), camera, bg, "cpu")
    assert (r.n_sph, r.n_quad, r.n_med) == (1, 1, 1)
    assert not r.bvh and not r.chunk_cull
    want = r.render(spp=2, max_bounces=6, seed=3, packed=None)
    np.testing.assert_array_equal(
        img.data, rt.Image.from_linear(want, gamma=2.2).data)
    walk = _renderer("walk", 8, 6)
    assert walk.n_sph + walk.n_quad + walk.n_med >= mk.BVH_MIN_PRIMS
    assert walk.bvh and walk.flat.nodes.shape == (
        2 * (walk.n_sph + walk.n_quad + walk.n_med) - 1, 8)


def test_a_vanishing_medium_keeps_every_bit():
    """A scene's image without media is its image with a medium that never
    scatters (density 1e-30 puts every free flight beyond the boundary):
    the media's draws take streams no surface draw uses, so the HAS_MED
    path changes no other draw, and the image bits are the dense and
    walk twins' alike."""
    desc = dict(DESCS["walk"], media=[])
    faint = dict(desc, media=[dict(DESCS["walk"]["media"][1],
                                   density=1e-30)])
    imgs = []
    for d in (desc, faint):
        world, camera, bg = port_world(None, 10, 8, desc=d)
        r = mk.MegakernelRenderer(world.build(), camera, bg, "cpu")
        imgs.append(r.render(spp=2, max_bounces=8, seed=11))
    assert torch.equal(imgs[0], imgs[1])


def test_block_cull_lowering_with_media():
    """K2's block cull with media (forced on 600 spheres): the spheres are
    Morton-ordered into three blocks of ROW_CHUNK rows, the media's rows
    and payload rows follow the quads as on the other routes, and the
    twin over that lowering gives the plain lowering's image bit for
    bit."""
    world, camera, bg = port_world(None, 8, 6, desc=CULL)
    scene = world.build()
    cull = mk.MegakernelRenderer(scene, camera, bg, "cpu", chunk_cull=True)
    dense = mk.MegakernelRenderer(scene, camera, bg, "cpu", bvh=False)
    f, g = cull.flat, dense.flat
    assert cull.chunk_cull and not cull.bvh and f.nodes is None
    assert f.aabbs.shape == (3, 8) and f.n_sph == 600 and f.n_med == 2
    assert not np.array_equal(f.sph, g.sph)
    np.testing.assert_array_equal(np.sort(f.sph, 0), np.sort(g.sph, 0))
    np.testing.assert_array_equal(f.med, g.med)
    np.testing.assert_array_equal(f.pay[-2:], g.pay[-2:])
    args = dict(spp=2, max_bounces=6, seed=3_000_000_019)
    assert torch.equal(cull.render(**args), dense.render(**args))


def test_medium_rows_and_payload():
    """K2's lowering: a medium is a row (centre, r^2, -1/density) after
    the quads, its payload row (kind ISOTROPIC, its albedo) after theirs,
    and its box a leaf of the walk's tree."""
    r = _renderer("overlap", 8, 6, bvh=True)
    f = r.flat
    assert f.med.shape == (2, 8) and f.n_med == 2
    m = DESCS["overlap"]["media"]
    np.testing.assert_array_equal(
        f.med[:, 0:3], np.float32([x["boundary"]["center"] for x in m]))
    np.testing.assert_array_equal(
        f.med[:, 3], np.float32([1.0, 1.0]) ** 2)
    np.testing.assert_array_equal(
        f.med[:, 4], np.float32(-1.0) / np.float32([1.0, 3.0]))
    m0 = f.pay.shape[0] - 2
    assert m0 == st.medium_row0(st.compact_scene(r.scene)) == 8
    assert (f.pay[m0:, 7] == 4.0).all()
    np.testing.assert_array_equal(f.pay[m0:, 8:11],
                                  np.float32([x["albedo"] for x in m]))
    leaves = f.nodes.view(np.int32)[:, 3]
    assert sorted(leaves[leaves >= 0]) == [0, m0, m0 + 1]
    assert st.used_kind_flags(r.scene) == (False, False)
    assert st.used_kind_flags(r.scene, media=True) == (False, False, True)


def _walk(f, o, d, key):
    """(t, row) of rays by K2's walk over `f.nodes` (csrc/megakernel.cu,
    BvhScene::walk<true>), every ray a lane, medium leaves tested with the
    twin's medium_ts."""
    nodes = torch.from_numpy(f.nodes)
    bits = nodes.view(torch.int32)
    sph, quad = torch.from_numpy(f.sph), torch.from_numpy(f.quad)
    med = torch.from_numpy(f.med)
    q_row0 = f.sph.shape[0] if f.n_sph else 0
    m_row0 = f.pay.shape[0] - f.n_med
    seed, pid, samp, b = key
    u = torch.stack([rng.uniform4(seed, pid, samp,
                                     mk.medium_stream(b, k))[0]
                     for k in range(f.n_med)])
    m, n = nodes.shape[0], o.shape[0]
    inv = 1.0 / torch.where(d.abs() < 1e-24, torch.full_like(d, 1e-24), d)
    best = torch.full((n,), mk.MISS)
    win = torch.full((n,), -1, dtype=torch.int64)
    node = torch.zeros((n,), dtype=torch.int64)
    cols = lambda v: [v[:, k:k + 1] for k in range(3)]  # noqa: E731
    while True:
        act = torch.nonzero(node < m).flatten()
        if act.numel() == 0:
            return best, win
        nd = node[act]
        row = bits[nd, 3].long()
        oo, dd, ii, bb, ww = o[act], d[act], inv[act], best[act], win[act]
        ts = torch.full_like(bb, mk.MISS)
        for sel, fn in (
                ((row >= 0) & (row < q_row0), lambda s: mk.sphere_ts(
                    sph[row[s]], *cols(oo[s]), *cols(dd[s]))[:, 0]),
                ((row >= q_row0) & (row < m_row0), lambda s: mk.quad_ts(
                    quad[row[s] - q_row0], *cols(oo[s]), *cols(dd[s]))[:, 0]),
                (row >= m_row0, lambda s: mk.medium_ts(
                    med[row[s] - m_row0], *cols(oo[s]), *cols(dd[s]),
                    u[row[s] - m_row0, act[s]][:, None])[:, 0])):
            if sel.any():
                ts[sel] = fn(sel)
        leaf = row >= 0
        take = leaf & ((ts < bb) | ((ts == bb) & (row < ww)))
        best[act] = torch.where(take, ts, bb)
        win[act] = torch.where(take, row, ww)
        t0 = (nodes[nd, 0:3] - oo) * ii
        t1 = (nodes[nd, 4:7] - oo) * ii
        lo = torch.clamp_min(torch.minimum(t0, t1).amax(1), mk.T_MIN)
        enter = lo <= torch.minimum(torch.maximum(t0, t1).amin(1), bb)
        node[act] = torch.where(leaf | ~enter, bits[nd, 7].long(), nd + 1)


@pytest.mark.parametrize("name", ["walk", "inside"])
def test_walk_with_medium_leaves_matches_dense_selection(name):
    """The walk over the lowered tree, media at its leaves, selects the
    dense search's (t, row) bit for bit on camera rays and on rays that
    leave the scene's hits in random directions (inside a fog and a
    ball); the media win a share of them."""
    r = _renderer(name, 16, 12, bvh=True)
    f = r.flat
    sph, quad, pay = (torch.from_numpy(a) for a in (f.sph, f.quad, f.pay))
    med = torch.from_numpy(f.med)
    hit = mk.flat_closest_hit(sph, quad, pay, f.n_sph, f.n_quad, med,
                              f.n_med)
    pid = torch.arange(16 * 12)
    o, d = generate_rays(r.camera, pid, 0, 5)
    gen = np.random.default_rng(5)
    for b in range(3):
        key = (2 ** 31 + 7, pid, 4, b)
        best, ok, w = hit(*o.unbind(1), *d.unbind(1), key=key)
        t, row = _walk(f, o, d, key)
        assert torch.equal(t.view(torch.int32), best.view(torch.int32))
        # the dense winner's row, by its payload: a medium's kind is 4
        assert torch.equal(row >= f.pay.shape[0] - f.n_med,
                           ok & (w[4] > 3.5))
        assert bool((w[4] > 3.5).any())
        p = o + torch.where(ok, best, 1.0)[:, None] * d
        o = torch.where(ok[:, None], p, o)
        v = torch.from_numpy(gen.normal(size=tuple(o.shape)).astype(
            np.float32))
        d = v / torch.sqrt((v * v).sum(1, keepdim=True))


def test_other_entry_points_refuse_media():
    """K1, K3, the BVH accelerator, the modular tracer, K5 and K4 raise a
    ValueError that names them on a scene with a medium."""
    from tinyraytracer_tpu_torch.diff import inverse
    from tinyraytracer_tpu_torch.ops import intersect_kernel as ik

    world, camera, bg = port_world("glass", 8, 6)
    scene = world.build()
    r = mk.MegakernelRenderer(scene, camera, bg, "cpu")
    with pytest.raises(ValueError, match="K1 cannot render participating"):
        r.render(spp=1, max_bounces=2, packed=True)
    with pytest.raises(ValueError, match="K3 cannot"):
        ik.compact_rows(scene, "cpu")
    for acc, what in (("bvh", "BVH accelerator"),
                      ("none", "modular tracer")):
        with pytest.raises(ValueError, match=what):
            rt.Renderer(1, max_bounces=2, background_color=bg, device="cpu",
                        accelerator=acc).render(camera, world)
    target = torch.zeros((6, 8, 3))
    with pytest.raises(ValueError, match=r"fused train step \(K5, K4\)"):
        inverse.make_fused_train_step(scene, camera, target, spp=1,
                                      max_bounces=2, background=bg,
                                      device="cpu")
    with pytest.raises(ValueError, match=r"fused train step \(K5, K4\)"):
        inverse.make_fused_train_step(
            scene, camera, target, spp=1, max_bounces=2, background=bg,
            trainable=("sph_center",), trainable_rows={"sph": [0]},
            device="cpu")


def test_constant_medium_api():
    """The boundary must be a Sphere and the density positive; a world
    keeps media apart from its surfaces, and its arrays carry them over
    devices and numpy."""
    s = rt.Sphere((0.0, 0.0, 0.0), 1.0, "m")
    with pytest.raises(ValueError, match="boundary must be a Sphere"):
        rt.ConstantMedium(rt.Quad((0, 0, 0), (1, 0, 0), (0, 1, 0), "m"),
                          1.0, (1, 1, 1))
    for bad in (0.0, -1.0, float("inf")):
        with pytest.raises(ValueError, match="density"):
            rt.ConstantMedium(s, bad, (1, 1, 1))
    world, _, _ = port_world("overlap", 4, 4)
    assert len(world.media) == 2 and len(world.geometries) == 1
    scene = world.build()
    a = scene.numpy()
    assert scene.num_media == 2 and a["med_density"].tolist() == [1.0, 3.0]
    back = rt.scene_from_numpy(a, "cpu")
    for k, v in back.numpy().items():
        np.testing.assert_array_equal(v, a[k])
    assert scene.to("cpu").num_media == 2
    plain = {k: v for k, v in a.items() if not k.startswith("med_")}
    assert rt.scene_from_numpy(plain, "cpu").med_center is None
    with pytest.raises(KeyError, match="medium fields"):
        rt.scene_from_numpy(dict(plain, med_center=a["med_center"]), "cpu")


def test_rtnw_final_scene_matches_the_port():
    """The `rtnw_final` configuration's description: 1 006 spheres, 2 401
    quads and 2 media in the port's World.build() equal the reference's
    arrays, media included, and its camera vector."""
    from perfbench.reference import media, scene
    from perfbench.traffic import render_media

    with open(f"{ROOT}/perfbench/configs/rtnw_final.json") as f:
        desc = render_media.description(json.load(f))
    world, camera = render_media.port_scene(desc, 40, 40)
    port = world.build().numpy()
    ref = scene.arrays(desc).numpy()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert (int(port["sph_valid"].sum()), int(port["quad_valid"].sum()),
            port["med_center"].shape[0]) == (1006, 2401, 2)
    rows = media.media(desc).rows.numpy()
    f = st.lower_flat(world.build(), camera, (0.0, 0.0, 0.0),
                      chunk_cull=False)
    np.testing.assert_array_equal(f.med[:, :5], rows)
    cam = scene.camera_vector(desc, 40, 40)
    cam[23] = 0.0
    np.testing.assert_array_equal(
        st.camera_vector(camera, desc["background"])[0], cam)
    r = mk.MegakernelRenderer(world.build(), camera, (0.0, 0.0, 0.0), "cpu")
    assert r.bvh and not r.chunk_cull


def test_medium_share_reader(monkeypatch):
    """medium_share.render: medium_scatters over lane_segments, %, and
    None where the counter is absent or nothing counted."""
    import importlib.util
    import types

    from perfbench import program

    spec = importlib.util.spec_from_file_location(
        "medium_share", f"{ROOT}/perfbench/layer_metrics/"
        "medium_share.render.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    for dev, want in (({"lane_segments": 400, "medium_scatters": 100}, 25.0),
                      ({"lane_segments": 400}, None), ({}, None)):
        monkeypatch.setattr(program, "snapshot",
                            lambda d=dev: {"device": d})
        assert reader.read(types.SimpleNamespace()) == want


def test_new_cells_found_by_name():
    """Each pair of configuration and traffic names one cell; the
    north-star cell's traffic kind is the train traffic's closed loop, and
    a tiny run of it on the CPU passes its check."""
    from perfbench import core

    with open(f"{ROOT}/BENCHMARK.json") as f:
        cells = json.load(f)["workloads"]
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    cell = core.find_cell("cornell.train_northstar")
    from perfbench.traffic import train
    assert core.traffic_class(cell.entry["traffic"]) is train.Cell
    cell.params.update(width=8, height=6, spp=1, max_bounces=2)
    out = core.run(cell, seed=2 ** 31 + 7, seconds=0.05, trace=False,
                   device="cpu")
    assert out["correct"] and out["failed"] == 0
