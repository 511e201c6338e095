"""K2's BVH route on the CPU: the tree's lowering (`scene_table.bvh_nodes`),
the route rule (`MegakernelRenderer`), and a plain walk over the lowered
tree, the kernel's loop written out in PyTorch, held to the dense
selection (`flat_closest_hit`) bit for bit: the same t and the same row,
exact ties included. The kernel itself is held to the dense kernel and
the twin on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.models.camera import generate_rays
from tinyraytracer_tpu_torch.ops import bvh as bvh_ops
from tinyraytracer_tpu_torch.ops import megakernel as mk
from tinyraytracer_tpu_torch.ops import scene_table as st
from torch_k3_scenes import bench_world, k3_world

# (label, world builder): spheres alone, a planted exact tie (a copy of
# the last sphere after it), and spheres with quads (Cornell's 18, whose
# light lies in the ceiling's plane: quads that tie) over 48 primitives
SCENES = {
    "spheres": lambda: k3_world("random_spheres", n=60),
    "tie": lambda: k3_world("random_spheres", n=60, coincident=True),
    "quads": lambda: k3_world("cornell_box", extra=36),
}


def _lowered(world, camera, kw):
    r = mk.MegakernelRenderer(world.build(), camera, kw["background"], "cpu",
                              bvh=True)
    return r, r.flat


@pytest.mark.parametrize("name", list(SCENES))
def test_k2_tree_lowering(name):
    """Every real row sits in exactly one leaf, a leaf's row is K2's
    number of the builder's primitive (sphere k is row k, quad j row
    q_row0 + j), the links thread the tree in DFS preorder, and each
    node's box holds the bounds of its rows."""
    world, camera, kw = SCENES[name]()
    r, f = _lowered(world, camera, kw)
    scene = r.scene
    cs = st.compact_scene(scene)
    tree = bvh_ops.build_bvh(scene).numpy()
    bits = f.nodes.view(np.int32)
    m = 2 * (f.n_sph + f.n_quad) - 1
    assert f.nodes.shape == (m, 8) and f.nodes.dtype == np.float32
    assert f.aabbs is None
    q_row0 = cs.ns if f.n_sph else 0
    want = np.concatenate([np.arange(f.n_sph),
                           q_row0 + np.arange(f.n_quad)])
    leaves = bits[:, 3] >= 0
    assert np.array_equal(np.sort(bits[leaves, 3]), want)
    # a leaf's row is the builder's primitive, by compact_scene's map
    compact = np.where(bits[leaves, 3] < q_row0, bits[leaves, 3],
                       cs.ns + bits[leaves, 3] - q_row0)
    assert np.array_equal(cs.index_map[compact], tree["leaf_prim"][leaves])
    assert np.array_equal(f.nodes[:, 0:3], tree["node_min"])
    assert np.array_equal(f.nodes[:, 4:7], tree["node_max"])
    assert np.array_equal(bits[:, 7], tree["miss_link"])
    # threading: a leaf escapes to the next node, an inner node's subtree
    # is [i, miss) and ends at M
    idx = np.arange(m)
    assert np.array_equal(bits[leaves, 7], idx[leaves] + 1)
    assert ((bits[:, 7] > idx) & (bits[:, 7] <= m)).all() and bits[0, 7] == m
    # boxes: the rows' own bounds, as the builder pads them
    lo, hi, gid = bvh_ops.primitive_aabbs(scene)
    at = {int(g): k for k, g in enumerate(gid)}
    for i in range(m):
        rows = bits[i:bits[i, 7], 3]
        rows = rows[rows >= 0]
        compact = np.where(rows < q_row0, rows, cs.ns + rows - q_row0)
        p = [at[int(g)] for g in cs.index_map[compact]]
        assert p, i
        assert (f.nodes[i, 0:3] <= lo[p].min(0)).all(), i
        assert (f.nodes[i, 4:7] >= hi[p].max(0)).all(), i


def _spheres(n):
    from tinyraytracer_tpu_torch import Lambertian, Sphere, World

    w = World()
    w.add_material("m", Lambertian((0.5, 0.5, 0.5)))
    for i in range(n):
        w.add_geometry(Sphere((float(i % 64), float(i // 64), 0.0), 0.25,
                              "m"))
    return w.build()


def test_k2_route_rule():
    """The walk from BVH_MIN_PRIMS real primitives up to AUTO_CULL_ROWS
    padded rows; the dense search under it, the block cull over it. The
    forcing arguments: `bvh=False` keeps the dense search, `bvh=True`
    takes the walk over a scene the cull would take, and a forced cull
    with a forced walk raises."""
    _, camera, _ = presets.sphere_ground(width=4, height=4)
    t = mk.BVH_MIN_PRIMS
    for n, bvh, cull in ((t - 1, False, False), (t, True, False),
                         (mk.AUTO_CULL_ROWS, True, False),
                         (mk.AUTO_CULL_ROWS + 1, False, True)):
        r = mk.MegakernelRenderer(_spheres(n), camera, (0.5, 0.5, 0.5),
                                  "cpu")
        assert (r.bvh, r.chunk_cull) == (bvh, cull), n
    big = _spheres(mk.AUTO_CULL_ROWS + 1)
    r = mk.MegakernelRenderer(big, camera, (0, 0, 0), "cpu", bvh=True)
    assert (r.bvh, r.chunk_cull) == (True, False)
    r = mk.MegakernelRenderer(_spheres(t), camera, (0, 0, 0), "cpu",
                              bvh=False)
    assert (r.bvh, r.chunk_cull) == (False, False)
    assert r.flat.nodes is None and r.flat_tensors["nodes"] is None
    r = mk.MegakernelRenderer(_spheres(t), camera, (0, 0, 0), "cpu",
                              chunk_cull=True)
    assert (r.bvh, r.chunk_cull) == (False, True)
    with pytest.raises(ValueError, match="not both"):
        mk.MegakernelRenderer(big, camera, (0, 0, 0), "cpu", bvh=True,
                              chunk_cull=True)


def _cols(v):
    return [v[:, k:k + 1] for k in range(3)]


def walk_k2_tree(nodes, sph, quad, q_row0, o, d):
    """(t, row) of rays (R, 3) by K2's walk (csrc/megakernel.cu,
    BvhScene::closest_hit) over `scene_table.bvh_nodes`, every ray a lane:
    a leaf tests its row with the dense search's own hit tests and takes
    it on t < best, or t == best from a lower row; an inner node's box is
    slab-tested over [max(near, 1e-3), min(far, best)]. Also returns each
    ray's steps (nodes visited)."""
    bits = nodes.view(torch.int32)
    m, r, dev = nodes.shape[0], o.shape[0], o.device
    inv = 1.0 / torch.where(d.abs() < 1e-24, torch.full_like(d, 1e-24), d)
    best = torch.full((r,), mk.MISS, dtype=torch.float32, device=dev)
    win = torch.full((r,), -1, dtype=torch.int64, device=dev)
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    steps = torch.zeros((r,), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(node < m).flatten()
        if act.numel() == 0:
            return best, win, steps
        n = node[act]
        row = bits[n, 3].long()
        miss = bits[n, 7].long()
        oo, dd, ii = o[act], d[act], inv[act]
        b, w = best[act], win[act]
        ts = torch.full_like(b, mk.MISS)
        s = (row >= 0) & (row < q_row0)
        if s.any():
            ts[s] = mk.sphere_ts(sph[row[s]], *_cols(oo[s]),
                                 *_cols(dd[s]))[:, 0]
        q = row >= q_row0
        if q.any():
            ts[q] = mk.quad_ts(quad[row[q] - q_row0], *_cols(oo[q]),
                               *_cols(dd[q]))[:, 0]
        leaf = row >= 0
        take = leaf & ((ts < b) | ((ts == b) & (row < w)))
        best[act] = torch.where(take, ts, b)
        win[act] = torch.where(take, row, w)
        t0 = (nodes[n, 0:3] - oo) * ii
        t1 = (nodes[n, 4:7] - oo) * ii
        near = torch.minimum(t0, t1).amax(1)
        far = torch.maximum(t0, t1).amin(1)
        lo = torch.clamp_min(near, mk.T_MIN)
        enter = lo <= torch.minimum(far, b)
        node[act] = torch.where(leaf | ~enter, miss, n + 1)
        steps[act] += 1


def _dense(f, o, d):
    """(t, row) of the dense search: flat_closest_hit's t, and the row of
    the first minimum over spheres, then quads, in K2's numbering."""
    sph, quad, pay = (torch.from_numpy(a) for a in (f.sph, f.quad, f.pay))
    hit = mk.flat_closest_hit(sph, quad, pay, f.n_sph, f.n_quad)
    best, _, _ = hit(*o.unbind(1), *d.unbind(1))
    ts = []
    if f.n_sph:
        ts.append(mk.sphere_ts(sph[:f.n_sph], *o.unbind(1), *d.unbind(1)))
    if f.n_quad:
        ts.append(mk.quad_ts(quad[:f.n_quad], *o.unbind(1), *d.unbind(1)))
    ts = torch.cat(ts, 0)
    k = torch.argmin(ts, 0)
    q_row0 = f.sph.shape[0] if f.n_sph else 0
    row = torch.where(k < f.n_sph, k, q_row0 + k - f.n_sph)
    row = torch.where(best < mk.MISS, row, -1)
    return best, row


def _rays(camera, hit, n_bounce=3, seed=5):
    """Camera rays of every pixel, then `n_bounce` rounds of rays leaving
    each hit point in a random direction: rays that start on a surface,
    as K2's scattered rays do."""
    pid = torch.arange(camera.width * camera.height)
    o, d = generate_rays(camera, pid, 0, seed)
    rng = np.random.default_rng(seed)
    rays = [(o, d)]
    for _ in range(n_bounce):
        t, row = hit(o, d)
        keep = row >= 0
        o = (o + t[:, None] * d)[keep]
        u = torch.from_numpy(rng.normal(size=(o.shape[0], 3)).astype(
            np.float32))
        d = u / torch.sqrt((u * u).sum(1, keepdim=True))
        rays.append((o, d))
    return (torch.cat([x for x, _ in rays]).contiguous(),
            torch.cat([x for _, x in rays]).contiguous())


@pytest.mark.parametrize("name", ["rtiow_final", *SCENES])
def test_k2_walk_matches_dense_selection(name):
    """The walk over the lowered tree gives the dense search's (t, row)
    bit for bit, on the final scene's camera and scattered rays, on a
    planted tie (the copy's row never wins) and on spheres with quads;
    it tests a few dozen nodes a ray where the dense search tests every
    row."""
    world, camera, kw = (bench_world("rtiow_final", 48, 27)
                         if name == "rtiow_final" else SCENES[name]())
    _, f = _lowered(world, camera, kw)
    nodes = torch.from_numpy(f.nodes)
    sph, quad = torch.from_numpy(f.sph), torch.from_numpy(f.quad)
    q_row0 = f.sph.shape[0] if f.n_sph else 0
    o, d = _rays(camera, lambda o, d: _dense(f, o, d))
    want_t, want_row = _dense(f, o, d)
    got_t, got_row, steps = walk_k2_tree(nodes, sph, quad, q_row0, o, d)
    assert o.shape[0] > camera.width * camera.height
    assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(got_row, want_row)
    assert (want_row >= 0).float().mean() > 0.3
    if name == "tie":
        copy = f.n_sph - 1
        assert not (got_row == copy).any()
        assert (got_row == copy - 1).any()
    rows = f.n_sph + f.n_quad
    assert steps.float().mean() < rows
    if name == "rtiow_final":
        assert steps.float().mean() < 0.15 * rows


def test_flat_wrapper_checks_the_nodes():
    """render_flat takes a tree of 2N - 1 nodes over the N real rows, in
    f32 rows of 8, and not beside the cull's AABBs; the twin renders the
    same image with the nodes as without (it is dense on every route)."""
    world, camera, kw = SCENES["spheres"]()
    r, _ = _lowered(world, camera, kw)
    args = r.flat_args(spp=1, max_bounces=2)
    assert args["nodes"].shape == (2 * 60 - 1, 8)
    img = mk.render_flat(**args)
    assert torch.equal(img, mk.render_flat(**{**args, "nodes": None}))
    bad = [dict(nodes=args["nodes"][:-1].contiguous()),
           dict(nodes=args["nodes"].double()),
           dict(nodes=args["nodes"][:, :4].contiguous()),
           dict(aabbs=torch.zeros(1, 8))]
    for change in bad:
        with pytest.raises(ValueError):
            mk.render_flat(**{**args, **change})
