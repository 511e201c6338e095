"""The plain reference against the system's CPU twins at a tiny size:
the same scene lowering, the same image, the same training steps."""

import numpy as np
import pytest
import torch

from perfbench import scenes
from perfbench.reference import forward, scene as rs, step as rstep
from perfbench.traffic.train import make_target

CONFIGS = ["cornell", "rtiow_final"]


def _desc(name):
    return scenes.description(
        scenes.load_config(f"perfbench/configs/{name}.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_scene_arrays_and_camera_match_the_port(name):
    from tinyraytracer_tpu_torch.ops import scene_table

    desc = _desc(name)
    world, camera = scenes.port_scene(desc, 24, 16)
    port = world.build().numpy()
    ref = rs.arrays(desc).numpy()
    assert set(port) == set(ref)
    for k in port:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    cam = rs.camera_vector(desc, 24, 16)
    cam[23] = 0.0
    np.testing.assert_array_equal(
        scene_table.camera_vector(camera, desc["background"])[0], cam)


@pytest.mark.parametrize("name", CONFIGS)
def test_presets_give_the_same_scene(name):
    from tinyraytracer_tpu_torch.models import presets

    fn = {"cornell": presets.cornell_box,
          "rtiow_final": presets.random_spheres}[name]
    world, _, kw = fn(16, 9)
    desc = _desc(name)
    ref = rs.arrays(desc).numpy()
    for k, v in world.build().numpy().items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert tuple(desc["background"]) == tuple(kw["background"])


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_twin(name):
    import tinyraytracer_tpu_torch as rt

    w, h, spp, mb, seed = 20, 12, 3, 6, 2 ** 31 + 9
    desc = _desc(name)
    world, camera = scenes.port_scene(desc, w, h)
    img = rt.Renderer(samples_per_pixel=spp, max_bounces=mb,
                      background_color=tuple(desc["background"]), seed=seed,
                      device="cpu").render(camera, world).data
    pix = np.array([0, 5, 37, 100, 177, w * h - 1])
    low = rs.lower(rs.arrays(desc))
    cam = torch.from_numpy(rs.camera_vector(desc, w, h))
    lin, seg = forward.render_pixels(low, cam, torch.from_numpy(pix),
                                     width=w, spp=spp, seed=seed,
                                     max_bounces=mb)
    got = img.reshape(-1, 3)[pix]
    np.testing.assert_allclose(forward.gamma(lin.numpy()), got, rtol=0,
                               atol=1e-6)
    assert 1.0 <= seg <= mb


@pytest.mark.parametrize("name,kw", [
    ("cornell", {}),
    ("rtiow_final", {"trainable": ("sph_center", "mat_albedo"),
                     "rows": 8})])
def test_train_steps_match_the_twin(name, kw):
    from tinyraytracer_tpu_torch.diff.inverse import make_fused_train_step

    w, h, spp, mb, seed = 10, 8, 2, 3, 12345
    desc = _desc(name)
    world, camera = scenes.port_scene(desc, w, h)
    target = make_target(7, w, h, 4, 0.6, "cpu")
    rows, extra = None, {}
    if "rows" in kw:
        a = rs.arrays(desc).numpy()
        rows = {"sph": [int(r) for r in np.nonzero(a["sph_valid"])[0][:8]],
                "quad": []}
        extra = dict(trainable=kw["trainable"], trainable_rows=rows)
    step, (params, opt) = make_fused_train_step(
        world.build(), camera, target, spp=spp, max_bounces=mb,
        background=tuple(desc["background"]), seed=seed, device="cpu",
        **extra)
    p0 = {k: v.clone() for k, v in params.items()}
    losses = []
    for i in range(3):
        params, opt, loss = step(params, opt, i)
        losses.append(float(loss))
        if i == 0:
            g1 = {k: m / 0.1 for k, m in opt[0].mu.items()}
    ref = rstep.Step(desc, target, width=w, height=h, spp=spp,
                     max_bounces=mb, seed=seed,
                     trainable=kw.get("trainable"), trainable_rows=rows)
    rl, rg, rc, seg = ref.run(3)
    np.testing.assert_allclose(losses, rl, rtol=1e-6)
    gp, gr = rstep.leaf_norms(g1), rstep.leaf_norms(rg)
    assert rstep.worst_leaf_gap(gp, gr) < 1e-5
    cp = rstep.leaf_norms({k: params[k] - p0[k] for k in p0})
    cr = rstep.leaf_norms(rc)
    assert rstep.worst_leaf_gap(cp, cr, rstep.moved_leaves(gr)) < 1e-5
    assert 1.0 <= seg <= mb
