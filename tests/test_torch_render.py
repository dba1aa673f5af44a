"""The port's render slice end to end against the JAX package: PLY files
both ways, the scene readers, ``render`` and ``cli.render`` on a tiny
generated Blender scene, on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from event3dgs_tpu.cli.render import main as jrender_main
from event3dgs_tpu.data import ply as jply
from event3dgs_tpu.data import scene as jscene
from event3dgs_tpu.models import gaussians as jgauss
from event3dgs_tpu.ops.render import render as jrender
from event3dgs_tpu.ops.render import render_depth as jrender_depth
from event3dgs_tpu.utils.config import TrainConfig
from event3dgs_tpu_torch.cli.common import load_run_config
from event3dgs_tpu_torch.cli.render import main as trender_main
from event3dgs_tpu_torch.data import ply as tply
from event3dgs_tpu_torch.data import scene as tscene
from event3dgs_tpu_torch.models import gaussians as tgauss
from event3dgs_tpu_torch.ops.render import render as trender
from event3dgs_tpu_torch.ops.render import render_depth as trender_depth
from event3dgs_tpu_torch.tools.render_products import export_transforms_json

torch.set_num_threads(1)

W, H, N_GAUSS, ITER = 128, 96, 180, 7


def jax_params(seed=0, n=N_GAUSS, capacity=None):
    """Random degree-3 model, as the JAX package's GaussianParams."""
    rng = np.random.default_rng(seed)
    cap = capacity or n
    means = np.c_[rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                  rng.uniform(2.5, 6.0, n)]
    params = jgauss.init_from_point_cloud(means, rng.uniform(0, 1, (n, 3)), cap)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return params.replace(
        features_rest=f32(rng.normal(0, 0.15, (cap, 15, 3))),
        scaling=f32(np.log(rng.uniform(0.03, 0.2, (cap, 3)))),
        rotation=f32(rng.normal(size=(cap, 4))),
        opacity=f32(rng.normal(0.5, 1.0, (cap, 1))),
    )


def with_sh_degree_4(params, seed=4):
    """``params`` with 24 random higher-order coefficients (SH degree 4)."""
    rng = np.random.default_rng(seed)
    rest = rng.normal(0, 0.1, (params.capacity, 24, 3))
    return params.replace(features_rest=jnp.asarray(rest, jnp.float32))


def to_port(params):
    return tgauss.params_from_numpy(
        {f: np.asarray(getattr(params, f)) for f in tgauss.FIELDS}, device="cpu"
    )


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    """A Blender-style source (2 views, W×H) and one model dir per package."""
    root = tmp_path_factory.mktemp("tiny")
    src = root / "src"
    (src / "train").mkdir(parents=True)
    infos = [
        jscene.CameraInfo(uid=i, R=np.eye(3), T=np.asarray([0.15 * i, 0.0, 0.05 * i]),
                          fov_x=1.0, fov_y=0.8, image_path="", image_name="",
                          width=W, height=H)
        for i in range(2)
    ]
    export_transforms_json(infos, str(src / "transforms_train.json"))
    rng = np.random.default_rng(9)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            src / "train" / f"r_{i}.png")
    jply.store_point_cloud(str(src / "points3d.ply"),
                           rng.uniform(-1, 1, (20, 3)), np.full((20, 3), 128))
    cfg = TrainConfig()
    cfg.model.source_path = str(src)
    cfg.model.resolution = 1
    params = jax_params()
    models = {}
    for pkg in ("jax", "torch"):
        m = root / f"model_{pkg}"
        (m / "point_cloud" / f"iteration_{ITER}").mkdir(parents=True)
        (m / "cfg.json").write_text(cfg.to_json())
        jply.save_gaussian_ply(
            str(m / "point_cloud" / f"iteration_{ITER}" / "point_cloud.ply"),
            params)
        models[pkg] = m
    return src, models, params


def test_cli_render_pngs_match_jax(tiny_scene):
    _, models, _ = tiny_scene
    assert jrender_main(["-m", str(models["jax"]), "--skip_test"]) == 0
    assert trender_main(["-m", str(models["torch"]), "--skip_test",
                         "--device", "cpu"]) == 0
    for sub in ("renders", "gt"):
        for i in range(2):
            rel = os.path.join("train", f"ours_{ITER}", sub, f"{i:05d}.png")
            a = np.asarray(Image.open(models["jax"] / rel), np.int16)
            b = np.asarray(Image.open(models["torch"] / rel), np.int16)
            assert a.shape == b.shape == (H, W, 3)
            assert np.abs(a - b).max() <= 1, (rel, np.abs(a - b).max())
    img = np.asarray(Image.open(models["torch"] / "train" / f"ours_{ITER}"
                                / "renders" / "00000.png"))
    assert img.max() > 0  # the Gaussians are in view


def test_cli_rejects_unported_flags(tiny_scene):
    """Every flag of the JAX parser is ported (``--event`` too; its end-to-end
    tests are in ``test_torch_event_render``), and each parses to the JAX
    parser's value."""
    from event3dgs_tpu.cli.render import build_parser as jparser
    from event3dgs_tpu_torch.cli.render import build_parser as tparser

    for flags in ([], ["--depth", "--point", "--export_transforms"],
                  ["--blurrySpeed", "0"], ["--blurrySpeed", "3"],
                  ["--interpolationN", "5", "--dt", "250.5"], ["--event"],
                  ["--event", "--interpolationN", "2"]):
        j = vars(jparser().parse_args(["-m", "x", *flags]))
        t = vars(tparser().parse_args(["-m", "x", *flags]))
        for key in ("depth", "point", "event", "blurrySpeed", "interpolationN",
                    "dt", "export_transforms"):
            assert t[key] == j[key], (flags, key)
    assert set(vars(jparser().parse_args(["-m", "x"]))) <= set(
        vars(tparser().parse_args(["-m", "x"])))


@pytest.mark.parametrize("rasterizer", ["tiled", "reference"])
def test_render_matches_jax(tiny_scene, rasterizer):
    src, _, params = tiny_scene
    jinfo = jscene.read_blender_scene(str(src))
    tinfo = tscene.read_blender_scene(str(src))
    jcam = jscene.build_camera_batch(jinfo.train_cameras, 1)[1]
    tcam = tscene.build_camera_batch(tinfo.train_cameras, 1, device="cpu")[1]
    ja, ta = jgauss.activated(params), tgauss.activated(to_port(params))
    bg = np.float32([0.2, 0.1, 0.0])
    ref = jrender(ja.means3d, ja.features, ja.opacities, ja.scales,
                  ja.rotations, jcam, jnp.asarray(bg), sh_degree=3,
                  rasterizer=rasterizer)
    out = trender(ta.means3d, ta.features, ta.opacities, ta.scales,
                  ta.rotations, tcam, torch.tensor(bg), sh_degree=3,
                  rasterizer=rasterizer)
    np.testing.assert_array_equal(out.visibility.numpy(), np.asarray(ref.visibility))
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("rasterizer", ["tiled", "reference"])
def test_render_at_sh_degree_4_matches_jax(tiny_scene, rasterizer):
    src, _, params = tiny_scene
    params = with_sh_degree_4(params)
    jcam = jscene.build_camera_batch(jscene.read_blender_scene(str(src)).train_cameras, 1)[0]
    tcam = tscene.build_camera_batch(tscene.read_blender_scene(str(src)).train_cameras,
                                     1, device="cpu")[0]
    ja, ta = jgauss.activated(params), tgauss.activated(to_port(params))
    assert ta.features.shape[1] == 25
    ref = jrender(ja.means3d, ja.features, ja.opacities, ja.scales,
                  ja.rotations, jcam, jnp.zeros(3), sh_degree=4,
                  rasterizer=rasterizer)
    out = trender(ta.means3d, ta.features, ta.opacities, ta.scales,
                  ta.rotations, tcam, torch.zeros(3), sh_degree=4,
                  rasterizer=rasterizer)
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image),
                               atol=2e-5, rtol=1e-4)
    deg3 = trender(ta.means3d, ta.features, ta.opacities, ta.scales,
                   ta.rotations, tcam, torch.zeros(3), sh_degree=3,
                   rasterizer=rasterizer)
    assert (deg3.image - out.image).abs().max() > 1e-3  # degree 4 counts


def test_render_depth_matches_jax(tiny_scene):
    src, _, params = tiny_scene
    jcam = jscene.build_camera_batch(jscene.read_blender_scene(str(src)).train_cameras, 1)[0]
    tcam = tscene.build_camera_batch(tscene.read_blender_scene(str(src)).train_cameras,
                                     1, device="cpu")[0]
    ja, ta = jgauss.activated(params), tgauss.activated(to_port(params))
    ref = jrender_depth(ja.means3d, ja.opacities, ja.scales, ja.rotations,
                        jcam, jnp.zeros(3))
    out = trender_depth(ta.means3d, ta.opacities, ta.scales, ta.rotations,
                        tcam, torch.zeros(3))
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image),
                               atol=1e-4, rtol=1e-4)


def test_scene_readers_match_jax(tiny_scene):
    src, models, _ = tiny_scene
    jinfo = jscene.read_blender_scene(str(src))
    tinfo = tscene.read_blender_scene(str(src))
    assert tscene.detect_scene_type(str(src)) == jscene.detect_scene_type(str(src))
    for a, b in zip(jinfo.train_cameras, tinfo.train_cameras):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.fov_x, a.fov_y, a.width, a.height, a.image_name) == \
            (b.fov_x, b.fov_y, b.width, b.height, b.image_name)
    np.testing.assert_array_equal(tinfo.translate, jinfo.translate)
    jc = jscene.build_camera_batch(jinfo.train_cameras, 2)
    tc = tscene.build_camera_batch(tinfo.train_cameras, 2, device="cpu")
    assert (tc.width, tc.height) == (jc.width, jc.height) == (W // 2, H // 2)
    for f in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), atol=1e-5)
    np.testing.assert_array_equal(
        tscene.load_images_array(tinfo.train_cameras, 2),
        jscene.load_images_array(jinfo.train_cameras, 2))
    for w, h, r in [(1920, 1080, -1), (1600, 900, -1), (3200, 1800, -1),
                    (640, 480, 2), (640, 480, 320)]:
        assert tscene.resolve_resolution(w, h, r) == jscene.resolve_resolution(w, h, r)
    cfg = load_run_config(str(models["torch"]))
    assert cfg.model.source_path == str(src) and cfg.model.resolution == 1


def test_ply_roundtrips_between_packages(tmp_path):
    params = jax_params(seed=3, n=30, capacity=40)  # 10 dead slots
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.save_gaussian_ply(jpath, params)
    tply.save_gaussian_ply(tpath, to_port(params))
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()  # byte-identical files
    # JAX file → port, and port file → JAX
    from_j = tply.load_gaussian_ply(jpath, capacity=40, device="cpu")
    from_t = jply.load_gaussian_ply(tpath, capacity=40)
    for f in tgauss.FIELDS:
        np.testing.assert_array_equal(getattr(from_j, f).numpy(),
                                      np.asarray(getattr(from_t, f)))
    alive = np.asarray(params.alive)
    for f in tgauss.FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(from_j, f).numpy()[:30],
                                      np.asarray(getattr(params, f))[alive])
    assert tgauss.num_alive(from_j) == 30


def test_ply_roundtrips_between_packages_at_sh_degree_4(tmp_path):
    params = with_sh_degree_4(jax_params(seed=5, n=30, capacity=40))
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.save_gaussian_ply(jpath, params)
    tply.save_gaussian_ply(tpath, to_port(params))
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    from_j = tply.load_gaussian_ply(jpath, max_sh_degree=4, device="cpu")
    from_t = jply.load_gaussian_ply(tpath, max_sh_degree=4)
    assert from_j.sh_coeffs == 25
    for f in tgauss.FIELDS:
        np.testing.assert_array_equal(getattr(from_j, f).numpy(),
                                      np.asarray(getattr(from_t, f)))
    with pytest.raises(ValueError, match="f_rest"):
        tply.load_gaussian_ply(jpath, max_sh_degree=3, device="cpu")
