"""The port's render products against the JAX package's, on the CPU: pose
interpolation, interpolated camera chains, the point-depth z-buffer, and
the depth, point, blurry and ``transforms_train.json`` outputs of
``cli.render`` on the tiny Blender scene of ``test_torch_render``."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from event3dgs_tpu.cli.render import main as jrender_main
from event3dgs_tpu.data import scene as jscene
from event3dgs_tpu.tools import render_products as jprod
from event3dgs_tpu_torch.cli.render import main as trender_main
from event3dgs_tpu_torch.core.camera import Camera
from event3dgs_tpu_torch.core.camera import make_camera as tmake_camera
from event3dgs_tpu_torch.data import scene as tscene
from event3dgs_tpu_torch.tools import render_products as tprod
from test_torch_render import ITER, H, W, tiny_scene, to_port  # noqa: F401

torch.set_num_threads(1)


def poses(seed, n=6):
    """Random rotations and translations, with the pairs (0, 1) identical
    (slerp's nlerp limit) and (2, 3) on opposite quaternion hemispheres."""
    rng = np.random.default_rng(seed)
    R = Rotation.random(n, random_state=seed).as_matrix()
    R[1] = R[0]
    q3 = Rotation.from_matrix(R[2]).as_quat() * -1.0
    R[3] = Rotation.from_quat(q3 + rng.normal(0, 0.05, 4)).as_matrix()
    return R, rng.uniform(-2, 2, (n, 3))


@pytest.mark.parametrize("fn", ["nlerp_pose", "slerp_pose"])
def test_pose_interpolation_is_bit_equal(fn):
    R, t = poses(0)
    for i in range(len(R) - 1):
        for alpha in (0.0, 0.25, 0.5, 1.0 / 3.0, 0.9, 1.0):
            jR, jt = getattr(jprod, fn)(R[i], t[i], R[i + 1], t[i + 1], alpha)
            tR, tt = getattr(tprod, fn)(R[i], t[i], R[i + 1], t[i + 1], alpha)
            np.testing.assert_array_equal(tR, jR)
            np.testing.assert_array_equal(tt, jt)


def test_interpolated_cameras_match(tiny_scene):
    """The same poses bit for bit; each camera is the port's ``make_camera``
    of its pose and within 1e-5 of the JAX camera (the port builds camera
    matrices in float64, the JAX package in float32)."""
    src, _, _ = tiny_scene
    infos = jscene.read_blender_scene(str(src)).train_cameras
    tinfos = tscene.read_blender_scene(str(src)).train_cameras
    jcams, jtags = jprod.interpolated_cameras(infos, 3, W, H)
    tcams, ttags = tprod.interpolated_cameras(tinfos, 3, W, H, device="cpu")
    assert ttags == jtags and len(tcams) == len(jcams) == 4
    for k, (i, s) in enumerate(ttags[:-1]):
        R, t = jprod.nlerp_pose(infos[i].R, infos[i].T, infos[i + 1].R,
                                infos[i + 1].T, s / 3)
        want = tmake_camera(R, t, infos[i].fov_x, infos[i].fov_y, W, H,
                            device="cpu")
        for f in ("world_view", "full_proj", "camera_center", "tan_fovx"):
            assert torch.equal(getattr(tcams[k], f), getattr(want, f)), f
            np.testing.assert_allclose(getattr(tcams[k], f).numpy(),
                                       np.asarray(getattr(jcams[k], f)),
                                       atol=1e-5)
    assert (tcams[-1].width, tcams[-1].height) == (W, H)


def port_camera(jcam):
    return Camera(*(torch.tensor(np.asarray(getattr(jcam, f))) for f in (
        "world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")),
        width=jcam.width, height=jcam.height)


@pytest.mark.parametrize("view", [0, 1])
def test_point_depth_map_is_exact(tiny_scene, view):
    src, _, params = tiny_scene
    jcam = jscene.build_camera_batch(
        jscene.read_blender_scene(str(src)).train_cameras, 1)[view]
    for thr in (0.8, 0.3):
        ref = np.asarray(jprod.point_depth_map(params, jcam, thr))
        out = tprod.point_depth_map(to_port(params), port_camera(jcam), thr)
        assert out.shape == (H, W)
        np.testing.assert_array_equal(out.numpy(), ref)
        assert 0 < np.isfinite(ref).sum() < H * W


def read_png(path):
    return np.asarray(Image.open(path), np.int16)


def test_cli_render_products_match_jax(tiny_scene):
    _, models, _ = tiny_scene
    flags = ["--depth", "--point", "--blurrySpeed", "1", "--export_transforms",
             "--skip_test", "--skip_train"]
    assert jrender_main(["-m", str(models["jax"]), *flags]) == 0
    assert trender_main(["-m", str(models["torch"]), *flags,
                         "--device", "cpu"]) == 0
    base = os.path.join("train", f"ours_{ITER}")
    for sub, names in (("depth", ["depth_00000.png", "depth_00001.png"]),
                       ("point", ["point_00000.png", "point_00001.png"]),
                       ("blurry", ["blurry_00000.png"])):
        for pkg in ("jax", "torch"):
            assert sorted(os.listdir(models[pkg] / base / sub)) == names
        for name in names:
            a = read_png(models["jax"] / base / sub / name)
            b = read_png(models["torch"] / base / sub / name)
            assert a.shape == b.shape and a.shape[:2] == (H, W)
            assert np.abs(a - b).max() <= 1, (sub, name, np.abs(a - b).max())
            assert a.std() > 0, (sub, name)  # not a flat image
    with open(models["jax"] / "transforms_train.json") as f:
        want = json.load(f)
    with open(models["torch"] / "transforms_train.json") as f:
        assert json.load(f) == want


def test_blurry_speed_zero_writes_no_blur(tiny_scene, tmp_path):
    """``--blurrySpeed 0`` (the default) renders no blurry set, as in JAX."""
    _, models, _ = tiny_scene
    model = tmp_path / "model"
    shutil.copytree(models["torch"], model)
    shutil.rmtree(model / "train", ignore_errors=True)
    assert trender_main(["-m", str(model), "--skip_test", "--blurrySpeed", "0",
                         "--device", "cpu"]) == 0
    assert sorted(os.listdir(model / "train" / f"ours_{ITER}")) == ["gt", "renders"]
