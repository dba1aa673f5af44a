"""Scene loading: the reference's dataset contract → cameras and images.

Counterpart of ``event3dgs_tpu/data/scene.py`` (numpy readers, torch
cameras).

Implements both scene types the reference supports
(`scene/dataset_readers.py:311-314`):

- **COLMAP** scenes with the 4-folder layout: train images in `images/`
  (or `--images`), event-timed frames in `images_event/`, blurry captures in
  `images_blurry/`, held-out test renders in `renders/` — all sharing the
  COLMAP poses in `sparse/0` (`readColmapSceneInfo`, `:134-227`).
- **Blender** scenes via `transforms_train.json` / `transforms_test.json`
  with random point-cloud init (`readNerfSyntheticInfo`, `:270-309`).

Resolution policy matches `utils/camera_utils.py:19-52`: `-r {1,2,4,8}`
divides, `-1` auto-downscales images wider than 1600 px.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np

from event3dgs_tpu_torch.core.camera import Camera, make_camera, stack_cameras
from event3dgs_tpu_torch.core.sh import sh_to_rgb
from event3dgs_tpu_torch.core.transforms import focal2fov, fov2focal
from event3dgs_tpu_torch.data.colmap import qvec2rotmat, read_model
from event3dgs_tpu_torch.data.ply import (
    PointCloud,
    fetch_point_cloud,
    store_point_cloud,
)


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fov_x: float
    fov_y: float
    image_path: str
    image_name: str
    width: int
    height: int


class SceneInfo(NamedTuple):
    point_cloud: Optional[PointCloud]
    train_cameras: list
    test_cameras: list
    blurry_cameras: list
    event_cameras: list
    translate: np.ndarray
    radius: float  # nerf++ norm radius = cameras_extent
    ply_path: str


def nerfpp_norm(cam_infos: list) -> tuple[np.ndarray, float]:
    """Scene recentering + radius (`getNerfppNorm`, `dataset_readers.py:47-68`)."""
    centers = []
    for c in cam_infos:
        # camera center = -R·T with the reference's transposed-R storage
        centers.append(-c.R @ c.T)
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    radius = float(np.max(np.linalg.norm(centers - center, axis=1)) * 1.1)
    return -center, radius


def _colmap_cam_infos(cams, images, folder: str) -> list:
    infos = []
    for key in images:
        im = images[key]
        intr = cams[im.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {intr.model}; undistort first"
            )
        infos.append(
            CameraInfo(
                uid=intr.id,
                R=qvec2rotmat(im.qvec).T,  # stored transposed like the reference
                T=np.array(im.tvec),
                fov_x=float(focal2fov(focal_x, intr.width)),
                fov_y=float(focal2fov(focal_y, intr.height)),
                image_path=os.path.join(folder, os.path.basename(im.name)),
                image_name=os.path.splitext(os.path.basename(im.name))[0],
                width=intr.width,
                height=intr.height,
            )
        )
    infos.sort(key=lambda c: c.image_name)
    return infos


def read_colmap_scene(
    path: str,
    images_dir: str = "images",
    gray: bool = False,
    deblur: bool = False,
    event: bool = False,
) -> SceneInfo:
    """`readColmapSceneInfo` equivalent (`dataset_readers.py:134-227`)."""
    sparse = os.path.join(path, "sparse", "0")
    cams, images, points = read_model(sparse)

    train = _colmap_cam_infos(cams, images, os.path.join(path, images_dir))
    blurry = (
        _colmap_cam_infos(cams, images, os.path.join(path, "images_blurry"))
        if deblur
        else []
    )
    event_cams = (
        _colmap_cam_infos(cams, images, os.path.join(path, "images_event"))
        if event
        else []
    )
    # test set comes from the hardcoded `renders/` folder (the reference
    # disabled --eval holdout, `dataset_readers.py:173-179`)
    renders_dir = os.path.join(path, "renders")
    test = _colmap_cam_infos(cams, images, renders_dir) if os.path.isdir(
        renders_dir
    ) else []

    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path) and points is not None:
        store_point_cloud(ply_path, points[0], points[1])
    pcd = fetch_point_cloud(ply_path) if os.path.exists(ply_path) else None
    if pcd is not None and gray and not deblur:
        # gray mode initializes all point colors at 0.5 (`:197-198`)
        pcd = PointCloud(
            points=pcd.points,
            colors=np.full_like(pcd.colors, 0.5),
            normals=pcd.normals,
        )

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        blurry_cameras=blurry,
        event_cameras=event_cams,
        translate=translate,
        radius=radius,
        ply_path=ply_path,
    )


def read_blender_scene(path: str, white_background: bool = False) -> SceneInfo:
    """`readNerfSyntheticInfo` equivalent (`dataset_readers.py:228-309`)."""

    def read_transforms(fname, ext=".png"):
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fov_x = contents["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(contents["frames"]):
            image_path = os.path.join(path, frame["file_path"] + ext)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL → COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            from PIL import Image

            with Image.open(image_path) as im:
                w, h = im.size
            fov_y = focal2fov(fov2focal(fov_x, w), h)
            infos.append(
                CameraInfo(
                    uid=idx, R=R, T=T, fov_x=fov_x, fov_y=float(fov_y),
                    image_path=image_path,
                    image_name=os.path.splitext(os.path.basename(image_path))[0],
                    width=w, height=h,
                )
            )
        return infos

    train = read_transforms("transforms_train.json")
    test_path = os.path.join(path, "transforms_test.json")
    test = read_transforms("transforms_test.json") if os.path.exists(test_path) else []
    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        n = 100_000
        xyz = np.random.random((n, 3)) * 2.6 - 1.3
        shs = np.random.random((n, 3)) / 255.0
        store_point_cloud(ply_path, xyz, sh_to_rgb(shs) * 255)
    pcd = fetch_point_cloud(ply_path)

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        blurry_cameras=[],
        event_cameras=[],
        translate=translate,
        radius=radius,
        ply_path=ply_path,
    )


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    raise ValueError(f"could not recognize scene type at {path}")


def resolve_resolution(width: int, height: int, resolution: int) -> tuple[int, int]:
    """Resolution policy (`camera_utils.py:26-49`): positive values divide;
    -1 auto-downscales beyond 1600 px wide."""
    if resolution in (1, 2, 4, 8):
        scale = float(resolution)
    elif resolution == -1:
        scale = width / 1600.0 if width > 1600 else 1.0
    else:
        scale = width / resolution if resolution > 0 else 1.0
    return round(width / scale), round(height / scale)


def load_image(path: str, size: tuple[int, int], white_background=False) -> np.ndarray:
    """PIL load → float [H, W, 3] in [0,1]; alpha blended over the background
    (`dataset_readers.py:253-259`, `camera_utils.py:30-41`)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.resize(size)
        arr = np.asarray(im, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    if arr.shape[2] == 4:
        bg = 1.0 if white_background else 0.0
        arr = arr[:, :, :3] * arr[:, :, 3:4] + bg * (1.0 - arr[:, :, 3:4])
    return np.clip(arr[:, :, :3], 0.0, 1.0)


def build_camera_batch(infos: list, resolution: int = -1,
                       device=None) -> Camera:
    """CameraInfo list → batched Camera on ``device`` at the policy
    resolution."""
    w, h = resolve_resolution(infos[0].width, infos[0].height, resolution)
    cams = [
        make_camera(ci.R, ci.T, ci.fov_x, ci.fov_y, w, h, device=device)
        for ci in infos
    ]
    return stack_cameras(cams)


def load_images_array(
    infos: list, resolution: int = -1, white_background=False
) -> np.ndarray:
    """Load + resize a camera set's images as one [V, H, W, 3] array.

    Decoding is threaded (PIL releases the GIL in decode/resize): a few
    hundred PNGs load in seconds instead of the minute-plus that a serial
    loop costs."""
    from concurrent.futures import ThreadPoolExecutor

    w, h = resolve_resolution(infos[0].width, infos[0].height, resolution)
    with ThreadPoolExecutor(max_workers=16) as pool:
        imgs = list(pool.map(
            lambda ci: load_image(ci.image_path, (w, h), white_background),
            infos,
        ))
    return np.stack(imgs)


def camera_to_json(idx: int, ci: CameraInfo) -> dict:
    """cameras.json entry (reference `camera_utils.py:62-82`)."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = ci.R.T
    rt[:3, 3] = ci.T
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    return {
        "id": idx,
        "img_name": ci.image_name,
        "width": ci.width,
        "height": ci.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": fov2focal(ci.fov_y, ci.height),
        "fx": fov2focal(ci.fov_x, ci.width),
    }
