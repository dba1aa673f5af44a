"""Camera container (counterpart of ``event3dgs_tpu/core/camera.py``).

A :class:`Camera` is a plain dataclass of float32 tensors on one device,
with the image size as Python ints.  Array fields follow the reference's
row-vector convention: ``p_hom @ world_view`` maps world → camera and
``p_hom @ full_proj`` maps world → clip (reference `scene/cameras.py:54-57`).
A batch of cameras carries a leading dimension on every tensor field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from event3dgs_tpu_torch.core.transforms import perspective_projection, world_to_view
from event3dgs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    world_view: torch.Tensor  # [..., 4, 4]
    full_proj: torch.Tensor  # [..., 4, 4]
    camera_center: torch.Tensor  # [..., 3]
    tan_fovx: torch.Tensor  # [...]
    tan_fovy: torch.Tensor  # [...]
    width: int = 0
    height: int = 0
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def batch_shape(self):
        return tuple(self.camera_center.shape[:-1])

    def __getitem__(self, idx) -> "Camera":
        """Index or slice a camera batch (tensor fields only)."""
        return dataclasses.replace(
            self,
            world_view=self.world_view[idx],
            full_proj=self.full_proj[idx],
            camera_center=self.camera_center[idx],
            tan_fovx=self.tan_fovx[idx],
            tan_fovy=self.tan_fovy[idx],
        )


# a Camera whose tensor fields carry a leading batch dimension
CameraBatch = Camera


def make_camera(
    R,
    t,
    fov_x: float,
    fov_y: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    translate=None,
    scale: float = 1.0,
    device=None,
) -> Camera:
    """Build a camera from COLMAP-style extrinsics and FoVs.

    Mirrors the reference camera precompute (`scene/cameras.py:48-57`):
    ``full_proj`` is the row-vector product W2C·P and ``camera_center`` is
    the last row of the inverted view matrix.  Everything is computed in
    float64 on the host, then cast to float32 on ``device``.
    """
    dev = resolve_device(device)
    wv = world_to_view(R, t, translate=translate, scale=scale)
    proj = perspective_projection(znear, zfar, fov_x, fov_y)
    full = wv @ proj
    center = torch.linalg.inv(wv)[..., 3, :3]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    return Camera(
        world_view=f32(wv),
        full_proj=f32(full),
        camera_center=f32(center),
        tan_fovx=f32(np.tan(fov_x / 2.0)),
        tan_fovy=f32(np.tan(fov_y / 2.0)),
        width=int(width),
        height=int(height),
        znear=float(znear),
        zfar=float(zfar),
    )


def stack_cameras(cams) -> Camera:
    """Stack same-resolution cameras into one batched :class:`Camera`."""
    if not cams:
        raise ValueError("cannot stack an empty camera list")
    w, h = cams[0].width, cams[0].height
    for c in cams:
        if (c.width, c.height) != (w, h):
            raise ValueError("all cameras in a batch must share resolution")
    return dataclasses.replace(
        cams[0],
        world_view=torch.stack([c.world_view for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        camera_center=torch.stack([c.camera_center for c in cams]),
        tan_fovx=torch.stack([c.tan_fovx for c in cams]),
        tan_fovy=torch.stack([c.tan_fovy for c in cams]),
    )
