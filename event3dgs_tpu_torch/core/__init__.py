"""Pure math: camera transforms, cameras, spherical harmonics, schedules."""

from event3dgs_tpu_torch.core.camera import Camera, make_camera, stack_cameras
from event3dgs_tpu_torch.core.sh import SH_C0, eval_sh, rgb_to_sh, sh_to_rgb
from event3dgs_tpu_torch.core.schedules import exponential_lr
from event3dgs_tpu_torch.core.transforms import (
    focal2fov,
    fov2focal,
    inverse_sigmoid,
    perspective_projection,
    quat_to_rotmat,
    world_to_view,
)

__all__ = [
    "Camera",
    "make_camera",
    "stack_cameras",
    "SH_C0",
    "eval_sh",
    "rgb_to_sh",
    "sh_to_rgb",
    "exponential_lr",
    "focal2fov",
    "fov2focal",
    "inverse_sigmoid",
    "perspective_projection",
    "quat_to_rotmat",
    "world_to_view",
]
