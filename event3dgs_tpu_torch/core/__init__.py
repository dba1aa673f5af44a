"""Pure math: camera transforms, cameras, spherical harmonics, schedules."""

from event3dgs_tpu_torch.core.camera import (
    Camera,
    CameraBatch,
    make_camera,
    stack_cameras,
)
from event3dgs_tpu_torch.core.sh import SH_C0, eval_sh, rgb_to_sh, sh_to_rgb
from event3dgs_tpu_torch.core.schedules import exponential_lr
from event3dgs_tpu_torch.core.transforms import (
    build_covariance,
    covariance_to_symm6,
    focal2fov,
    fov2focal,
    inverse_sigmoid,
    perspective_projection,
    quat_to_rotmat,
    symm6_to_covariance,
    world_to_view,
)

__all__ = [
    "Camera",
    "CameraBatch",
    "make_camera",
    "stack_cameras",
    "SH_C0",
    "eval_sh",
    "rgb_to_sh",
    "sh_to_rgb",
    "exponential_lr",
    "build_covariance",
    "covariance_to_symm6",
    "focal2fov",
    "fov2focal",
    "inverse_sigmoid",
    "perspective_projection",
    "quat_to_rotmat",
    "symm6_to_covariance",
    "world_to_view",
]
