"""Scenes, camera paths and Adam's state of the benchmark's configurations,
made from a seed on the device.

Frozen, generalised copies of the recipes of
``event3dgs_tpu_torch/tools/scale.py`` at commit 3dea7a3:
``maxcap_scene``'s small-splat statistics (uniform means in a box, log-scales
uniform in a band times a per-axis jitter, normal quaternions, opacities
uniform in a band), ``step_cameras`` (identity rotation, translation i·step)
and ``orbit_cameras`` (a circle at height 0.6 looking at the origin), and the
camera matrices of ``core/transforms.py`` (``world_to_view``,
``perspective_projection``).  Nothing here imports the port: the harness
hands the same tensors to the program and to the reference.

A configuration's file says which recipe and with which numbers
(``cloud``, ``trajectory``); the training targets are the world's own
renders (``targets.py``).  Every draw comes from a
``torch.Generator`` on the device seeded by :func:`sub_seed`, in a few large
calls, so the same seed gives the same slots, poses and moments in any
process on the same kind of device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814  # the degree-0 SH constant (core/sh.py)
ZNEAR, ZFAR = 0.01, 100.0  # core/camera.make_camera's defaults


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of stream ``stream`` of ``seed``: the scene and
    Adam's state draw from separate streams."""
    return (int(seed) * 1_000_003 + 7919 * int(stream)) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


# --- cameras ---------------------------------------------------------------


class Views(NamedTuple):
    """A batch of cameras as the harness hands them to both sides: [V, ...]
    float32 tensors and the image size."""

    world_view: torch.Tensor  # [V, 4, 4]: p_hom @ world_view maps world → view
    full_proj: torch.Tensor  # [V, 4, 4]: p_hom @ full_proj maps world → clip
    center: torch.Tensor  # [V, 3]
    tan_fovx: torch.Tensor  # [V]
    tan_fovy: torch.Tensor  # [V]
    width: int
    height: int

    def __len__(self) -> int:
        return self.center.shape[0]


def world_to_view(R, t) -> np.ndarray:
    """The transposed world-to-camera matrix, float64 (``R`` as the scene
    readers store it, ``t`` the COLMAP translation)."""
    w2c = np.zeros((4, 4))
    w2c[:3, :3] = np.asarray(R, np.float64).T
    w2c[:3, 3] = np.asarray(t, np.float64)
    w2c[3, 3] = 1.0
    return w2c.T


def perspective(fov_x: float, fov_y: float) -> np.ndarray:
    """The transposed perspective projection with z in [0, 1], float64."""
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / math.tan(fov_x / 2.0)
    P[1, 1] = 1.0 / math.tan(fov_y / 2.0)
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    P[3, 2] = 1.0
    return P.T


def poses(trajectory: dict) -> list:
    """[(R, t)] of a configuration's ``trajectory``: ``step`` (identity
    rotation, translation i·``step``) or ``orbit`` (radius ``radius`` at
    height ``height``, looking at the origin, views evenly round)."""
    n = int(trajectory["views"])
    if trajectory["kind"] == "step":
        step = np.asarray(trajectory["step"], np.float64)
        return [(np.eye(3), step * i) for i in range(n)]
    if trajectory["kind"] == "orbit":
        out = []
        for i in range(n):
            th = 2 * np.pi * i / n
            pos = np.array([trajectory["radius"] * np.sin(th),
                            trajectory["height"],
                            -trajectory["radius"] * np.cos(th)])
            fwd = -pos / np.linalg.norm(pos)
            right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
            right /= np.linalg.norm(right)
            r = np.stack([right, np.cross(fwd, right), fwd], axis=1)
            out.append((r, -r.T @ pos))
        return out
    raise ValueError(f"unknown trajectory kind {trajectory['kind']!r}")


def views(cfg: dict, device) -> Views:
    """The configuration's cameras on ``device``."""
    tr = cfg["trajectory"]
    proj = perspective(tr["fov_x"], tr["fov_y"])
    wv, full, center = [], [], []
    for R, t in poses(tr):
        w = world_to_view(R, t)
        wv.append(w)
        full.append(w @ proj)
        center.append(np.linalg.inv(w)[3, :3])
    n = len(wv)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=device)
    return Views(f32(wv), f32(full), f32(center),
                 f32(np.full(n, math.tan(tr["fov_x"] / 2.0))),
                 f32(np.full(n, math.tan(tr["fov_y"] / 2.0))),
                 int(cfg["width"]), int(cfg["height"]))


def nerfpp_extent(v: Views) -> float:
    """1.1 × the largest camera distance from the cameras' centroid (the
    reference's ``getNerfppNorm``), the training's spatial learning-rate
    scale."""
    c = v.center.double().cpu().numpy()
    return float(np.max(np.linalg.norm(c - c.mean(0), axis=1)) * 1.1)


# --- the Gaussians ---------------------------------------------------------


def _component(spec: dict, n: int, g: torch.Generator, device):
    """Means and log-scales of ``n`` splats of one component of a cloud."""
    u = torch.rand((n, 7), generator=g, device=device)
    if spec["shape"] == "box":
        lo = torch.tensor(spec["low"], device=device)
        hi = torch.tensor(spec["high"], device=device)
        xyz = lo + (hi - lo) * u[:, :3]
    elif spec["shape"] == "normal":
        xyz = (torch.randn((n, 3), generator=g, device=device)
               * torch.tensor(spec["sigma"], device=device))
    elif spec["shape"] == "shell":
        d = torch.randn((n, 3), generator=g, device=device)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True).clamp_min(1e-12)
        r0, r1 = spec["radius"]
        xyz = d * (r0 + (r1 - r0) * u[:, :1])
    else:
        raise ValueError(f"unknown cloud shape {spec['shape']!r}")
    a, b = (math.log(s) for s in spec["scale"])
    j0, j1 = spec["jitter"]
    log_scale = (a + (b - a) * u[:, 3:4]) + torch.log(j0 + (j1 - j0) * u[:, 4:7])
    return xyz, log_scale


def cloud(cfg: dict, seed: int, device) -> dict:
    """The configuration's Gaussians, every slot alive, as raw parameters
    (the port's layout): xyz [N, 3], features_dc [N, 1, 3], features_rest
    [N, K-1, 3], scaling [N, 3] (log), rotation [N, 4], opacity [N, 1]
    (logit).  Colours uniform in [0, 1] as DC features, the higher SH
    coefficients normal with ``sh_rest_std``."""
    spec = cfg["cloud"]
    n = int(cfg["slots"])
    k = (int(cfg["sh_degree"]) + 1) ** 2
    g = generator(seed, 1, device)
    counts, left = [], n
    for i, comp in enumerate(spec["components"]):
        c = left if i == len(spec["components"]) - 1 else int(n * comp["share"])
        counts.append(c)
        left -= c
    parts = [_component(comp, c, g, device)
             for comp, c in zip(spec["components"], counts)]
    xyz = torch.cat([p[0] for p in parts])
    log_scale = torch.cat([p[1] for p in parts])
    u = torch.rand((n, 4), generator=g, device=device)
    o0, o1 = spec["opacity"]
    opac = o0 + (o1 - o0) * u[:, 3:4]
    return {
        "xyz": xyz.contiguous(),
        "features_dc": ((u[:, None, :3] - 0.5) / SH_C0).contiguous(),
        "features_rest": (torch.randn((n, k - 1, 3), generator=g,
                                      device=device)
                          * float(spec["sh_rest_std"])),
        "scaling": log_scale.contiguous(),
        "rotation": torch.randn((n, 4), generator=g, device=device),
        "opacity": torch.log(opac / (1.0 - opac)),
    }


# --- Adam's state ------------------------------------------------------


def adam_moments(cfg: dict, seed: int, shapes: dict, device) -> dict:
    """Adam's moments of a run that is ``start_iteration`` steps in, past
    its densify window: {leaf: (mu, nu)} of the leaves' shapes.  A
    converged scene's gradients have no running mean left, so mu is 0;
    nu is the square of a normal draw plus a floor, scaled per leaf by the
    configuration's ``adam_rms`` (the gradient's size at the world)."""
    rms = cfg["adam_rms"]
    g = generator(seed, 4, device)
    out = {}
    for name, shape in shapes.items():
        s = float(rms[name])
        nu = (torch.randn(shape, generator=g, device=device) * s) ** 2 + (0.5 * s) ** 2
        out[name] = (torch.zeros(shape, device=device), nu)
    return out
