"""The port's remaining public names against the JAX package's, on the CPU:
the experimental event losses and ``rgb_to_qe_scale`` (at the JAX suite's
1e-6, ``tests/test_parity_extras.py``'s cases included), the covariance
helpers, ``CameraBatch``, ``replicated``, ``claim_accelerator`` and
``__version__``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event3dgs_tpu
import event3dgs_tpu_torch
from event3dgs_tpu.core import camera as jcamera
from event3dgs_tpu.core import transforms as jtransforms
from event3dgs_tpu.losses import basic as jbasic
from event3dgs_tpu.losses import event as jevent
from event3dgs_tpu_torch.core import camera as tcamera
from event3dgs_tpu_torch.core import make_camera
from event3dgs_tpu_torch.core import transforms as ttransforms
from event3dgs_tpu_torch.losses import basic as tbasic
from event3dgs_tpu_torch.losses import event as tevent
from event3dgs_tpu_torch.ops.projection import DILATION, project_gaussians

torch.set_num_threads(1)


def both(name, *arrays, module=(jevent, tevent), **kw):
    """``name`` of the JAX module and of the port's on the same arrays."""
    j = getattr(module[0], name)(*(jnp.asarray(a) for a in arrays), **kw)
    t = getattr(module[1], name)(*(torch.tensor(a) for a in arrays), **kw)
    return np.asarray(j), t.numpy()


def frames(seed, h=20, w=25, c=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, scale, (h, w, c))).astype(np.float32)
            for _ in range(2)]


def event_counts(seed, h=20, w=25, c=3):
    """Event-count-like frames: mostly 0, some ±1..3."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.integers(-3, 4, (h, w, c)).astype(np.float32)
        x[rng.uniform(size=(h, w, c)) < 0.6] = 0.0
        out.append(x)
    return out


@pytest.mark.parametrize("thresh", [0.5, 0.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_thresholded_event_l1_matches(seed, thresh):
    j, t = both("thresholded_event_l1", *event_counts(seed), thresh=thresh)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("channels", [3, 1])
def test_dice_loss_matches(channels):
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(0, 1, (16, 18, channels)).astype(np.float32)
            for _ in range(2))
    j, t = both("dice_loss", a, b)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["random", "identical", "rgb"])
def test_cross_entropy_event_loss_matches(case):
    d, g = frames(1, c=3 if case == "rgb" else 1)
    if case == "identical":
        g = d
    j, t = both("cross_entropy_event_loss", d, g)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    assert np.isfinite(t) and t > 0


def test_quadratic_tolerance_loss_matches_and_keeps_its_band():
    d = np.full((8, 8, 1), 0.5, np.float32)
    for g, want in ((d + 0.1, 0.0), (d + 0.3, 1e4)):
        j, t = both("quadratic_tolerance_loss", d, g, tolerance=0.2)
        np.testing.assert_allclose(t, j, rtol=1e-6)
        np.testing.assert_allclose(t, want, rtol=1e-3)
    a, b = frames(3, scale=0.3)
    j, t = both("quadratic_tolerance_loss", a, b)
    np.testing.assert_allclose(t, j, rtol=1e-6)


def _point_frames(case):
    g = np.zeros((16, 16, 1), np.float32)
    out = np.zeros((16, 16, 1), np.float32)
    g[3, 4], g[10, 12] = 1.0, -1.0
    if case == "perfect":
        return g, g
    if case == "distance":  # 3 px and 4 px away: 7
        out[3, 7], out[14, 12] = 1.0, -1.0
        return out, g
    if case == "fallback":  # no event: plain L1
        return np.full((8, 8, 1), 0.2, np.float32), np.full((8, 8, 1), 0.4,
                                                             np.float32)
    rng = np.random.default_rng(4)  # many points, capped at max_points
    return tuple(np.sign(x) * (np.abs(x) > 1.0) for x in
                 rng.normal(0, 1, (2, 24, 24, 1)).astype(np.float32))


@pytest.mark.parametrize("case,want", [("perfect", 0.0), ("distance", 7.0),
                                       ("fallback", 0.2), ("capped", None)])
def test_pointcloud_nn_loss_matches(case, want):
    out, g = _point_frames(case)
    kw = {"max_points": 20} if case == "capped" else {}
    j, t = both("pointcloud_nn_loss", out, g, **kw)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    if want is not None:
        np.testing.assert_allclose(t, want, atol=1e-4)


def test_chamfer_event_loss_is_zero_for_identical_frames():
    rng = np.random.default_rng(3)
    d = (np.sign(rng.normal(size=(20, 20, 1)))
         * rng.uniform(0.9, 2.0, (20, 20, 1))).astype(np.float32)
    j, t = both("chamfer_event_loss", d, d)
    assert t == 0.0 and j == 0.0


@pytest.mark.parametrize("case", ["mismatch", "random", "band", "capped"])
def test_chamfer_event_loss_matches(case):
    if case == "mismatch":
        d = np.zeros((20, 20, 1), np.float32)
        g = np.zeros((20, 20, 1), np.float32)
        g[::2, ::2] = 5.0
        d[1::2, 1::2] = 1.0
    else:
        d, g = frames(5, h=23, w=27, scale=1.5)
    kw = {"band": 0.5} if case == "band" else {}
    kw.update({"max_points": 7} if case == "capped" else {})
    j, t = both("chamfer_event_loss", d, g, **kw)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    if case == "mismatch":
        assert np.isfinite(t) and t > 0


@pytest.mark.parametrize("channels", [3, 1])
def test_filtered_event_l1_matches(channels):
    a, b = frames(6, c=channels)
    j, t = both("filtered_event_l1", a, b)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_soft_threshold_and_normalize_image_match():
    (x, _) = frames(7, scale=0.5)
    for kw in ({}, {"contrast": 0.1, "width": 4.0}):
        j, t = both("soft_threshold", x, **kw)
        np.testing.assert_allclose(t, j, atol=1e-6)
    j, t = both("normalize_image", x)
    np.testing.assert_allclose(t, j, atol=1e-6)
    assert t.min() == 0.0 and t.max() == 1.0


@pytest.mark.parametrize("channels", [3, 1])
def test_rgb_to_qe_scale_matches(channels):
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (2, 9, 11, channels)).astype(np.float32)
    j, t = both("rgb_to_qe_scale", img, module=(jbasic, tbasic))
    assert t.shape == j.shape == (2, 9, 11, 1)
    np.testing.assert_allclose(t, j, atol=1e-6)


def _scales_rotations(seed, n=8):
    rng = np.random.default_rng(seed)
    return ((np.abs(rng.normal(size=(n, 3))) + 0.1).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32))


@pytest.mark.parametrize("modifier", [1.0, 2.0])
def test_build_covariance_matches(modifier):
    s, q = _scales_rotations(0)
    j, t = both("build_covariance", s, q, module=(jtransforms, ttransforms),
                scaling_modifier=modifier)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    for i in range(len(s)):  # the eigenvalues are the squared scales
        np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(t[i])),
                                   np.sort((s[i] * modifier) ** 2), rtol=1e-4)


def test_build_covariance_is_the_projection_covariance():
    """On the optical axis of an identity camera the projection's 2D
    covariance is diag(fx/z, fy/z)·Σ_xy·diag(fx/z, fy/z) plus the dilation:
    its conic is the inverse of that, from the port's build_covariance."""
    s, q = _scales_rotations(1)
    z = np.linspace(2.0, 6.0, len(s)).astype(np.float32)
    means = np.c_[np.zeros((len(s), 2)), z].astype(np.float32)
    w, h = 64, 48
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, w, h, device="cpu")
    proj = project_gaussians(torch.tensor(means), torch.tensor(s),
                             torch.tensor(q), cam)
    cov = ttransforms.build_covariance(torch.tensor(s), torch.tensor(q)).double()
    fx = w / (2.0 * float(cam.tan_fovx))
    fy = h / (2.0 * float(cam.tan_fovy))
    zt = torch.tensor(z, dtype=torch.float64)
    a = (fx / zt) ** 2 * cov[:, 0, 0] + DILATION
    b = fx * fy / zt ** 2 * cov[:, 0, 1]
    c = (fy / zt) ** 2 * cov[:, 1, 1] + DILATION
    det = a * c - b * b
    want = torch.stack([c / det, -b / det, a / det], dim=-1)
    np.testing.assert_allclose(proj.conic.double().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-7)


def test_symm6_round_trip_matches():
    s, q = _scales_rotations(2)
    cov = jtransforms.build_covariance(jnp.asarray(s), jnp.asarray(q))
    j, t = both("covariance_to_symm6", np.asarray(cov),
                module=(jtransforms, ttransforms))
    np.testing.assert_array_equal(t, j)
    back_j, back_t = both("symm6_to_covariance", j,
                          module=(jtransforms, ttransforms))
    np.testing.assert_array_equal(back_t, back_j)
    np.testing.assert_array_equal(back_t, np.asarray(cov))


def test_camera_batch_replicated_and_version():
    from event3dgs_tpu_torch.parallel.mesh import Mesh, data_sharding, replicated

    assert tcamera.CameraBatch is tcamera.Camera
    assert jcamera.CameraBatch is jcamera.Camera
    assert event3dgs_tpu_torch.__version__ == event3dgs_tpu.__version__ == "0.1.0"
    mesh = Mesh(device_mesh=None, data_group=None, gauss_group=None, data=2,
                gauss=1, data_rank=1, gauss_rank=0, device=torch.device("cpu"))
    rows = torch.arange(6)
    assert torch.equal(rows[replicated(mesh)], rows)
    assert torch.equal(rows[data_sharding(mesh, 6)], torch.tensor([3, 4, 5]))


def test_claim_accelerator_is_a_no_op_on_the_cpu_and_raises_without_a_card():
    from event3dgs_tpu_torch.cli.common import claim_accelerator

    claim_accelerator(torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            claim_accelerator(torch.device("cuda"))
