"""The port's losses and color transforms against the JAX package's, on the
CPU: every ported function at 1e-6, SSIM at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.losses import basic as jbasic
from event3dgs_tpu.losses import event as jevent
from event3dgs_tpu.losses import modes as jmodes
from event3dgs_tpu_torch.losses import basic as tbasic
from event3dgs_tpu_torch.losses import event as tevent
from event3dgs_tpu_torch.losses import modes as tmodes

torch.set_num_threads(1)


def images(seed, n=6, h=24, w=32, c=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 1.0, (h, w, c)).astype(np.float32) for _ in range(n)]


def both(fn_j, fn_t, *arrays, **kw):
    j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    t = fn_t(*(torch.tensor(a) for a in arrays), **kw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("name", ["rgb_to_grayscale", "rgb_to_luv_l"])
@pytest.mark.parametrize("channels", [3, 1])
def test_color_transforms_match(name, channels):
    (img,) = images(0, n=1, c=channels)
    j, t = both(getattr(jbasic, name), getattr(tbasic, name), img)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-6)


@pytest.mark.parametrize("name", ["l1_loss", "l1_loss_gray", "psnr"])
def test_pixel_losses_match(name):
    a, b = images(1, n=2)
    j, t = both(getattr(jbasic, name), getattr(tbasic, name), a, b)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["ssim", "ssim_gray"])
@pytest.mark.parametrize("seed", [2, 3])
def test_ssim_matches(name, seed):
    a, b = images(seed, n=2, h=40, w=56)
    b = 0.7 * a + 0.3 * b  # partly correlated, SSIM well inside (0, 1)
    j, t = both(getattr(jbasic, name), getattr(tbasic, name), a, b)
    np.testing.assert_allclose(t, j, atol=1e-5)
    j1, t1 = both(getattr(jbasic, name), getattr(tbasic, name), a, a)
    np.testing.assert_allclose(t1, j1, atol=1e-5)


@pytest.mark.parametrize("param", ["identity", "softplus"])
def test_contrast_parameterizations_match(param):
    raw = tevent.raw_contrast_init(0.17, param)
    assert raw == pytest.approx(jevent.raw_contrast_init(0.17, param))
    for x in (raw, -3.0, 0.5):
        j = jevent.effective_contrast(jnp.asarray(x, jnp.float32), param)
        t = tevent.effective_contrast(torch.tensor(x, dtype=torch.float32), param)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    with pytest.raises(ValueError):
        tevent.effective_contrast(torch.tensor(1.0), "cubic")


def test_event_log_diff_matches():
    a, b = images(4, n=2)
    j = jevent.event_log_diff(jnp.asarray(a), jnp.asarray(b), 0.21)
    t = tevent.event_log_diff(torch.tensor(a), torch.tensor(b), 0.21)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("identical_gt", [False, True])
def test_event_mixture_and_mode_losses_match(identical_gt):
    now, nxt, main, gnow, gnext, gmain = images(5)
    if identical_gt:
        gnext = gnow  # no events: coverage 0, only the intensity term
    arrays = (now, nxt, main, gnow, gnext, gmain)
    kw = dict(gt_contrast=0.17, event_weight=0.9)
    jl, jaux = jmodes.event_total_loss(*(jnp.asarray(a) for a in arrays),
                                       jnp.asarray(0.23, jnp.float32), **kw)
    tl, taux = tmodes.event_total_loss(*(torch.tensor(a) for a in arrays),
                                       torch.tensor(0.23), **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    for k in ("event_l1", "intensity_l1", "coverage"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-6, err_msg=k)
    jm, _ = jevent.event_mixture_loss(*(jnp.asarray(a) for a in arrays),
                                      jnp.asarray(0.23, jnp.float32), **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jm), rtol=1e-6)


@pytest.mark.parametrize("name", ["rgb_total_loss", "gray_total_loss"])
@pytest.mark.parametrize("lam", [0.0, 0.2])
def test_frame_mode_losses_match(name, lam):
    a, b = images(6, n=2)
    jl, jaux = getattr(jmodes, name)(jnp.asarray(a), jnp.asarray(b), lam)
    tl, taux = getattr(tmodes, name)(torch.tensor(a), torch.tensor(b), lam)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(taux["l1"].numpy(), np.asarray(jaux["l1"]),
                               atol=1e-6)


def test_deblur_mix_matches():
    a, b = images(7, n=2)
    jl, _ = jmodes.deblur_mix(jnp.asarray(0.3), jnp.asarray(a), jnp.asarray(b), 0.4)
    tl, aux = tmodes.deblur_mix(torch.tensor(0.3), torch.tensor(a),
                                torch.tensor(b), 0.4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    assert set(aux) == {"blur_l1"}


def test_ssim_gradient_flows():
    a, b = images(8, n=2)
    ta = torch.tensor(a, requires_grad=True)
    (g,) = torch.autograd.grad(tbasic.ssim(ta, torch.tensor(b)), [ta])
    assert torch.isfinite(g).all() and g.abs().sum() > 0
