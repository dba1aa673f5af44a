"""The rgb and gray modes' loss, (1-λ)·L1 + λ·(1-SSIM), on the CPU: the
plain versions of the SSIM kernels (``losses/modes.photometric_loss_plain``
and ``photometric_loss_backward_plain``, the blur summed tap by tap as the
kernels sum it) against the JAX package's composition
(``event3dgs_tpu/ops/render.py:122``) followed by its ``rgb_total_loss`` /
``gray_total_loss`` and ``jax.vjp``; the written-out backward against
autograd through the loss as the port computed it before (``F.conv2d``
blurs); the analytic derivative maps against autograd of the map; GT
frames of a stack against images picked first; the train step that hands
the loss its render's partials and, graphed, its GT frame against the step
that composed and picked first; the wrappers' dispatch and checks; the
kernels' bound.  The kernels themselves run on the card only
(``tests/test_torch_kernels.py``).

The inputs come from a numpy seed at 24×40 and 33×47 (ragged edges of the
kernels' tiles) and 5×7 (smaller than the window's 5-pixel halo on each
side): rgb in [0.02, 0.9], log T in [-4, 0] with some exact zeros
(T = 1), a seeded background, GT images in [0.05, 1] of 3 channels (gray
mode: also 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.losses import modes as jmodes
from event3dgs_tpu_torch.losses import basic as tbasic
from event3dgs_tpu_torch.losses import event as tevent
from event3dgs_tpu_torch.losses import modes as tmodes
from event3dgs_tpu_torch.ops.render import composed
from event3dgs_tpu_torch.tools.kernel_timing import photometric_bound
from test_torch_kernels import assert_bits_equal, step_state

torch.set_num_threads(1)

SIZES = [(24, 40), (33, 47), (5, 7)]
SIZE_IDS = ["24x40", "33x47", "5x7"]
# (mode, GT channels)
CASES = [("rgb", 3), ("gray", 3), ("gray", 1)]
CASE_IDS = ["rgb", "gray-gt3", "gray-gt1"]
LAMBDAS = [0.2, 0.0]
FORMS = ["partials", "image"]
FRAMES = 4  # frames of a GT stack
# the written-out backward against autograd through the F.conv2d loss,
# max-normalised: the blurs' sums run in other orders (measured at most
# 8.8e-7 over these cases)
CONV2D_ATOL = 2e-6


def arrays(seed, h, w, gt_channels):
    """Numpy float32 inputs: rgb [h, w, 3], log T [h, w], the GT
    [h, w, gt_channels], the background [3]."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=0.0, hi=1.0: rng.uniform(
        lo, hi, shape).astype(np.float32)
    logt = f(h, w, lo=-4.0, hi=0.0)
    logt[rng.random((h, w)) < 0.05] = 0.0
    return f(h, w, 3, lo=0.02, hi=0.9), logt, f(h, w, gt_channels, lo=0.05), \
        f(3)


def total_loss(mode):
    return tmodes.rgb_total_loss if mode == "rgb" else tmodes.gray_total_loss


def render_operand(rgb, logt, bg, form, requires_grad=True):
    """The render as the loss takes it, and its leaves: ``Partials`` of
    rgb and log T, or the composed image."""
    if form == "partials":
        r = tevent.Partials(torch.tensor(rgb).requires_grad_(requires_grad),
                            torch.tensor(logt).requires_grad_(requires_grad))
        return r, list(r)
    img = composed(torch.tensor(rgb), torch.tensor(logt), torch.tensor(bg))
    img = img.detach().requires_grad_(requires_grad)
    return img, [img]


def compared(x, y, gray):
    """The numpy images the loss compares (their luma in gray mode)."""
    if not gray:
        return x, y
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    luma = lambda a: a if a.shape[-1] == 1 else (a * w).sum(-1, keepdims=True)
    return luma(x), luma(y)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lam", LAMBDAS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_plain_loss_matches_jax_composition_and_vjp(size, case, lam, form):
    """The port's loss on the CPU (the plain forward and the written-out
    backward in ``PhotometricLoss``) against the JAX package's composition
    and ``rgb_total_loss`` / ``gray_total_loss``: the loss and l1 within
    atol 1e-6; the gradients in the render's rgb and log T (or its image)
    against ``jax.vjp`` within a max-normalised 1e-5, away from the L1's
    ties (trap (h); the seeded data has none)."""
    mode, gt_ch = case
    rgb, logt, gt, bg = arrays(31, *size, gt_ch)
    render, leaves = render_operand(rgb, logt, bg, form)
    loss, aux = total_loss(mode)(render, torch.tensor(gt), lam,
                                 background=torch.tensor(bg))
    got = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    jfn = getattr(jmodes, f"{mode}_total_loss")
    background = jnp.asarray(bg)

    def f(*args):
        image = (args[0] + jnp.exp(args[1])[:, :, None]
                 * background[None, None, :]) if form == "partials" \
            else args[0]
        return jfn(image, jnp.asarray(gt), lam)

    args = ([jnp.asarray(rgb), jnp.asarray(logt)] if form == "partials"
            else [jnp.asarray(leaves[0].detach().numpy())])
    (jl, jaux), vjp = jax.vjp(f, *args)
    want = [np.asarray(g) for g in vjp(
        (jnp.ones((), jnp.float32), {"l1": jnp.zeros((), jnp.float32)}))]
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=1e-6)
    np.testing.assert_allclose(float(aux["l1"]), float(jaux["l1"]), atol=1e-6)
    x = (rgb + np.exp(logt)[:, :, None] * bg).astype(np.float32)
    cx, cy = compared(x, gt, mode == "gray")
    assert np.abs(cx - cy).min() > 1e-6  # no L1 tie
    for name, t, j in zip(("rgb or image", "log T"), got, want):
        err = np.abs(t - j).max() / np.abs(j).max()
        assert err <= 1e-5, f"{name}: {err:.3g} of the max"


def conv2d_loss(x, y, lam, gray):
    """The loss as the port computed it before its kernels: the L1 and
    ``basic.ssim`` (``F.conv2d`` blurs) under autograd."""
    if gray:
        l1, ssim = tbasic.l1_loss_gray(x, y), tbasic.ssim_gray
    else:
        l1, ssim = tbasic.l1_loss(x, y), tbasic.ssim
    loss = (1.0 - lam) * l1
    if lam > 0.0:
        loss = loss + lam * (1.0 - ssim(x, y))
    return loss


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lam", LAMBDAS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_backward_plain_matches_autograd_through_conv2d(size, case, lam,
                                                        form):
    """``photometric_loss_backward_plain`` (from the plain forward's maps)
    against autograd through the loss with ``F.conv2d`` blurs (and
    ``ops/render.composed`` for partials), at the gradient 1 and a seeded
    one: within a max-normalised ``CONV2D_ATOL`` (at λ = 0, without blurs,
    1e-6: autograd's mean divides by N where the kernels multiply by
    1/N); the loss within atol 1e-6."""
    mode, gt_ch = case
    gray = mode == "gray"
    rgb, logt, gt, bg = arrays(32, *size, gt_ch)
    background, y = torch.tensor(bg), torch.tensor(gt)
    render, leaves = render_operand(rgb, logt, bg, form)
    image = composed(*render, background) if form == "partials" else render
    want_loss = conv2d_loss(image, y, lam, gray)
    detached = (tevent.Partials(*(t.detach() for t in render))
                if form == "partials" else render.detach())
    loss, l1, maps = tmodes.photometric_loss_plain(detached, y, lam, gray,
                                                   background)
    assert (maps is None) == (lam == 0.0)
    np.testing.assert_allclose(float(loss), float(want_loss.detach()),
                               atol=1e-6)
    for grad in (torch.ones(()), torch.tensor(-0.37)):
        want = torch.autograd.grad(want_loss, leaves, grad, retain_graph=True)
        got = tmodes.photometric_loss_backward_plain(
            grad, detached, y, maps, lam, gray, background)
        got = list(got) if form == "partials" else [got]
        atol = CONV2D_ATOL if lam > 0.0 else 1e-6
        for a, b in zip(got, want):
            assert a.shape == b.shape
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= atol, f"{err:.3g} of the max"


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_derivative_maps_equal_autograd_of_the_map(size):
    """``basic.ssim_terms``' analytic derivatives of the SSIM map by the
    blurred mean of x, of x·x and of x·y against autograd of the map's
    formula in those moments (float64), within 1e-6 of each map's max."""
    rng = np.random.default_rng(33)
    x, y = (torch.tensor(rng.uniform(0, 1, size + (3,)), dtype=torch.float64)
            for _ in range(2))
    blur = tbasic.tap_blur
    mx, exx, exy = (t.requires_grad_(True)
                    for t in (blur(x), blur(x * x), blur(x * y)))
    my, eyy = blur(y), blur(y * y)
    c1, c2 = tbasic.SSIM_C1, tbasic.SSIM_C2
    m = ((2 * mx * my + c1) * (2 * (exy - mx * my) + c2)) / (
        (mx * mx + my * my + c1) * ((exx - mx * mx) + (eyy - my * my) + c2))
    want = torch.autograd.grad(m.sum(), (mx, exx, exy))
    got_m, got = tbasic.ssim_terms(x, y)
    torch.testing.assert_close(got_m, m.detach(), atol=1e-12, rtol=1e-12)
    for name, a, b in zip(("D_mu", "D_xx", "D_xy"), got, want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-6, f"{name}: {err:.3g} of the max"


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_frame_equals_picking_first(case, form):
    """The GT as a ``Frame`` of a stack at a [1] int64 index (the first
    and the last frame) against the frame picked first: the same loss, l1
    and gradients bit for bit (the plain version picks it with
    ``index_select``; the kernels read it where it lies)."""
    mode, gt_ch = case
    rgb, logt, gt, bg = arrays(34, 24, 40, gt_ch)
    stack = np.random.default_rng(35).uniform(
        0, 1, (FRAMES,) + gt.shape).astype(np.float32)
    for i in (0, FRAMES - 1):
        stack[i] = gt
        out = []
        for operand in (tevent.Frame(torch.tensor(stack), torch.tensor([i])),
                        torch.tensor(gt)):
            render, leaves = render_operand(rgb, logt, bg, form)
            loss, aux = total_loss(mode)(render, operand, 0.2,
                                         background=torch.tensor(bg))
            out.append((loss, aux["l1"], torch.autograd.grad(loss, leaves)))
        (l1, a1, g1), (l2, a2, g2) = out
        assert_bits_equal(l1, l2, "loss")
        assert_bits_equal(a1, a2, "l1")
        for k, (a, b) in enumerate(zip(g1, g2)):
            assert_bits_equal(a, b, f"gradient {k}")


@pytest.mark.parametrize("frames", [False, True], ids=["views", "frames"])
@pytest.mark.parametrize("mode", ["rgb", "gray"])
def test_step_on_partials_equals_the_composed_step(mode, frames):
    """The rgb and gray train steps, the loss composing the render's
    partials over the background (and, as ``GraphTrainStep`` gives it,
    reading the GT as a frame of its stack at a device index), against the
    step whose loss got the render composed by ``ops/render.composed`` and
    the GT picked first, on the CPU: the loss, l1 and the eight gradients
    bit for bit."""
    from event3dgs_tpu_torch.train import step as step_mod
    from event3dgs_tpu_torch.utils.config import EventConfig

    state, data, cap = step_state("cpu", 300, 64, 48)
    cmask = (torch.arange(16) < 9).float()
    if frames:
        index = torch.tensor([1, 1, 2])
        views = step_mod.step_views(data, mode, index[0:1], index[1:2],
                                    index[2:3], pick=step_mod.take,
                                    frame=tevent.Frame)
        assert isinstance(views.gt_main, tevent.Frame)
    else:
        views = step_mod.step_views(data, mode, 1, 1, 2)
    bg = torch.tensor([0.1, 0.2, 0.3])
    fn = step_mod._views_loss_and_grads(mode, EventConfig(), 0.2, 3, "tiled",
                                        cap)
    name = f"{mode}_total_loss"
    total = getattr(step_mod, name)
    calls = []

    def composed_first(render, gt, lam, plain=False, background=None):
        calls.append((type(render).__name__, type(gt).__name__))
        return total(tevent.render_image(render, background),
                     tevent.frame_image(gt), lam, plain=plain)

    out = {}
    for earlier in (False, True):
        if earlier:
            setattr(step_mod, name, composed_first)
        try:
            loss, aux, grads = fn(state, views, bg, cmask)
        finally:
            setattr(step_mod, name, total)
        out[earlier] = (loss, aux["l1"], [*grads["params"].values(),
                                          grads["contrast"], grads["tap"]])
    assert calls == [("Partials", "Frame" if frames else "Tensor")]
    (l1, a1, g1), (l2, a2, g2) = out[False], out[True]
    assert_bits_equal(l1, l2, "loss")
    assert_bits_equal(a1, a2, "l1")
    for k, (a, b) in enumerate(zip(g1, g2)):
        assert_bits_equal(a, b, f"gradient {k}")
    assert float(g1[0].abs().max()) > 0.0


@pytest.mark.parametrize("mode", ["rgb", "gray"])
def test_loss_takes_the_plain_version_on_the_cpu(mode):
    """On CPU tensors, with ``plain`` or without, the loss is the plain
    version (``photometric_loss_plain``'s loss and l1, bit for bit) and no
    kernel launches."""
    rgb, logt, gt, bg = arrays(36, 24, 40, 3)
    render, _ = render_operand(rgb, logt, bg, "partials", False)
    launches = (tmodes.photometric_loss_forward_kernel.launches,
                tmodes.photometric_loss_backward_kernel.launches)
    want, want_l1, _ = tmodes.photometric_loss_plain(
        render, torch.tensor(gt), 0.2, mode == "gray", torch.tensor(bg))
    for plain in (False, True):
        loss, aux = total_loss(mode)(render, torch.tensor(gt), 0.2,
                                     plain=plain, background=torch.tensor(bg))
        assert_bits_equal(loss, want, "loss")
        assert_bits_equal(aux["l1"], want_l1, "l1")
    assert (tmodes.photometric_loss_forward_kernel.launches,
            tmodes.photometric_loss_backward_kernel.launches) == launches


@pytest.mark.parametrize("form", FORMS)
def test_kernel_wrappers_refuse_cpu_tensors(form):
    """The SSIM kernels' wrappers launch on CUDA tensors or raise (the
    dispatch takes the plain versions for CPU ones); their counts stay."""
    rgb, logt, gt, bg = arrays(37, 24, 40, 3)
    render, _ = render_operand(rgb, logt, bg, form, False)
    frame = tevent.Frame(torch.tensor(gt)[None], torch.tensor([0]))
    background = torch.tensor(bg)
    maps = torch.zeros(3, 24, 40, 3)
    launches = (tmodes.photometric_loss_forward_kernel.launches,
                tmodes.photometric_loss_backward_kernel.launches)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tmodes.photometric_loss_forward_kernel(render, frame, 0.2,
                                               background=background)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tmodes.photometric_loss_backward_kernel(torch.ones(()), render,
                                                frame, maps, 0.2,
                                                background=background)
    assert (tmodes.photometric_loss_forward_kernel.launches,
            tmodes.photometric_loss_backward_kernel.launches) == launches


def test_rgb_mode_refuses_a_one_channel_gt():
    """rgb mode compares three channels: a one-channel GT raises, on the
    CPU as in the kernels' wrappers; gray mode takes it."""
    rgb, logt, gt, bg = arrays(38, 24, 40, 1)
    render, _ = render_operand(rgb, logt, bg, "image", False)
    with pytest.raises(ValueError, match="three channels"):
        tmodes.rgb_total_loss(render, torch.tensor(gt))
    loss, _ = tmodes.gray_total_loss(render, torch.tensor(gt))
    assert torch.isfinite(loss)


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
def test_photometric_bound_counts_the_operands(backward):
    """The SSIM kernels' bound at 1080p, rgb mode from partials: 16 floats
    a pixel forward (rgb, log T and the GT read, the three maps written),
    20 backward (the maps read, d rgb and d log T written); gray mode with
    a three-channel GT 10 and 14; the forward's blurs make it
    operation-bound in rgb mode."""
    pixels = 1920 * 1080
    rgb, gray = (photometric_bound(pixels, c, backward) for c in (3, 1))
    assert rgb[0] == 4 * (20 if backward else 16) * pixels + 4 * (
        1 if backward else 2)
    assert gray[0] == 4 * (14 if backward else 10) * pixels + 4 * (
        1 if backward else 2)
    assert rgb[1][0] > 2 * gray[1][0] > 0
