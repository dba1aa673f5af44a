"""The event-mode loss on the rasterizer's partials and on GT frames of
stacks, on the CPU: the plain version of the loss kernels' operands
(``Partials``: rgb and log T composed over the background; ``Frame``: a
frame of a stack at a device index) against the JAX package's composition
(``event3dgs_tpu/ops/render.py:122``) followed by its
``event_total_loss`` and ``jax.vjp``; the written-out backward against
autograd through ``ops/render.composed`` bit for bit; frames against
images picked first; the train step that hands the loss its partials and
frames against the step that composed and picked first; the wrappers'
dispatch.  The kernels themselves run on the card only
(``tests/test_torch_kernels.py``).

The inputs come from a numpy seed at 24×40 (and 37×53 for the backward:
no multiple of 4 pixels): rgb in [0.02, 0.9], log T in [-4, 0] with some
exact zeros (T = 1), a background with a zero channel in some cases, GT
images of 1 and 3 channels, planted ties of the event pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.losses import event as jevent
from event3dgs_tpu.losses import modes as jmodes
from event3dgs_tpu_torch.losses import event as tevent
from event3dgs_tpu_torch.losses import modes as tmodes
from event3dgs_tpu_torch.ops.render import composed
from event3dgs_tpu_torch.tools.kernel_timing import loss_bound
from test_torch_kernels import (
    assert_bits_equal,
    composed_step_loss_and_grads,
    step_state,
)

torch.set_num_threads(1)

H, W = 24, 40
SETTINGS = dict(gt_contrast=0.17, event_weight=0.9, blur_alpha=0.5)
# (GT channels, event_deblur)
CASES = [(1, False), (3, False), (1, True), (3, True)]
CASE_IDS = [f"gt{c}-{'deblur' if d else 'event'}" for c, d in CASES]
TIES = slice(0, 3)  # rows where the event pair and its GT pair do not change
FRAMES = 5  # frames of each GT stack


def partials_arrays(seed, gt_channels, deblur, h=H, w=W, zero_bg=False):
    """Numpy float32 inputs: [(rgb, log T)] of now, next, main; the GT
    images gt_now, gt_next, gt_main (``gt_channels``) and the blurry image
    or None; the background [3].  On rows ``TIES`` next's partials equal
    now's and gt_next equals gt_now (r = 0 there)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=0.0, hi=1.0: rng.uniform(
        lo, hi, shape).astype(np.float32)
    parts = []
    for _ in range(3):
        logt = f(h, w, lo=-4.0, hi=0.0)
        logt[rng.random((h, w)) < 0.05] = 0.0
        parts.append((f(h, w, 3, lo=0.02, hi=0.9), logt))
    parts[1][0][TIES] = parts[0][0][TIES]
    parts[1][1][TIES] = parts[0][1][TIES]
    gnow, gnext, gmain = (f(h, w, gt_channels, lo=0.05) for _ in range(3))
    gnext[TIES] = gnow[TIES]
    blurry = f(h, w, 3, lo=0.05) if deblur else None
    bg = f(3)
    if zero_bg:
        bg[1] = 0.0
    return parts, (gnow, gnext, gmain, blurry), bg


def torch_partials(parts, requires_grad=False):
    return [tevent.Partials(*(torch.tensor(a).requires_grad_(requires_grad)
                              for a in p)) for p in parts]


def jax_loss_and_grads(parts, gts, bg, raw, param):
    """``jax.vjp`` of the JAX package's composition (``ops/render.py:122``)
    of each render, then its ``event_total_loss`` (and ``deblur_mix``), in
    the rgb and log T of each render and the raw contrast."""
    gnow, gnext, gmain, blurry = gts
    background = jnp.asarray(bg)

    def f(*args):
        *flat, raw = args
        images = [rgb + jnp.exp(logt)[:, :, None] * background[None, None, :]
                  for rgb, logt in zip(flat[0::2], flat[1::2])]
        loss, _ = jmodes.event_total_loss(
            images[0], images[1], images[2], jnp.asarray(gnow),
            jnp.asarray(gnext), jnp.asarray(gmain),
            jevent.effective_contrast(raw, param),
            gt_contrast=SETTINGS["gt_contrast"],
            event_weight=SETTINGS["event_weight"])
        if blurry is not None:
            loss, _ = jmodes.deblur_mix(loss, images[2], jnp.asarray(blurry),
                                        SETTINGS["blur_alpha"])
        return loss

    args = [jnp.asarray(a) for p in parts for a in p]
    loss, vjp = jax.vjp(f, *args, jnp.asarray(raw, jnp.float32))
    return loss, [np.asarray(g) for g in vjp(jnp.ones((), jnp.float32))]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("param", ["identity", "softplus"])
def test_partials_loss_matches_jax_composition_and_vjp(case, param):
    """The port's loss on each render's partials over the background (CPU:
    the plain version, ``ops/render.composed`` then the image loss)
    against the JAX package's composition and ``event_total_loss``: the
    loss within rtol 1e-6; the gradients in each render's rgb and log T
    and in the raw contrast against ``jax.vjp`` within atol 1e-6 and rtol
    1e-5 (float32 sums in two orders), away from the planted ties of the
    event pair (trap (h): there JAX's ``abs`` gradient is 1, PyTorch's 0,
    and the port's is exactly 0)."""
    parts, gts, bg = partials_arrays(21, *case)
    raw = tevent.raw_contrast_init(0.23, param)
    leaves = torch_partials(parts, requires_grad=True)
    raw_t = torch.tensor(raw, dtype=torch.float32, requires_grad=True)
    gnow, gnext, gmain, blurry = (None if a is None else torch.tensor(a)
                                  for a in gts)
    loss, _ = tmodes.event_total_loss(
        *leaves, gnow, gnext, gmain, tevent.effective_contrast(raw_t, param),
        blurry_main=blurry, background=torch.tensor(bg), **SETTINGS)
    inputs = [t for p in leaves for t in p] + [raw_t]
    tg = [g.numpy() for g in torch.autograd.grad(loss, inputs)]
    jl, jg = jax_loss_and_grads(parts, gts, bg, raw, param)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    away = np.ones((H, W), bool)
    away[TIES] = False
    names = [f"{r} {x}" for r in ("now", "next", "main")
             for x in ("rgb", "log T")]
    for name, t, j in zip(names, tg[:6], jg[:6]):
        np.testing.assert_allclose(t[away], j[away], atol=1e-6, rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tg[6], jg[6], atol=1e-6, rtol=1e-5,
                               err_msg="contrast")
    for t in tg[:4]:  # the event pair's ties: PyTorch's abs gradient, 0
        assert not t[TIES].any()
    assert np.abs(tg[1][away]).max() > 0 and np.abs(tg[5]).max() > 0


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("form", ["partials", "main_image", "zero_bg"])
def test_partials_backward_plain_equals_autograd(case, form):
    """``event_loss_backward_plain`` on renders given as partials against
    autograd of ``event_mixture_loss_plain`` (which composes them with
    ``ops/render.composed``): each render's d rgb and d log T bit for bit
    (one op for each of autograd's, in its order), the contrast's within
    atol 1e-6 and rtol 1e-5 (a sum), at the gradient 1 and a seeded one;
    with the main render given as its image (the kernels' null log T),
    and with a zero background channel (signed zeros in the channel
    sum)."""
    parts, gts, bg = partials_arrays(22, *case, h=37, w=53,
                                     zero_bg=form == "zero_bg")
    leaves = torch_partials(parts, requires_grad=True)
    background = torch.tensor(bg)
    renders = list(leaves)
    if form == "main_image":
        main = composed(*(t.detach() for t in leaves[2]), background)
        renders[2] = main.requires_grad_(True)
    gnow, gnext, gmain, blurry = (None if a is None else torch.tensor(a)
                                  for a in gts)
    c = torch.tensor(0.3, requires_grad=True)
    kw = dict(SETTINGS, blurry_main=blurry, background=background)
    loss, aux = tevent.event_mixture_loss_plain(*renders, gnow, gnext, gmain,
                                                c, **kw)
    inputs = [t for r in renders
              for t in (r if isinstance(r, tevent.Partials) else (r,))]
    detached = [tevent.Partials(*(t.detach() for t in r))
                if isinstance(r, tevent.Partials) else r.detach()
                for r in renders]
    for grad in (torch.ones(()), torch.tensor(-0.37)):
        want = torch.autograd.grad(loss, inputs + [c], grad,
                                   retain_graph=True)
        got = tevent.event_loss_backward_plain(
            grad, *detached, gnow, gnext, gmain, c.detach(),
            aux["coverage"], **kw)
        flat = [t for g in got[:3]
                for t in (g if isinstance(g, tevent.Partials) else (g,))]
        assert len(flat) == len(inputs)
        for i, (a, b) in enumerate(zip(flat, want)):
            assert_bits_equal(a, b, f"operand {i}")
        assert got[3].shape == c.shape
        torch.testing.assert_close(got[3], want[-1], atol=1e-6, rtol=1e-5)


def test_composed_backward_plain_equals_autograd():
    """``composed_backward_plain`` against autograd through
    ``ops/render.composed`` bit for bit, on gradients with signed zeros,
    a zero background channel and log T with zeros and a -inf (T = 0)."""
    rng = np.random.default_rng(23)
    rgb = torch.tensor(rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
                       requires_grad=True)
    logt = rng.uniform(-30, 0, (H, W)).astype(np.float32)
    logt[0, :5] = 0.0
    logt[1, 0] = -np.inf
    logt = torch.tensor(logt, requires_grad=True)
    g = rng.normal(size=(H, W, 3)).astype(np.float32)
    g[2] = -0.0
    g[3, :, 1] = 0.0
    g = torch.tensor(g)
    for bg in ([0.1, 0.0, 0.7], [0.0, 0.0, 0.0], [1.0, 0.5, 0.25]):
        bg = torch.tensor(bg)
        want = torch.autograd.grad(composed(rgb, logt, bg), (rgb, logt), g)
        got = tevent.composed_backward_plain(
            g, tevent.Partials(rgb.detach(), logt.detach()), bg)
        for a, b, what in zip(got, want, ("rgb", "log T")):
            assert_bits_equal(a, b, what)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_frames_equal_picking_first(case):
    """GT operands as ``Frame``s of stacks at [1] int64 indices (the first
    and the last frame among them) against the frames picked first: the
    same loss, aux and gradients bit for bit (the plain version; the
    kernels read the frame where it lies, the plain version picks it with
    ``index_select``)."""
    parts, gts, bg = partials_arrays(24, *case)
    rng = np.random.default_rng(25)
    stacks = [None if g is None else
              rng.uniform(0, 1, (FRAMES,) + g.shape).astype(np.float32)
              for g in gts]
    where = (0, FRAMES - 1, 2, 3)
    for s, g, i in zip(stacks, gts, where):
        if s is not None:
            s[i] = g
    frames = [None if s is None else
              tevent.Frame(torch.tensor(s), torch.tensor([i]))
              for s, i in zip(stacks, where)]
    images = [None if g is None else torch.tensor(g) for g in gts]
    out = []
    for operands in (frames, images):
        leaves = torch_partials(parts, requires_grad=True)
        c = torch.tensor(0.25, requires_grad=True)
        loss, aux = tevent.event_mixture_loss(
            *leaves, *operands[:3], c, blurry_main=operands[3],
            background=torch.tensor(bg), **SETTINGS)
        grads = torch.autograd.grad(loss, [t for p in leaves for t in p]
                                    + [c])
        out.append((loss, aux, grads))
    (l1, a1, g1), (l2, a2, g2) = out
    assert_bits_equal(l1, l2, "loss")
    assert a1.keys() == a2.keys()
    for k in a1:
        assert_bits_equal(a1[k], a2[k], k)
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert_bits_equal(a, b, f"gradient {i}")


@pytest.mark.parametrize("frames", [False, True], ids=["views", "frames"])
@pytest.mark.parametrize("mode", ["event", "event_deblur"])
def test_step_with_the_fold_equals_the_composed_step(mode, frames):
    """The train step, its loss composing the renders' partials (and, as
    ``GraphTrainStep`` gives them, reading the GT images as frames of
    their stacks at device indices), against the step that composed each
    render with ``ops/render.composed`` and picked the GT images first, on
    the CPU: the loss and the eight gradients (the six leaves, the
    contrast, the tap) bit for bit."""
    state, data, cap = step_state("cpu", 300, 64, 48)
    cmask = (torch.arange(16) < 9).float()
    loss, got, want_loss, want, names = composed_step_loss_and_grads(
        state, data, mode, cmask, cap, frames=frames)
    assert_bits_equal(loss, want_loss, "loss")
    for name, g, w in zip(names, got, want):
        assert_bits_equal(g, w, name)
    assert float(got[-2].abs()) > 0.0  # the contrast's gradient


def test_partials_loss_takes_the_plain_version_on_the_cpu():
    """On CPU tensors (and with ``plain``) ``event_mixture_loss`` on
    partials and frames is the plain version under autograd: the same loss
    and aux as composing and picking first, and no kernel launch."""
    parts, gts, bg = partials_arrays(26, 3, True)
    renders = torch_partials(parts)
    stack = torch.tensor(np.stack([gts[0], gts[1]]))
    frame = tevent.Frame(stack, torch.tensor([1]))
    background = torch.tensor(bg)
    gnow, _, gmain, blurry = (torch.tensor(a) for a in gts)
    c = torch.tensor(0.3)
    launches = (tevent.event_loss_forward_kernel.launches,
                tevent.event_loss_backward_kernel.launches)
    images = [composed(*r, background) for r in renders]
    want, want_aux = tevent.event_mixture_loss_plain(
        *images, gnow, stack[1], gmain, c, blurry_main=blurry, **SETTINGS)
    for plain in (False, True):
        loss, aux = tevent.event_mixture_loss(
            *renders, gnow, frame, gmain, c, blurry_main=blurry,
            background=background, plain=plain, **SETTINGS)
        assert_bits_equal(loss, want, "loss")
        assert aux.keys() == want_aux.keys()
    assert (tevent.event_loss_forward_kernel.launches,
            tevent.event_loss_backward_kernel.launches) == launches


def test_partials_loss_kernel_wrappers_refuse_cpu_tensors():
    """The loss kernels' wrappers, given partials and frames, launch on
    CUDA tensors or raise (the dispatch picks the plain versions for CPU
    ones); their counts stay."""
    parts, gts, bg = partials_arrays(27, 1, True)
    renders = torch_partials(parts)
    frames = [tevent.Frame(torch.tensor(g)[None], torch.tensor([0]))
              for g in gts]
    c, background = torch.tensor(0.2), torch.tensor(bg)
    launches = (tevent.event_loss_forward_kernel.launches,
                tevent.event_loss_backward_kernel.launches)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tevent.event_loss_forward_kernel(*renders, *frames[:3], c,
                                         blurry_main=frames[3],
                                         background=background)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tevent.event_loss_backward_kernel(torch.ones(()), *renders,
                                          *frames[:3], c, c,
                                          blurry_main=frames[3],
                                          background=background)
    assert (tevent.event_loss_forward_kernel.launches,
            tevent.event_loss_backward_kernel.launches) == launches


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
def test_loss_bound_counts_the_partials(backward):
    """The loss kernels' bound at 1080p with three-channel GT: the three
    renders' partials (4 floats a pixel more than their images: log T, and
    in the backward its gradient written) and the GT images read once;
    each render's composition (and log T gradient) among the operations."""
    pixels = 1920 * 1080
    images, parts = (loss_bound(pixels, [3, 3, 3], backward, partials=n)
                     for n in (0, 3))
    floats = 21 + (12 if backward else 0)
    assert parts[0] == 4 * floats * pixels + 4 * (4 if backward else 6)
    assert parts[0] - images[0] == 4 * 3 * pixels * (2 if backward else 1)
    fp32, sfu = (12, 1) if backward else (6, 1)
    assert parts[1] == (images[1][0] + 3 * fp32 * pixels,
                        images[1][1] + 3 * sfu * pixels)
