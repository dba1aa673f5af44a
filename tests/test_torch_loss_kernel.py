"""The event-mode loss's plain versions on the CPU: the analytic backward
(``event_loss_backward_plain``, the backward kernel's plain version)
against autograd of the plain forward, and the port's loss gradients
against ``jax.vjp`` of the JAX package's ``event_total_loss`` and
``deblur_mix``; the dispatch of ``event_mixture_loss``.

The inputs come from a numpy seed at 37×53 (no multiple of 4 pixels): GT
images of 1 and 3 channels, identical GT pairs (coverage 0), planted ties
(pixels whose rendered and GT pairs do not change, and a main render equal
to its GT there, where |r| has PyTorch's gradient 0), the identity and
softplus contrast.  The kernels themselves run on the card only
(``tests/test_torch_kernels.py``).
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

torch.set_num_threads(1)

H, W = 37, 53
GT_CONTRAST, EVENT_WEIGHT, BLUR_ALPHA = 0.17, 0.9, 0.5
# (GT channels, event_deblur, identical GT pairs, planted ties)
CASES = [(1, False, False, True), (3, False, False, True),
         (1, True, False, True), (3, True, False, True),
         (3, False, True, False), (1, True, True, True),
         (3, True, False, False)]
# rows of the planted ties: the event pair's (r = 0), the main render's
# (main = gt_main) and, in event_deblur mode, the blurry image's
EVENT_TIES, MAIN_TIES, BLUR_TIES = slice(0, 4), slice(4, 7), slice(7, 9)
CASE_IDS = [f"gt{c}-{'deblur' if d else 'event'}"
            f"{'-identical_gt' if i else ''}{'-ties' if t else ''}"
            for c, d, i, t in CASES]


def loss_arrays(seed, gt_channels, deblur, identical_gt, ties):
    """(now, next, main, gt_now, gt_next, gt_main, blurry or None) as numpy
    float32: renders in [0.05, 1] (so log(L + ε) stays moderate), GT
    images of ``gt_channels``."""
    rng = np.random.default_rng(seed)
    img = lambda c: rng.uniform(0.05, 1.0, (H, W, c)).astype(np.float32)
    now, nxt, main = img(3), img(3), img(3)
    gnow, gnext, gmain = img(gt_channels), img(gt_channels), img(gt_channels)
    blurry = img(3) if deblur else None
    if identical_gt:
        gnext = gnow.copy()
    if ties:  # r = 0, main - gt_main = 0 and main - blurry = 0 on these rows
        nxt[EVENT_TIES] = now[EVENT_TIES]
        gnext[EVENT_TIES] = gnow[EVENT_TIES]
        main[MAIN_TIES] = gmain[MAIN_TIES]
        if deblur:
            blurry[BLUR_TIES] = main[BLUR_TIES]
    return now, nxt, main, gnow, gnext, gmain, blurry


def torch_loss_and_grads(arrays, raw, param):
    """The port's loss (CPU: the plain forward) and autograd's gradients
    with respect to the three renders and the raw contrast."""
    now, nxt, main, gnow, gnext, gmain, blurry = (
        None if a is None else torch.tensor(a) for a in arrays)
    leaves = [x.requires_grad_(True) for x in (now, nxt, main)]
    raw_t = torch.tensor(raw, dtype=torch.float32, requires_grad=True)
    loss, aux = tmodes.event_total_loss(
        *leaves, gnow, gnext, gmain,
        tevent.effective_contrast(raw_t, param), gt_contrast=GT_CONTRAST,
        event_weight=EVENT_WEIGHT, blurry_main=blurry, blur_alpha=BLUR_ALPHA)
    grads = torch.autograd.grad(loss, [*leaves, raw_t])
    return loss, aux, [g.numpy() for g in grads]


def jax_loss_and_grads(arrays, raw, param):
    """``jax.vjp`` of the JAX package's ``event_total_loss`` (and
    ``deblur_mix`` where there is a blurry image) in the renders and the
    raw contrast."""
    now, nxt, main, gnow, gnext, gmain, blurry = arrays

    def f(now, nxt, main, raw):
        loss, _ = jmodes.event_total_loss(
            now, nxt, main, jnp.asarray(gnow), jnp.asarray(gnext),
            jnp.asarray(gmain), jevent.effective_contrast(raw, param),
            gt_contrast=GT_CONTRAST, event_weight=EVENT_WEIGHT)
        if blurry is not None:
            loss, _ = jmodes.deblur_mix(loss, main, jnp.asarray(blurry),
                                        BLUR_ALPHA)
        return loss

    loss, vjp = jax.vjp(f, jnp.asarray(now), jnp.asarray(nxt),
                        jnp.asarray(main), jnp.asarray(raw, jnp.float32))
    return loss, [np.asarray(g) for g in vjp(jnp.ones((), jnp.float32))]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("param", ["identity", "softplus"])
def test_event_loss_gradients_match_jax_vjp(case, param):
    """The port's event-loss gradients (the three renders and the raw
    contrast, through ``effective_contrast``) against ``jax.vjp`` of the
    JAX package's loss: atol 1e-6, rtol 1e-5 (float32 sums in two orders);
    the loss within rtol 1e-6.

    Away from the planted ties only: at |x| with x = 0 PyTorch's gradient
    is 0 (``sgn``), the reference's (a PyTorch program) too, while JAX's
    ``abs`` takes its positive branch there (1 in jax 0.9).  So at the tie
    rows the port's image gradients of that term are exactly 0 and JAX's
    are not; the contrast's gradient is unmoved (its term there is 0·g)."""
    arrays = loss_arrays(11, *case)
    raw = tevent.raw_contrast_init(0.23, param)
    tl, _, tg = torch_loss_and_grads(arrays, raw, param)
    jl, jg = jax_loss_and_grads(arrays, raw, param)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _, deblur, identical_gt, ties = case
    away = np.ones((H, W, 3), bool)
    if ties:
        away[EVENT_TIES] = away[MAIN_TIES] = False
        if deblur:
            away[BLUR_TIES] = False
    for name, t, j in zip(("now", "next", "main"), tg, jg):
        np.testing.assert_allclose(t[away], j[away], atol=1e-6, rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tg[3], jg[3], atol=1e-6, rtol=1e-5,
                               err_msg="contrast")
    if identical_gt:  # coverage 0: the event term has no gradient
        assert not tg[0].any() and not tg[1].any()
    if ties:
        for t, j in zip(tg[:2], jg[:2]):
            assert not t[EVENT_TIES].any()
            assert identical_gt or np.abs(j[EVENT_TIES]).min() > 0
        if not deblur:
            assert not tg[2][MAIN_TIES].any()
            assert np.abs(jg[2][MAIN_TIES]).min() > 0


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("contrast", [0.23, -0.4])
def test_event_loss_backward_plain_equals_autograd(case, contrast):
    """``event_loss_backward_plain`` against autograd of
    ``event_mixture_loss_plain``: the image gradients bit for bit (one op
    for each of autograd's, in its order), the contrast's within atol 1e-6
    and rtol 1e-5 (a sum), at the gradient 1 and a seeded one."""
    arrays = loss_arrays(12, *case)
    now, nxt, main, gnow, gnext, gmain, blurry = (
        None if a is None else torch.tensor(a) for a in arrays)
    leaves = [x.requires_grad_(True) for x in (now, nxt, main)]
    c = torch.tensor(contrast, requires_grad=True)
    kw = dict(gt_contrast=GT_CONTRAST, event_weight=EVENT_WEIGHT,
              blurry_main=blurry, blur_alpha=BLUR_ALPHA)
    loss, aux = tevent.event_mixture_loss_plain(*leaves, gnow, gnext, gmain,
                                                c, **kw)
    for grad in (torch.ones(()), torch.tensor(-0.37)):
        want = torch.autograd.grad(loss, [*leaves, c], grad,
                                   retain_graph=True)
        got = tevent.event_loss_backward_plain(
            grad, *(x.detach() for x in leaves), gnow, gnext, gmain,
            c.detach(), aux["coverage"], **kw)
        for name, a, b in zip(("now", "next", "main"), got, want):
            assert torch.equal(a, b), name
        assert got[3].shape == c.shape
        torch.testing.assert_close(got[3], want[3], atol=1e-6, rtol=1e-5)


def test_event_mixture_loss_takes_the_plain_version_on_the_cpu():
    """On CPU tensors (and with ``plain``) ``event_mixture_loss`` is the
    plain forward under autograd: the same loss, aux and gradients, and no
    kernel launch; in event_deblur mode ``deblur_mix`` of the event loss."""
    arrays = loss_arrays(13, 3, True, False, True)
    now, nxt, main, gnow, gnext, gmain, blurry = (torch.tensor(a)
                                                  for a in arrays)
    c = torch.tensor(0.3)
    launches = (tevent.event_loss_forward_kernel.launches,
                tevent.event_loss_backward_kernel.launches)
    for plain in (False, True):
        loss, aux = tevent.event_mixture_loss(now, nxt, main, gnow, gnext,
                                              gmain, c, blurry_main=blurry,
                                              plain=plain)
        base, base_aux = tevent.event_mixture_loss_plain(
            now, nxt, main, gnow, gnext, gmain, c)
        mixed, blur = tmodes.deblur_mix(base, main, blurry)
        assert torch.equal(loss, mixed)
        assert aux == {**base_aux, **blur}
    assert set(tevent.event_mixture_loss(now, nxt, main, gnow, gnext, gmain,
                                         c)[1]) == set(tevent.AUX[:3])
    assert (tevent.event_loss_forward_kernel.launches,
            tevent.event_loss_backward_kernel.launches) == launches


def test_event_loss_kernel_wrappers_refuse_cpu_tensors():
    """The loss kernels' wrappers launch on CUDA tensors or raise (the
    dispatch picks the plain versions for CPU ones); their counts stay."""
    now, nxt, main, gnow, gnext, gmain, _ = (
        None if a is None else torch.tensor(a)
        for a in loss_arrays(14, 1, False, False, False))
    c = torch.tensor(0.2)
    launches = (tevent.event_loss_forward_kernel.launches,
                tevent.event_loss_backward_kernel.launches)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tevent.event_loss_forward_kernel(now, nxt, main, gnow, gnext, gmain, c)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tevent.event_loss_backward_kernel(torch.ones(()), now, nxt, main,
                                          gnow, gnext, gmain, c, c)
    assert (tevent.event_loss_forward_kernel.launches,
            tevent.event_loss_backward_kernel.launches) == launches


def test_loss_constants_round_as_pytorch_does():
    """The kernels' host constants: each Python float rounded to float32 as
    PyTorch rounds a scalar operand, the reciprocals 1/gt_contrast, 1/P
    and 1/3P as float32 divisions (PyTorch's CUDA division by a host
    scalar and its mean)."""
    k = tevent.loss_constants(H * W, GT_CONTRAST, EVENT_WEIGHT, BLUR_ALPHA)
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    want = [*(f(w) for w in (0.4124, 0.35758, 0.1804)), f(tevent.LOG_EPS),
            f(1.0) / f(GT_CONTRAST), f(EVENT_WEIGHT), f(1.0 - EVENT_WEIGHT),
            f(BLUR_ALPHA), f(1.0 - BLUR_ALPHA), f(1.0) / f(H * W),
            f(1.0) / f(3 * H * W)]
    assert len(k) == len(want) == 11
    for got, w in zip(k, want):
        assert np.float32(got) == w.numpy()
