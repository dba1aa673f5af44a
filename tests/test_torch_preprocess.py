"""The preprocess of ``ops/preprocess.py`` on the CPU: the plain forward
(the port's ``project_gaussians`` and ``gaussian_colors``) against the JAX
package's, the analytic plain backward against ``jax.vjp`` of the JAX
functions and against float64 autograd of the plain forward, the CPU
render's gradients through ``Preprocess`` against the JAX render's, the
V-view plain versions (the feature leaves, the SH mask, 1 and 3 views)
against ``jax.vjp`` of the JAX functions summed over the views, and the
train step built on the V-view call against the step that renders each
view on its own.

Tolerances: the forward as tests/test_torch_projection.py holds it; the
backward against JAX max-normalised at atol 2e-4 (tests/test_rasterize_tiled
.py's); against float64 autograd at 1e-10 of each gradient's max (the two
differ only by float64 rounding).  The rasterizers give a Gaussian that is
not valid no gradient, so the cotangents are zero there, and the analytic
backward defines its gradient as exactly zero.  The step's loss and
gradients equal the per-render step's bit for bit: the backward adds the
views' gradients in the order autograd adds the three renders'.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.core import make_camera as jmake_camera
from event3dgs_tpu.ops.projection import project_gaussians as jproject
from event3dgs_tpu.ops.render import gaussian_colors as jcolors
from event3dgs_tpu.ops.render import render as jrender
from event3dgs_tpu_torch.core import make_camera as tmake_camera
from event3dgs_tpu_torch.ops import preprocess as pre
from event3dgs_tpu_torch.ops.projection import project_gaussians
from event3dgs_tpu_torch.ops.render import gaussian_colors, render
from test_torch_kernels import (
    assert_bits_equal,
    per_render_loss_and_grads,
    preprocess_arrays,
    preprocess_scene,
    seeded_tap,
    step_state,
)

torch.set_num_threads(1)


def leaves(feats):
    """[N, K, 3] features as the two leaves (None, None without)."""
    return (None, None) if feats is None else (feats[:, :1], feats[:, 1:])


def forward1(means, scales, rots, cam, smod, opac, feats, deg):
    """The plain forward at one view, on [N, K, 3] features, unmasked."""
    (out,) = pre.preprocess_forward_plain(means, scales, rots, [cam], smod,
                                          opac, *leaves(feats), None, deg)
    return out


def backward1(means, scales, rots, cam, valid, g_mean2d, g_conic, g_colors,
              smod, feats, deg):
    """The plain backward at one view, the feature leaves' gradients put
    back together as [N, K, 3]."""
    g = pre.preprocess_backward_plain(
        means, scales, rots, [cam], [valid], [g_mean2d], [g_conic],
        [g_colors], smod, *leaves(feats), None, deg)
    return (*g[:3], None if g[3] is None else torch.cat(g[3:], dim=1))

# (N, seed, SH degree, edge cases, scaling modifier, with opacities, with
# features)
CASES = [
    (0, 0, 3, False, 1.0, True, True),
    (1, 1, 3, False, 1.0, True, True),
    (255, 2, 0, True, 1.0, True, True),
    (257, 3, 1, True, 0.6, True, True),
    (257, 4, 2, False, 1.0, False, True),
    (257, 5, 3, True, 1.0, True, True),
    (255, 6, 4, True, 0.6, True, True),
    (257, 7, 3, True, 1.0, True, False),
    (257, 8, 4, False, 1.4, True, True),
]
IDS = [f"n{c[0]}-seed{c[1]}-deg{c[2]}{'-edge' if c[3] else ''}-mod{c[4]}"
       f"{'' if c[5] else '-noopac'}{'' if c[6] else '-nofeat'}" for c in CASES]


def inputs(case):
    """A case's arrays (float32) and its camera in both packages."""
    n, seed, deg, edge, smod, with_opac, with_feats = case
    a = preprocess_arrays(n, seed, sh_degree=deg, edge=edge)
    f32 = lambda x: np.asarray(x, np.float32)
    arrs = {k: f32(a[k]) for k in ("means", "scales", "rots", "opac", "feats")}
    jcam = jmake_camera(a["R"], a["t"], *a["fov"], a["w"], a["h"])
    tcam = tmake_camera(a["R"], a["t"], *a["fov"], a["w"], a["h"],
                        device="cpu")
    return arrs, jcam, tcam


def cotangents(n, valid, seed, with_feats):
    """Seeded cotangents of mean2d, conic and colours, zero where the
    Gaussian is not valid (the rasterizers give it none)."""
    rng = np.random.default_rng(100 + seed)
    m = np.asarray(valid, np.float32)[:, None]
    return (np.float32(rng.normal(size=(n, 2))) * m,
            np.float32(rng.normal(size=(n, 3))) * m,
            np.float32(rng.normal(size=(n, 3))) * m if with_feats else None)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_jax(case):
    n, seed, deg, edge, smod, with_opac, with_feats = case
    arrs, jcam, tcam = inputs(case)
    j = lambda k: jnp.asarray(arrs[k])
    t = lambda k: torch.as_tensor(arrs[k])
    ref = jproject(j("means"), j("scales"), j("rots"), jcam,
                   scaling_modifier=smod,
                   opacities=j("opac") if with_opac else None)
    proj, colors = forward1(
        t("means"), t("scales"), t("rots"), tcam, smod,
        t("opac") if with_opac else None, t("feats") if with_feats else None,
        deg)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(proj.valid.numpy(), valid)
    if edge:
        assert 0 < valid.sum() < n
    np.testing.assert_array_equal(proj.radius.numpy(), np.asarray(ref.radius))
    np.testing.assert_array_equal(np.isinf(proj.depth.numpy()), ~valid)
    np.testing.assert_allclose(proj.depth.numpy()[valid],
                               np.asarray(ref.depth)[valid], atol=1e-5)
    np.testing.assert_allclose(proj.mean2d.numpy()[valid],
                               np.asarray(ref.mean2d)[valid], atol=1e-4)
    np.testing.assert_allclose(proj.conic.numpy()[valid],
                               np.asarray(ref.conic)[valid], atol=1e-5,
                               rtol=1e-5)
    if not with_feats:
        assert colors is None
        return
    jc = np.asarray(jcolors(deg, j("feats"), j("means"), jcam.camera_center))
    np.testing.assert_allclose(colors.numpy(), jc, atol=1e-5)
    assert (colors.numpy()[np.isfinite(jc)] >= 0).all()
    if edge:  # some colours are clamped
        assert (colors.numpy() == 0).any()


def jax_vjp(case, arrs, jcam, cts):
    """The JAX functions' gradients of the means, scales, rotations and
    features under the cotangents ``cts``."""
    n, seed, deg, edge, smod, with_opac, with_feats = case
    opac = jnp.asarray(arrs["opac"]) if with_opac else None

    def f(m, s, q, feats):
        p = jproject(m, s, q, jcam, scaling_modifier=smod, opacities=opac)
        out = (p.mean2d, p.conic)
        if with_feats:
            out += (jcolors(deg, feats, m, jcam.camera_center),)
        return out

    _, vjp = jax.vjp(f, *(jnp.asarray(arrs[k]) for k in (
        "means", "scales", "rots", "feats")))
    grads = vjp(tuple(jnp.asarray(c) for c in cts if c is not None))
    return [np.asarray(g) for g in grads]


def assert_max_normalised(got, want, atol, what):
    """``got`` within ``atol`` of ``want``'s max, where ``want`` is finite."""
    assert got.shape == want.shape, what
    if not want.size:
        return
    finite = np.isfinite(want).reshape(want.shape[0], -1).all(axis=1)
    assert np.isfinite(got).all(), what
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got[finite] / (scale + 1e-30),
                               want[finite] / (scale + 1e-30), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    n, seed, deg, edge, smod, with_opac, with_feats = case
    arrs, jcam, tcam = inputs(case)
    t = lambda k: torch.as_tensor(arrs[k])
    opac = t("opac") if with_opac else None
    feats = t("feats") if with_feats else None
    proj, _ = forward1(t("means"), t("scales"), t("rots"), tcam, smod, opac,
                       feats, deg)
    cts = cotangents(n, proj.valid.numpy(), seed, with_feats)
    got = backward1(
        t("means"), t("scales"), t("rots"), tcam, proj.valid,
        *(None if c is None else torch.as_tensor(c) for c in cts), smod,
        feats, deg)
    want = jax_vjp(case, arrs, jcam, cts)
    for name, g, w in zip(("means", "scales", "rotations", "features"), got,
                          want):
        if not with_feats and name == "features":
            assert g is None
            continue
        assert_max_normalised(g.numpy(), w, 2e-4, name)
        invalid = ~proj.valid.numpy()
        assert (g.numpy()[invalid] == 0).all(), name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_float64_autograd(case):
    """The derivation itself: the analytic backward equals autograd of the
    plain forward in float64 to 1e-10 of each gradient's max (autograd's
    NaN rows, F4, left out: the analytic backward gives zero there)."""
    n, seed, deg, edge, smod, with_opac, with_feats = case
    means, scales, rots, opac, feats, cam = preprocess_scene(
        n, seed, sh_degree=deg, edge=edge, dtype=torch.float64)
    leaves = [x.requires_grad_(True) for x in (means, scales, rots, feats)]
    proj, colors = forward1(
        means, scales, rots, cam, smod, opac if with_opac else None,
        feats if with_feats else None, deg)
    cts = [torch.as_tensor(c, dtype=torch.float64) if c is not None else None
           for c in cotangents(n, proj.valid.numpy(), seed, with_feats)]
    loss = (proj.mean2d * cts[0]).sum() + (proj.conic * cts[1]).sum()
    if with_feats:
        loss = loss + (colors * cts[2]).sum()
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = backward1(
        *(x.detach() for x in (means, scales, rots)), cam, proj.valid, *cts,
        smod, feats.detach() if with_feats else None, deg)
    for name, g, w in zip(("means", "scales", "rotations", "features"), got,
                          want):
        if not with_feats and name == "features":
            assert g is None
            continue
        assert_max_normalised(g.numpy(), w.numpy(), 1e-10, name)


def test_autograd_nan_at_the_camera_centre_is_zero_here():
    """F4: a Gaussian at the camera centre (not valid: behind the near
    plane) has the direction 0/0.  Autograd of the plain forward gives its
    means and features NaN gradients though its cotangents are zero (0·NaN
    in the SH basis's backward); the analytic backward, the kernel's
    formulas, gives exactly zero, and the other Gaussians' gradients agree."""
    means, scales, rots, opac, feats, cam = preprocess_scene(
        64, 9, edge=True, dtype=torch.float64)
    assert float(means[0].abs().max()) == 0.0  # the identity camera's centre
    leaves = [x.requires_grad_(True) for x in (means, feats)]
    proj, colors = forward1(means, scales, rots, cam, 1.0, opac, feats, 3)
    assert not bool(proj.valid[0])
    w = proj.valid[:, None].double()
    loss = (colors * w).sum() + (proj.mean2d * w).sum()
    g_means, g_feats = torch.autograd.grad(loss, leaves)
    assert torch.isnan(g_means[0]).all() and torch.isnan(g_feats[0]).any()
    assert torch.isfinite(g_means[1:]).all()
    got = backward1(
        means.detach(), scales, rots, cam, proj.valid, w.expand(-1, 2),
        None, w.expand(-1, 3), 1.0, feats.detach(), 3)
    assert (got[0][0] == 0).all() and (got[3][0] == 0).all()
    torch.testing.assert_close(got[0][1:], g_means[1:], rtol=1e-10,
                               atol=1e-12)


def test_preprocess_function_on_the_cpu():
    """``preprocess`` on CPU tensors: the plain forward's outputs; autograd
    through ``Preprocess`` gives the analytic backward's gradients, none to
    the opacities; depth, radius and valid carry no gradient."""
    means, scales, rots, opac, feats, cam = preprocess_scene(200, 10,
                                                             edge=True)
    leaves = [x.requires_grad_(True) for x in (means, scales, rots, opac,
                                               feats)]
    proj, colors = pre.preprocess(means, scales, rots, cam, 0.8,
                                  opacities=opac, features=feats, sh_degree=3)
    want, want_c = forward1(
        *(x.detach() for x in (means, scales, rots)), cam, 0.8,
        opac.detach(), feats.detach(), 3)
    for a, b in zip((*proj, colors), (*want, want_c)):
        assert_bits_equal(a, b)
    assert proj.mean2d.requires_grad and colors.requires_grad
    assert not any(x.requires_grad for x in (proj.depth, proj.radius,
                                             proj.valid))
    g = [torch.linspace(-1, 1, x.numel()).reshape(x.shape)
         for x in (proj.mean2d, proj.conic, colors)]
    loss = sum((x * w).sum() for x, w in zip((proj.mean2d, proj.conic,
                                              colors), g))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert grads[3] is None
    ref = backward1(
        *(x.detach() for x in (means, scales, rots)), cam, proj.valid, *g,
        0.8, feats.detach(), 3)
    for a, b in zip((grads[0], grads[1], grads[2], grads[4]), ref):
        assert torch.equal(a, b)


def render_scene(seed=3, n=60, w=128, h=48, deg=3):
    """tests/test_rasterize_tiled.py's scene with SH features and
    unnormalised quaternions, as float32 arrays."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        means=f32(np.c_[rng.uniform(-1.2, 1.2, n), rng.uniform(-0.48, 0.48, n),
                        rng.uniform(2.0, 6.0, n)]),
        feats=f32(rng.normal(0.0, 0.4, (n, (deg + 1) ** 2, 3))),
        opac=f32(rng.uniform(0.2, 0.95, n)),
        scales=f32(np.exp(rng.uniform(np.log(0.03), np.log(0.25), (n, 1)))
                   * rng.uniform(0.7, 1.4, (n, 3))),
        rots=f32(rng.normal(size=(n, 4)) * 2.0),
        wgt=f32(np.random.default_rng(7).uniform(-1, 1, (h, w, 3))),
        w=w, h=h, deg=deg)


ARGS = ("means", "feats", "opac", "scales", "rots")


@pytest.mark.parametrize("rasterizer,deg", [("tiled", 3), ("reference", 3),
                                            ("reference", 4)])
def test_render_gradients_through_preprocess_match_jax(rasterizer, deg):
    """The CPU render (``Preprocess``'s plain forward and analytic backward,
    the rasterizer's plain versions) against the JAX render: gradients of a
    weighted image sum with respect to the five Gaussian inputs, within 2e-4
    of each one's max (tests/test_torch_rasterize_grad.py's tolerance)."""
    s = render_scene(deg=deg)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    R, t = np.eye(3), np.asarray([0.05, 0.0, -0.1])
    jcam = jmake_camera(R, t, 1.0, 0.8, s["w"], s["h"])
    tcam = tmake_camera(R, t, 1.0, 0.8, s["w"], s["h"], device="cpu")

    def jloss(m, f, o, sc, q):
        img = jrender(m, f, o, sc, q, jcam, jnp.asarray(bg), sh_degree=deg,
                      rasterizer=rasterizer).image
        return jnp.sum(img * s["wgt"])

    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(s[k]) for k in ARGS))
    leaves = [torch.tensor(s[k], requires_grad=True) for k in ARGS]
    img = render(*leaves, tcam, torch.as_tensor(bg), sh_degree=deg,
                 rasterizer=rasterizer).image
    got = torch.autograd.grad((img * torch.as_tensor(s["wgt"])).sum(), leaves)
    for name, g, w in zip(ARGS, got, want):
        assert_max_normalised(g.numpy(), np.asarray(w), 2e-4, name)


def test_render_through_preprocess_equals_the_plain_autograd_path():
    """The render's gradients through ``Preprocess`` against autograd of the
    plain forward (``project_gaussians`` and ``gaussian_colors`` composed by
    hand before the same rasterizer), on the CPU: the two backward passes
    differ only by float32 rounding."""
    s = render_scene(seed=5, n=80)
    tcam = tmake_camera(np.eye(3), np.zeros(3), 1.0, 0.8, s["w"], s["h"],
                        device="cpu")
    bg = torch.tensor([0.1, 0.2, 0.3])
    wgt = torch.as_tensor(s["wgt"])
    out = {}
    for how in ("preprocess", "autograd"):
        leaves = [torch.tensor(s[k], requires_grad=True) for k in ARGS]
        m, f, o, sc, q = leaves
        if how == "preprocess":
            img = render(m, f, o, sc, q, tcam, bg, sh_degree=3,
                         rasterizer="tiled").image
        else:
            from event3dgs_tpu_torch.ops.rasterize_tiled import rasterize_tiled

            proj = project_gaussians(m, sc, q, tcam, opacities=o)
            img = rasterize_tiled(proj, gaussian_colors(3, f, m,
                                                        tcam.camera_center),
                                  o, bg, s["w"], s["h"])
        out[how] = torch.autograd.grad((img * wgt).sum(), leaves)
    for name, a, b in zip(ARGS, out["preprocess"], out["autograd"]):
        assert_max_normalised(a.numpy(), b.numpy(), 2e-5, name)


def test_preprocess_float64_camera_is_the_float32_one():
    """The float64 scenes of the derivation test take the float32 camera's
    values (so both dtypes project the same geometry)."""
    *_, cam32 = preprocess_scene(8, 0)
    *_, cam64 = preprocess_scene(8, 0, dtype=torch.float64)
    for f in dataclasses.fields(cam32):
        a, b = getattr(cam32, f.name), getattr(cam64, f.name)
        if isinstance(a, torch.Tensor):
            assert b.dtype == torch.float64 and torch.equal(a.double(), b)


# the V-view cases: (views, K, active SH degree); the mask keeps the
# coefficients of the active degree, the SH sum runs at K's degree
VIEW_CASES = [(v, k, d) for v in (1, 3) for k in (16, 25)
              for d in range(round(k ** 0.5))]
VIEW_IDS = [f"views{v}-K{k}-active{d}" for v, k, d in VIEW_CASES]
# the views' camera positions (identity rotations: the edge cases of
# preprocess_arrays are placed for the first)
VIEW_POSITIONS = (np.zeros(3), np.asarray([0.1, 0.0, -0.2]),
                  np.asarray([-0.15, 0.05, 0.1]))


def view_inputs(case, n=65):
    """A V-view case: float32 arrays with the edge cases (Gaussians that
    are not valid, one at the first camera's centre), the mask, the
    degree, and the cameras in both packages."""
    views, k, active = case
    deg = round(k ** 0.5) - 1
    a = preprocess_arrays(n, 20 + 7 * views + k + active, sh_degree=deg,
                          coeffs=k, edge=True)
    arrs = {key: np.asarray(a[key], np.float32)
            for key in ("means", "scales", "rots", "opac", "feats")}
    cmask = np.asarray(np.arange(k) < (active + 1) ** 2, np.float32)
    jcams = [jmake_camera(a["R"], t, *a["fov"], a["w"], a["h"])
             for t in VIEW_POSITIONS[:views]]
    tcams = [tmake_camera(a["R"], t, *a["fov"], a["w"], a["h"], device="cpu")
             for t in VIEW_POSITIONS[:views]]
    return arrs, cmask, deg, jcams, tcams


def view_args(arrs, cmask, deg, tcams):
    """The V-view plain forward's arguments: the leaves and the mask."""
    t = lambda key: torch.as_tensor(arrs[key])
    feats = t("feats")
    return (t("means"), t("scales"), t("rots"), tcams, 1.0, t("opac"),
            feats[:, :1], feats[:, 1:], torch.as_tensor(cmask), deg)


@pytest.mark.parametrize("case", VIEW_CASES, ids=VIEW_IDS)
def test_views_plain_forward_matches_jax(case):
    """Each view of the V-view plain forward against the JAX projection and
    colours on concatenate(dc, rest) * mask, at the single-view test's
    tolerances; and bit for bit the one-view plain forward on the masked
    features."""
    arrs, cmask, deg, jcams, tcams = view_inputs(case)
    args = view_args(arrs, cmask, deg, tcams)
    out = pre.preprocess_forward_plain(*args)
    assert len(out) == len(tcams)
    j = lambda key: jnp.asarray(arrs[key])
    jfeats = j("feats") * jnp.asarray(cmask)[None, :, None]
    masked = pre.masked_features(args[6], args[7], args[8])
    for (proj, colors), jcam, tcam in zip(out, jcams, tcams):
        ref = jproject(j("means"), j("scales"), j("rots"), jcam,
                       opacities=j("opac"))
        valid = np.asarray(ref.valid)
        np.testing.assert_array_equal(proj.valid.numpy(), valid)
        assert 0 < valid.sum() < valid.size
        np.testing.assert_array_equal(proj.radius.numpy(),
                                      np.asarray(ref.radius))
        np.testing.assert_allclose(proj.mean2d.numpy()[valid],
                                   np.asarray(ref.mean2d)[valid], atol=1e-4)
        np.testing.assert_allclose(proj.conic.numpy()[valid],
                                   np.asarray(ref.conic)[valid], atol=1e-5,
                                   rtol=1e-5)
        jc = np.asarray(jcolors(deg, jfeats, j("means"), jcam.camera_center))
        np.testing.assert_allclose(colors.numpy(), jc, atol=1e-5)
        one, one_c = forward1(*args[:3], tcam, 1.0, args[5], masked, deg)
        for a, b in zip((*proj, colors), (*one, one_c)):
            assert_bits_equal(a, b)


@pytest.mark.parametrize("case", VIEW_CASES, ids=VIEW_IDS)
def test_views_plain_backward_matches_jax_vjp(case):
    """The V-view plain backward against ``jax.vjp`` of the JAX projection
    and colours on concatenate(dc, rest) * mask, summed over the views:
    the means, scales, quaternions and both leaves within 2e-4 of each
    gradient's max; exactly zero for a Gaussian valid in no view and for
    the coefficients the mask drops."""
    arrs, cmask, deg, jcams, tcams = view_inputs(case)
    args = view_args(arrs, cmask, deg, tcams)
    out = pre.preprocess_forward_plain(*args)
    valid = [proj.valid for proj, _ in out]
    cts = [cotangents(len(arrs["means"]), v.numpy(), 5 * k + case[2], True)
           for k, v in enumerate(valid)]
    got = pre.preprocess_backward_plain(
        *args[:4], valid, *([torch.as_tensor(c[i]) for c in cts]
                            for i in range(3)), 1.0, *args[6:])
    jmask = jnp.asarray(cmask)[None, :, None]
    opac = jnp.asarray(arrs["opac"])

    def f(m, s, q, dc, rest):
        feats = jnp.concatenate([dc, rest], axis=1) * jmask
        outs = ()
        for jcam in jcams:
            p = jproject(m, s, q, jcam, opacities=opac)
            outs += (p.mean2d, p.conic,
                     jcolors(deg, feats, m, jcam.camera_center))
        return outs

    feats = jnp.asarray(arrs["feats"])
    _, vjp = jax.vjp(f, *(jnp.asarray(arrs[k]) for k in ("means", "scales",
                                                         "rots")),
                     feats[:, :1], feats[:, 1:])
    want = vjp(tuple(jnp.asarray(c) for ct in cts for c in ct))
    names = ("means", "scales", "rotations", "features_dc", "features_rest")
    nowhere = ~np.any([v.numpy() for v in valid], axis=0)
    assert nowhere.any()
    for name, g, w in zip(names, got, want):
        assert_max_normalised(g.numpy(), np.asarray(w), 2e-4, name)
        assert (g.numpy()[nowhere] == 0).all(), name
    g_features = torch.cat(got[3:], dim=1).numpy()
    assert (g_features[:, cmask == 0] == 0).all()
    assert np.abs(g_features[:, cmask == 1]).max() > 0


@pytest.mark.parametrize("mode", ["event", "event_deblur", "rgb"])
def test_step_gradients_equal_the_per_render_path(mode):
    """The train step's loss and gradients (one preprocess call for its
    views, on the feature leaves and the mask) against the step as it was
    built before (``test_torch_kernels.per_render_loss_and_grads``), on the
    CPU at a mask of degree 2 of 3 and random higher-order features: the
    loss and each gradient (the six leaves, the contrast, the tap) bit for
    bit."""
    state, data, cap = step_state("cpu", 300, 64, 48)
    cmask = (torch.arange(16) < 9).float()
    loss, grads, want_loss, want, names = per_render_loss_and_grads(
        state, data, mode, cmask, cap)
    assert_bits_equal(loss, want_loss, "loss")
    got = [*grads["params"].values(), grads["contrast"], grads["tap"]]
    for name, g, w in zip(names, got, want):
        assert_bits_equal(g, w.contiguous(), name)
    assert float(got[2][:, 9:].abs().max()) == 0.0  # masked coefficients
    assert float(got[2].abs().max()) > 0.0


# the packed rows' cases: (views, active SH degree of the K = 16 mask)
PACKED_CASES = [(v, d) for v in (1, 2, 3) for d in range(4)]


@pytest.mark.parametrize("case", PACKED_CASES,
                         ids=[f"views{v}-active{d}" for v, d in PACKED_CASES])
def test_plain_packed_rows_equal_pack_features(case):
    """With ``packed``, each view's rows equal ``pack_features`` of the
    plain forward's own mean2d (the first view's with a non-zero tap
    added), conic, colours and opacities bit for bit, at 1 to 3 views and
    SH degrees 0-3 of a mask; the other outputs are the unpacked call's,
    and ``preprocess_views`` returns the same rows."""
    from event3dgs_tpu_torch.ops.rasterize_tiled import FEAT, pack_features

    views, active = case
    arrs, cmask, deg, _, tcams = view_inputs((3, 16, active))
    args = view_args(arrs, cmask, deg, tcams[:views])
    tap = seeded_tap(len(arrs["means"]), 40 + 4 * views + active, "cpu")
    packed = pre.preprocess_forward_plain(*args, mean2d_tap=tap, packed=True)
    unpacked = pre.preprocess_forward_plain(*args)
    opac = args[5]
    assert len(packed) == views
    for v, ((proj, colors, feat), (p0, c0)) in enumerate(zip(packed,
                                                             unpacked)):
        assert feat.shape == (len(opac), FEAT) and feat.is_contiguous()
        assert_bits_equal(feat, pack_features(proj.mean2d, proj.conic,
                                              colors, opac))
        assert_bits_equal(proj.mean2d, p0.mean2d + tap if v == 0
                          else p0.mean2d)
        for a, b in zip((*proj[1:], colors), (*p0[1:], c0)):
            assert_bits_equal(a, b)
    through = pre.preprocess_views(*args[:5], opacities=opac,
                                   features_dc=args[6], features_rest=args[7],
                                   cmask=args[8], sh_degree=deg,
                                   mean2d_tap=tap, packed=True)
    for (_, _, a), (_, _, b) in zip(through, packed):
        assert_bits_equal(a, b)


def test_no_packed_rows_without_colours():
    """Without features there are no colours and no packed rows: the entry
    holds None, the tiled rasterizer packs the override colours itself, and
    rows asked for without the opacities they hold are refused."""
    from event3dgs_tpu_torch.ops import rasterize_tiled as rt
    from event3dgs_tpu_torch.ops.render import render_depth

    means, scales, rots, opac, feats, cam = preprocess_scene(200, 12,
                                                             edge=True)
    cams = [cam, cam]
    out = pre.preprocess_views(means, scales, rots, cams, opacities=opac,
                               packed=True)
    assert [len(x) for x in out] == [3, 3]
    assert all(c is None and f is None for _, c, f in out)
    assert pre.preprocess(means, scales, rots, cam, opacities=opac,
                          packed=True)[1:] == (None, None)
    assert pre.preprocess_forward_plain(means, scales, rots, cams,
                                        packed=True)[0][2] is None
    with pytest.raises(ValueError, match="opacities"):
        pre.preprocess(means, scales, rots, cam, features=feats, sh_degree=3,
                       packed=True)
    with pytest.raises(ValueError, match="opacities"):
        pre.preprocess_forward_plain(means, scales, rots, cams, 1.0, None,
                                     feats[:, :1], feats[:, 1:], None, 3,
                                     packed=True)
    calls = []
    pack = rt.pack_features
    rt.pack_features = lambda *a: calls.append(1) or pack(*a)
    try:
        img = render_depth(means, opac, scales, rots, cam,
                           torch.zeros(3), rasterizer="tiled").image
    finally:
        rt.pack_features = pack
    assert calls == [1] and torch.isfinite(img).all()


def parent_partials(means, feats, opac, scales, rots, cam, tap, plain=False):
    """One view's (rgb, log T) as the render built them before the
    preprocess took the tap and wrote the packed rows: the tap added to
    the projected means, the rows packed by the tiled rasterizer."""
    from event3dgs_tpu_torch.ops.rasterize_tiled import (
        rasterize_tiled_partials,
    )

    proj, colors = pre.preprocess(means, scales, rots, cam, opacities=opac,
                                  features=feats, sh_degree=3, plain=plain)
    proj = proj._replace(mean2d=proj.mean2d + tap)
    return rasterize_tiled_partials(proj, colors, opac, cam.width,
                                    cam.height, plain=plain)


def test_nonzero_tap_matches_the_add():
    """A non-zero mean2d tap through the render (the preprocess adds it
    and packs the rows) gives the image and the gradients of the tap and
    of the five Gaussian inputs that the add before the rasterizer gave,
    bit for bit, on the CPU."""
    from event3dgs_tpu_torch.ops.render import render_partials

    s = render_scene(seed=11, n=90)
    tcam = tmake_camera(np.eye(3), np.asarray([0.05, 0.0, -0.1]), 1.0, 0.8,
                        s["w"], s["h"], device="cpu")
    wgt = torch.as_tensor(s["wgt"])
    out = {}
    for how in ("preprocess", "add"):
        leaves = [torch.tensor(s[k], requires_grad=True) for k in ARGS]
        tap = seeded_tap(90, 5, "cpu").requires_grad_(True)
        m, f, o, sc, q = leaves
        if how == "preprocess":
            p = render_partials(m, f, o, sc, q, tcam, sh_degree=3,
                                mean2d_tap=tap, rasterizer="tiled")
            rgb, logt = p.rgb, p.logt
        else:
            rgb, logt = parent_partials(m, f, o, sc, q, tcam, tap)
        loss = (rgb * wgt).sum() + logt.sum()
        out[how] = (rgb, logt, *torch.autograd.grad(loss, [*leaves, tap]))
    assert float(out["add"][-1].abs().max()) > 0
    names = ("rgb", "logt", *ARGS, "tap")
    for name, a, b in zip(names, out["preprocess"], out["add"]):
        assert_bits_equal(a.detach(), b.detach(), name)


@pytest.mark.parametrize("mode", ["event", "event_deblur", "rgb"])
def test_step_gradients_equal_the_parent_add_and_pack(mode):
    """The train step (the preprocess taking the tap and writing the
    packed rows) against the per-render step as it was built before, each
    view rendered with the tap added to its projected means and its rows
    packed by the rasterizer, on the CPU: the loss and each gradient (the
    six leaves, the contrast, the tap) bit for bit."""
    state, data, cap = step_state("cpu", 300, 64, 48)
    cmask = (torch.arange(16) < 9).float()
    loss, grads, want_loss, want, names = per_render_loss_and_grads(
        state, data, mode, cmask, cap, parent=True)
    assert_bits_equal(loss, want_loss, "loss")
    got = [*grads["params"].values(), grads["contrast"], grads["tap"]]
    for name, g, w in zip(names, got, want):
        assert_bits_equal(g, w.contiguous(), name)
    # (the event mode's main view takes no gradient on these random
    # images: per_render_loss_and_grads)
    assert (float(got[-1].abs().max()) > 0.0) == (mode != "event")
