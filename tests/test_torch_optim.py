"""The port's optimizer, schedules, Gaussian init and density control against
the JAX package's, on the CPU at 1e-6; densification is fed the same
``jax.random.normal`` split samples on both sides.  The Adam update's
in-place form, its grouped form and the graph-ready step's in-place update
against the out-of-place ones, bit for bit (``tests/test_torch_kernels.py``
holds the Adam kernel against the plain update on a card)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event3dgs_tpu.core as jcore
from event3dgs_tpu.core.schedules import exponential_lr as jlr
from event3dgs_tpu.models import densify as jdensify
from event3dgs_tpu.models import gaussians as jgauss
from event3dgs_tpu.models import optimizer as jopt
from event3dgs_tpu.train import state as jstate
import event3dgs_tpu_torch.core as tcore
from event3dgs_tpu_torch.core.schedules import exponential_lr as tlr
from event3dgs_tpu_torch.models import densify as tdensify
from event3dgs_tpu_torch.models import gaussians as tgauss
from event3dgs_tpu_torch.models import optimizer as topt
from event3dgs_tpu_torch.train import make_train_step
from event3dgs_tpu_torch.train import state as tstate
from event3dgs_tpu_torch.train.fused import FusedSteps
from event3dgs_tpu_torch.train.step import GraphTrainStep
from event3dgs_tpu_torch.utils.config import TrainConfig
from test_torch_fused import assert_trees_equal
from test_torch_train import scene, scene_data, states  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-6


def close(t, j, atol=TOL, rtol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(t, np.float64),
                               np.asarray(j, np.float64), atol=atol, rtol=rtol,
                               err_msg=msg)


def to_port(jp):
    return tgauss.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgauss.FIELDS}, device="cpu")


def assert_params_match(tp, jp, atol=TOL):
    for f in tgauss.FIELDS:
        close(getattr(tp, f).numpy(), getattr(jp, f), atol=atol, msg=f)


def model(seed=0, n=50, capacity=64):
    """JAX params with random rotations, opacities and anisotropic scales,
    and the same params in the port."""
    rng = np.random.default_rng(seed)
    jp = jgauss.init_from_point_cloud(rng.uniform(-1, 1, (n, 3)),
                                      rng.uniform(0, 1, (n, 3)), capacity)
    jp = jp.replace(
        rotation=jnp.asarray(rng.normal(size=(capacity, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(0, 2, (capacity, 1)), jnp.float32),
        scaling=jnp.asarray(np.asarray(jp.scaling)
                            + rng.uniform(-1.5, 1.5, (capacity, 3)), jnp.float32),
    )
    return jp, to_port(jp)


@pytest.mark.parametrize("step", [-1, 0, 1, 7, 1000, 29_999, 40_000])
@pytest.mark.parametrize("delay", [0, 100])
def test_exponential_lr_matches(step, delay):
    kw = dict(lr_delay_steps=delay, lr_delay_mult=0.01, max_steps=30_000)
    j = float(jlr(step, 1.6e-4 * 3.1, 1.6e-6 * 3.1, **kw))
    t = tlr(step, 1.6e-4 * 3.1, 1.6e-6 * 3.1, **kw)
    assert isinstance(t, float)
    assert t == pytest.approx(j, rel=TOL, abs=0)
    assert tlr(step, 0.0, 0.0) == float(jlr(step, 0.0, 0.0)) == 0.0


def test_quat_to_rotmat_and_inverse_sigmoid_match():
    q = np.random.default_rng(1).normal(size=(20, 4)).astype(np.float32)
    close(tcore.quat_to_rotmat(torch.tensor(q)).numpy(),
          jcore.quat_to_rotmat(jnp.asarray(q)))
    x = np.float32([0.01, 0.1, 0.5, 0.93])
    close(tcore.inverse_sigmoid(torch.tensor(x)).numpy(), jcore.inverse_sigmoid(x))
    close(tcore.inverse_sigmoid(0.1), jcore.inverse_sigmoid(0.1))


def test_adam_matches_over_steps():
    """Dict params at per-leaf rates and a scalar (the contrast), five steps
    with a shared count."""
    rng = np.random.default_rng(2)
    shapes = {"a": (7, 3), "b": (5, 1, 3), "c": ()}
    jp = {k: jnp.asarray(rng.normal(size=s), jnp.float32) for k, s in shapes.items()}
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    js, ts = jopt.adam_init(jp), topt.adam_init(tp)
    lrs = {"a": 1.6e-4, "b": 0.0025, "c": 0.1}
    jc, tc = jnp.asarray(0.17, jnp.float32), torch.tensor(0.17)
    jcs, tcs = jopt.adam_init(jc), topt.adam_init(tc)
    for i in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** -i
                 for k, s in shapes.items()}
        jp, js = jopt.adam_update(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                                  js, lrs)
        tp, ts = topt.adam_update(tp, {k: torch.tensor(v) for k, v in grads.items()},
                                  ts, lrs)
        g = np.float32(rng.normal())
        jc, jcs = jopt.adam_update(jc, jnp.asarray(g), jcs, 0.1)
        tc, tcs = topt.adam_update(tc, torch.tensor(g), tcs, 0.1)
    for k in shapes:
        close(tp[k].numpy(), jp[k], msg=k)
        close(ts.mu[k].numpy(), js.mu[k], msg=k)
        close(ts.nu[k].numpy(), js.nu[k], msg=k)
    close(tc.numpy(), jc)
    assert int(ts.count) == int(js.count) == int(tcs.count) == 5


# the train state's trainable leaves (trailing shapes at SH degree 3) and
# learning rates (train/step._lr_tree's at iteration 1, spatial scale 3)
LEAF_SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
               "scaling": (3,), "rotation": (4,), "opacity": (1,)}
LEAF_LRS = {"xyz": 1.6e-4 * 3.0, "features_dc": 0.0025,
            "features_rest": 0.0025 / 20.0, "opacity": 0.05,
            "scaling": 0.005, "rotation": 0.001}


def leaf_grads(rng, c, scale=1.0):
    """Numpy gradients of the six leaves at capacity ``c``, and the port's
    with the feature gradients as autograd gives them: slices of one
    [C, 16, 3] gradient (of a ``cat`` of the two feature leaves)."""
    g = {k: (rng.normal(size=(c, *s)) * scale).astype(np.float32)
         for k, s in LEAF_SHAPES.items()}
    dc = torch.zeros(c, 1, 3, requires_grad=True)
    rest = torch.zeros(c, 15, 3, requires_grad=True)
    w = torch.tensor(np.concatenate([g["features_dc"], g["features_rest"]], 1))
    tg = {k: torch.tensor(v) for k, v in g.items()}
    tg["features_dc"], tg["features_rest"] = torch.autograd.grad(
        (torch.cat([dc, rest], 1) * w).sum(), [dc, rest])
    return g, tg


def train_groups(rng, c=37):
    """The port's two Adam groups of a train step at capacity ``c``, with
    seeded parameters and moments (the position rate a one-element tensor,
    as ``GraphTrainStep`` reads it), and the same values in numpy."""
    p = {k: rng.normal(size=(c, *s)).astype(np.float32)
         for k, s in LEAF_SHAPES.items()}
    mu = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
          for k, v in p.items()}
    nu = {k: v ** 2 for k, v in mu.items()}
    g, tg = leaf_grads(rng, c)
    lrs = dict(LEAF_LRS, xyz=torch.tensor([LEAF_LRS["xyz"]]))
    t = lambda tree: {k: torch.tensor(v) for k, v in tree.items()}
    state = topt.AdamState(t(mu), t(nu), torch.tensor(4, dtype=torch.int32))
    contrast = topt.AdamGroup(
        torch.tensor(0.17), torch.tensor(-3e-4),
        topt.AdamState(torch.tensor(1e-4), torch.tensor(2e-8),
                       torch.tensor(4, dtype=torch.int32)), 0.001)
    return [topt.AdamGroup(t(p), tg, state, lrs), contrast], (p, mu, nu, g)


def test_adam_matches_jax_at_the_train_state_leaves():
    """The six leaves at their shapes and rates with the feature gradients
    as strided slices, and the contrast, updated by one grouped call a step
    for five steps, against the JAX package's update of each."""
    rng = np.random.default_rng(12)
    c = 41
    jp = {k: jnp.asarray(rng.normal(size=(c, *s)), jnp.float32)
          for k, s in LEAF_SHAPES.items()}
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    js, ts = jopt.adam_init(jp), topt.adam_init(tp)
    jc, tc = jnp.asarray(0.17, jnp.float32), torch.tensor(0.17)
    jcs, tcs = jopt.adam_init(jc), topt.adam_init(tc)
    tlrs = dict(LEAF_LRS, xyz=torch.tensor([LEAF_LRS["xyz"]]))
    for i in range(5):
        g, tg = leaf_grads(rng, c, 10.0 ** -i)
        assert not tg["features_rest"].is_contiguous()
        assert tg["features_rest"].stride(0) == 48
        gc = np.float32(rng.normal())
        jp, js = jopt.adam_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, LEAF_LRS)
        jc, jcs = jopt.adam_update(jc, jnp.asarray(gc), jcs, 0.001)
        (tp, ts), (tc, tcs) = topt.adam_update_groups(
            [(tp, tg, ts, tlrs), (tc, torch.tensor(gc), tcs, 0.001)])
    for k in LEAF_SHAPES:
        assert tp[k].shape == tuple(jp[k].shape)
        close(tp[k].numpy(), jp[k], msg=k)
        close(ts.mu[k].numpy(), js.mu[k], msg=k)
        close(ts.nu[k].numpy(), js.nu[k], msg=k)
    close(tc.numpy(), jc)
    close(tcs.nu.numpy(), jcs.nu)
    assert int(ts.count) == int(tcs.count) == int(js.count) == 5


def test_adam_in_place_equals_out_of_place():
    """Written into the groups' own tensors, the update keeps their
    addresses and equals the out-of-place update bit for bit, the counts
    too, over three steps."""
    groups, _ = train_groups(np.random.default_rng(13))
    clone = lambda t: ({k: v.clone() for k, v in t.items()}
                       if isinstance(t, dict) else t.clone())
    live = [topt.AdamGroup(clone(g.params), g.grads, topt.AdamState(
        clone(g.state.mu), clone(g.state.nu), g.state.count.clone()), g.lr)
        for g in groups]
    out = [(g.params, g.state) for g in live]
    tensors = lambda res: [t for p, s in res
                           for tree in (p, s.mu, s.nu, s.count)
                           for t in topt.leaves(tree)]
    ptrs = [t.data_ptr() for t in tensors(out)]
    for _ in range(3):
        want = topt.adam_update_groups(groups)
        got = topt.adam_update_groups(live, out=out)
        assert [t.data_ptr() for t in tensors(got)] == ptrs
        for a, b in zip(tensors(got), tensors(want), strict=True):
            assert torch.equal(a, b)
        groups = [topt.AdamGroup(p, g.grads, s, g.lr)
                  for (p, s), g in zip(want, groups)]
    assert int(live[0].state.count) == int(live[1].state.count) == 7


def test_adam_out_of_place_leaves_its_inputs():
    """The out-of-place update returns new tensors and changes none of its
    inputs: parameters, gradients, moments, counts and the rate tensor."""
    groups, (p, mu, nu, g) = train_groups(np.random.default_rng(14))
    before = [t.clone() for grp in groups for tree in grp[:3] + (
        grp.state.mu, grp.state.nu, grp.state.count)
        if not isinstance(tree, topt.AdamState)
        for t in topt.leaves(tree)] + [groups[0].lr["xyz"].clone()]
    new = topt.adam_update_groups(groups)
    after = [t for grp in groups for tree in grp[:3] + (
        grp.state.mu, grp.state.nu, grp.state.count)
        if not isinstance(tree, topt.AdamState)
        for t in topt.leaves(tree)] + [groups[0].lr["xyz"]]
    for a, b in zip(after, before, strict=True):
        assert torch.equal(a, b)
    for k in LEAF_SHAPES:
        np.testing.assert_array_equal(groups[0].params[k].numpy(), p[k])
        np.testing.assert_array_equal(groups[0].state.nu[k].numpy(), nu[k])
        assert new[0][0][k].data_ptr() != groups[0].params[k].data_ptr()
        assert not torch.equal(new[0][0][k], groups[0].params[k])
    assert int(groups[0].state.count) == 4 and int(new[0][1].count) == 5


def test_grad_rows_reads_the_feature_slices_where_they_lie():
    """The kernel's view of a gradient (``grad_rows``): the feature slices
    uncopied, 3 and 45 floats a row 48 apart, each float found at row ·
    stride + column; a 0-d, a one-row and a transposed gradient."""
    import ctypes

    _, tg = leaf_grads(np.random.default_rng(15), 9)
    for k, width in (("features_dc", 3), ("features_rest", 45),
                     ("xyz", 3), ("opacity", 1)):
        g = tg[k]
        read, w, stride = topt.grad_rows(g, g.shape)
        assert read.data_ptr() == g.data_ptr() and w == width
        assert stride == (48 if k.startswith("features") else width)
        got = [ctypes.c_float.from_address(
            read.data_ptr() + 4 * ((e // w) * stride + e % w)).value
            for e in range(g.numel())]
        assert torch.equal(torch.tensor(got), g.reshape(-1))
    assert topt.grad_rows(torch.tensor(2.0), ())[1:] == (1, 1)
    assert topt.grad_rows(torch.ones(1, 4), (1, 4))[1:] == (4, 4)
    t = torch.ones(3, 5).t()
    read, w, stride = topt.grad_rows(t, (5, 3))
    assert read.is_contiguous() and (w, stride) == (3, 3)
    with pytest.raises(ValueError, match="shape"):
        topt.grad_rows(torch.ones(4, 3), (4, 4))


@pytest.mark.parametrize("mode", ["rgb", "gray", "event", "event_deblur"])
def test_graph_step_updates_adam_in_place_like_train_step(scene, mode,
                                                         monkeypatch):
    """``GraphTrainStep`` on the CPU writes the new parameters, contrast and
    moments into its state's own tensors (every address kept, none copied
    back after the update) and gives the state ``make_train_step`` gives,
    bit for bit, over three steps."""
    from event3dgs_tpu_torch.train import step as step_mod

    def pairs(dst, src):
        if isinstance(dst, torch.Tensor):
            return [(dst, src)]
        if isinstance(dst, dict):
            return [x for k in dst for x in pairs(dst[k], src[k])]
        return [x for f in dataclasses.fields(dst)
                for x in pairs(getattr(dst, f.name), getattr(src, f.name))]

    copied, copy_tree_ = [], step_mod.copy_tree_

    def recorded(dst, src):
        copied.extend(d.data_ptr() for d, s in pairs(dst, src) if d is not s)
        copy_tree_(dst, src)

    monkeypatch.setattr(step_mod, "copy_tree_", recorded)
    _, ts = states(scene, seed=25)
    _, td = scene_data(scene)
    if mode == "event_deblur":  # blurry captures that differ from the views
        td = td._replace(blurry_images=td.images.flip(0).contiguous())
    cfg = TrainConfig()
    kw = dict(spatial_lr_scale=scene.extent, rasterizer="tiled")
    eager = make_train_step(mode, cfg.optimization, cfg.event, **kw)
    graph = GraphTrainStep(mode, cfg.optimization, cfg.event, **kw)
    runner = FusedSteps(graph, ts, td, rows=1)

    def addresses(st):
        trees = (tgauss.trainable_dict(st.params), st.opt_state.mu,
                 st.opt_state.nu, st.contrast_opt.mu, st.contrast_opt.nu)
        return ([t.data_ptr() for tree in trees for t in topt.leaves(tree)]
                + [st.contrast.data_ptr(), st.opt_state.count.data_ptr(),
                   st.contrast_opt.count.data_ptr()])

    ptrs = addresses(runner.state)
    state = ts
    for i, v in enumerate([(3, 3, 4), (6, 6, 7), (4, 4, 5)]):
        state, metrics = eager(state, td, *v, torch.zeros(3))
        row = torch.from_numpy(graph.row(i + 1, v, np.zeros(3))[None])
        (loss,) = runner.run(row)
        assert loss == float(metrics["loss"])
        assert addresses(runner.state) == ptrs
        assert copied and not set(copied) & set(ptrs)  # the stats only
        assert_trees_equal(runner.state, state, f"step {i}")
    event = mode.startswith("event")
    assert int(runner.state.contrast_opt.count) == (3 if event else 0)
    assert int(ts.opt_state.count) == 0  # the caller's state


def test_update_stats_matches():
    rng = np.random.default_rng(3)
    c = 40
    grads = rng.normal(0, 1e-3, (c, 2)).astype(np.float32)
    radii = rng.uniform(0, 30, c).astype(np.float32)
    vis = rng.uniform(size=c) > 0.3
    js = jdensify.init_stats(c)
    ts = tdensify.init_stats(c)
    for _ in range(2):
        js = jdensify.update_stats(js, jnp.asarray(grads), jnp.asarray(radii),
                                   jnp.asarray(vis), grad_scale=(320.0, 240.0))
        ts = tdensify.update_stats(ts, torch.tensor(grads), torch.tensor(radii),
                                   torch.tensor(vis), grad_scale=(320.0, 240.0))
    for f in ("grad_accum", "denom", "max_radii2d"):
        close(getattr(ts, f).numpy(), getattr(js, f), msg=f)


def test_reset_opacity_matches():
    jp, tp = model(4)
    mu = {f: np.random.default_rng(4).normal(size=np.shape(getattr(jp, f)))
          .astype(np.float32) for f in tgauss.TRAINABLE_FIELDS}
    jo = jopt.AdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                        nu={k: jnp.asarray(v) ** 2 for k, v in mu.items()},
                        count=jnp.asarray(3, jnp.int32))
    to = topt.AdamState(mu={k: torch.tensor(v) for k, v in mu.items()},
                        nu={k: torch.tensor(v) ** 2 for k, v in mu.items()},
                        count=torch.tensor(3, dtype=torch.int32))
    jp2, jo2 = jdensify.reset_opacity(jp, jo)
    tp2, to2 = tdensify.reset_opacity(tp, to)
    assert_params_match(tp2, jp2)
    for k in mu:
        close(to2.mu[k].numpy(), jo2.mu[k], msg=k)
        close(to2.nu[k].numpy(), jo2.nu[k], msg=k)
    assert (to2.mu["opacity"] == 0).all()
    assert torch.equal(to2.mu["xyz"], to.mu["xyz"])


def test_init_from_point_cloud_matches():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-2, 2, (300, 3))
    cols = rng.uniform(0, 1, (300, 3))
    for cap, deg in ((512, 3), (200, 1)):
        jp = jgauss.init_from_point_cloud(pts, cols, cap, max_sh_degree=deg)
        tp = tgauss.init_from_point_cloud(pts, cols, cap, max_sh_degree=deg,
                                          device="cpu")
        assert_params_match(tp, jp)
    np.testing.assert_allclose(tgauss.mean_sq_dist_3nn(pts[:3]),
                               jgauss.mean_sq_dist_3nn(pts[:3]))


def test_grow_params_and_grow_state_match():
    jp, tp = model(6, n=30, capacity=32)
    assert_params_match(tgauss.grow_params(tp, 80), jgauss.grow_params(jp, 80))
    with pytest.raises(ValueError):
        tgauss.grow_params(tp, 32)
    js = jstate.init_train_state(jp, spatial_lr_scale=2.0)
    ts = tstate.init_train_state(tp, spatial_lr_scale=2.0)
    js = js.replace(stats=jdensify.DensifyStats(
        grad_accum=jnp.ones(32), denom=jnp.full(32, 2.0), max_radii2d=jnp.ones(32)))
    ts = ts.replace(stats=tdensify.DensifyStats(
        grad_accum=torch.ones(32), denom=torch.full((32,), 2.0),
        max_radii2d=torch.ones(32)))
    jg, tg = jstate.grow_state(js, 96), tstate.grow_state(ts, 96)
    assert_params_match(tg.params, jg.params)
    for f in ("grad_accum", "denom", "max_radii2d"):
        close(getattr(tg.stats, f).numpy(), getattr(jg.stats, f), msg=f)
    for k in tgauss.TRAINABLE_FIELDS:
        assert tg.opt_state.mu[k].shape == tuple(jg.opt_state.mu[k].shape)


@pytest.mark.parametrize("size_prune", [False, True])
@pytest.mark.parametrize("capacity", [128, 52])
def test_densify_and_prune_matches(size_prune, capacity):
    """Clone, split and prune with the same split samples; at capacity 52
    without the size prune the candidates outnumber the free slots and both
    drop the same ones."""
    jp, tp = model(7, n=50, capacity=capacity)
    rng = np.random.default_rng(7)
    grad_accum = rng.uniform(0, 6e-4, capacity).astype(np.float32)
    denom = rng.integers(0, 3, capacity).astype(np.float32)
    radii = rng.uniform(0, 40, capacity).astype(np.float32)
    js = jdensify.DensifyStats(jnp.asarray(grad_accum), jnp.asarray(denom),
                               jnp.asarray(radii))
    ts = tdensify.DensifyStats(torch.tensor(grad_accum), torch.tensor(denom),
                               torch.tensor(radii))
    mu = {f: rng.normal(size=np.shape(getattr(jp, f))).astype(np.float32)
          for f in tgauss.TRAINABLE_FIELDS}
    jo = jopt.AdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                        nu={k: jnp.asarray(v) ** 2 for k, v in mu.items()},
                        count=jnp.asarray(9, jnp.int32))
    to = topt.AdamState(mu={k: torch.tensor(v) for k, v in mu.items()},
                        nu={k: torch.tensor(v) ** 2 for k, v in mu.items()},
                        count=torch.tensor(9, dtype=torch.int32))
    key = jax.random.PRNGKey(3)
    normals = np.asarray(jax.random.normal(key, (2, capacity, 3)))
    kw = dict(grad_threshold=2e-4, min_opacity=0.005, extent=4.0,
              max_screen_size=20.0 if size_prune else 0.0, percent_dense=0.01)
    jr = jdensify.densify_and_prune(jp, jo, js, key, **kw)
    tr = tdensify.densify_and_prune(tp, to, ts, torch.tensor(normals), **kw)
    assert int(tr.overflow) == int(jr.overflow)
    np.testing.assert_array_equal(tr.params.alive.numpy(), np.asarray(jr.params.alive))
    assert_params_match(tr.params, jr.params)
    for k in mu:
        close(tr.opt_state.mu[k].numpy(), jr.opt_state.mu[k], msg=k)
        close(tr.opt_state.nu[k].numpy(), jr.opt_state.nu[k], msg=k)
    assert all((getattr(tr.stats, f.name) == 0).all()
               for f in dataclasses.fields(tdensify.DensifyStats))
    if capacity == 52 and not size_prune:
        assert int(tr.overflow) > 0


def test_train_state_helpers_match():
    for step, deg in ((0, 3), (999, 3), (1000, 3), (2500, 1), (9000, 3)):
        assert tstate.active_sh_degree(step, deg) == int(jstate.active_sh_degree(
            jnp.asarray(step), deg))
        np.testing.assert_array_equal(
            tstate.sh_coeff_mask(tstate.active_sh_degree(step, deg), 16).numpy(),
            np.asarray(jstate.sh_coeff_mask(jstate.active_sh_degree(
                jnp.asarray(step), deg), 16)))
    cams = [jcore.make_camera(np.eye(3), np.asarray([0.3 * i, 0.1, -0.2 * i]),
                              1.0, 0.8, 16, 16) for i in range(4)]
    tcams = [tcore.make_camera(np.eye(3), np.asarray([0.3 * i, 0.1, -0.2 * i]),
                               1.0, 0.8, 16, 16, device="cpu") for i in range(4)]
    assert tstate.nerfpp_extent(tcore.stack_cameras(tcams)) == pytest.approx(
        jstate.nerfpp_extent(jcore.stack_cameras(cams)), rel=1e-6)
