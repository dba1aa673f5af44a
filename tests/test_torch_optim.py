"""The port's optimizer, schedules, Gaussian init and density control against
the JAX package's, on the CPU at 1e-6; densification is fed the same
``jax.random.normal`` split samples on both sides."""

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
from event3dgs_tpu_torch.train import state as tstate

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
