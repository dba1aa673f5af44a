"""``pipeline.fused_steps`` in the port against the JAX package, on the CPU.

- The port's fused loop (8 steps a chunk) against the JAX package's fused
  loop (one ``lax.scan`` a chunk) from the same state: rgb mode, the
  oracle rasterizer, 25 iterations, as ``tests/test_train_slice.py``'s
  ``test_fused_loop_matches_per_step``, at its tolerances (losses rtol
  2e-5 / atol 1e-6; xyz, opacity and scaling atol 3e-3).
- The port's fused loop against its per-step loop in event mode on the
  tiled rasterizer's plain path, with a chunk ending on a densify
  iteration, a densify that fits the capacity and one that grows it.
- :class:`GraphTrainStep` against ``make_train_step`` field by field,
  across the iteration where the SH degree steps up, with a black and a
  random background.
- :func:`next_event` against the chunk planner of the JAX loop.
- The reference rasterizer's capture-safe compositing (its chunk products
  take no host read in their backward, each chunk is recomputed in the
  backward pass): the products' gradients equal PyTorch's own, the
  oracle's gradients over several chunks match the JAX oracle's, and the
  port's fused event loop on it matches the JAX fused loop.

On the CPU the fused loop runs the graph-ready step eagerly through the
same row table that a CUDA graph replays on a card
(``tests/test_torch_kernels.py`` holds the graph against the eager loop
there).
"""

import dataclasses
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import event3dgs_tpu.train.loop as jloop
from event3dgs_tpu.ops.projection import ProjectedGaussians as JProjected
from event3dgs_tpu.ops.rasterize_reference import (
    rasterize_reference_partials as jref_partials,
)
from event3dgs_tpu.train import train_loop as jtrain_loop
from event3dgs_tpu.utils.config import OptimizationConfig as JOptCfg
from event3dgs_tpu.utils.config import TrainConfig as JTrainConfig
from event3dgs_tpu_torch.ops.rasterize_reference import (
    NonzeroCumprod,
    NonzeroProd,
    rasterize_reference_partials,
)
from event3dgs_tpu_torch.ops.projection import ProjectedGaussians
from event3dgs_tpu_torch.train import make_train_step, train_loop
from event3dgs_tpu_torch.train.fused import FusedSteps
from event3dgs_tpu_torch.train import loop as tloop
from event3dgs_tpu_torch.train.loop import (
    INSTANCE_RECHECK_INTERVAL,
    TrainCallbacks,
    next_event,
    opacity_reset_interval,
    probe_instance_count,
)
from event3dgs_tpu_torch.train.step import GraphTrainStep
from event3dgs_tpu_torch.utils import trace
from event3dgs_tpu_torch.utils.config import OptimizationConfig, TrainConfig
from test_torch_train import PARAM_FIELDS, scene, scene_data, states  # noqa: F401

LOSS_TOL = dict(rtol=2e-5, atol=1e-6)  # the JAX fused-loop test's
PARAM_ATOL = 3e-3  # its parameter tolerance (Adam-amplified f32 noise)


def test_fused_loop_matches_jax_fused_loop(scene):
    js, ts = states(scene, seed=21)
    jd, td = scene_data(scene)
    kw = dict(densify_from_iter=10_000, densify_until_iter=0)
    jcfg = JTrainConfig(optimization=JOptCfg(**kw))
    jcfg.pipeline.rasterizer = "reference"
    jcfg.pipeline.fused_steps = 8
    tcfg = TrainConfig(optimization=OptimizationConfig(**kw))
    tcfg.pipeline.rasterizer = "reference"
    tcfg.pipeline.fused_steps = 8
    before = ts.params.xyz.clone()
    jr = jtrain_loop(js, jd, jcfg, "rgb", scene.extent, iterations=25)
    tr = train_loop(ts, td, tcfg, "rgb", scene.extent, iterations=25)
    assert len(tr.history) == len(jr.history) == 25
    np.testing.assert_allclose(tr.history, jr.history, **LOSS_TOL)
    for f in ("xyz", "opacity", "scaling"):
        np.testing.assert_allclose(getattr(tr.state.params, f).numpy(),
                                   np.asarray(getattr(jr.state.params, f)),
                                   atol=PARAM_ATOL, err_msg=f)
    assert int(tr.state.step) == int(jr.state.step) == 25
    assert torch.equal(ts.params.xyz, before)  # the caller's state


def test_fused_loop_matches_per_step_loop_across_densify_and_growth(scene):
    """Chunks of 8 end on the densify iterations 5 and 10: the first
    densify fits the 128 slots (its state is copied into the fused steps'
    buffers), the second grows them (new buffers)."""
    _, ts = states(scene, seed=22)
    _, td = scene_data(scene)
    opt = OptimizationConfig(densify_from_iter=2, densification_interval=5,
                             densify_until_iter=100,
                             densify_grad_threshold=0.0)
    runs = {}
    for fused in (1, 8):
        cfg = TrainConfig(optimization=opt)
        cfg.pipeline.rasterizer = "tiled"
        cfg.pipeline.fused_steps = fused
        events = []
        cb = TrainCallbacks(
            on_metrics=lambda it, m: events.append((it, sorted(m))),
            log_every=10)
        runs[fused] = train_loop(ts, td, cfg, "event", scene.extent,
                                 iterations=12, callbacks=cb), events
    (r1, e1), (r8, e8) = runs[1], runs[8]
    assert r8.state.params.capacity == r1.state.params.capacity > 128
    assert e8 == e1  # the same densify, capacity, cap and log events
    assert [it for it, m in e1 if m == ["num_alive"]] == [5, 10]
    np.testing.assert_allclose(r8.history, r1.history, **LOSS_TOL)
    for f in PARAM_FIELDS + ("alive",):
        np.testing.assert_allclose(
            getattr(r8.state.params, f).numpy().astype(np.float64),
            getattr(r1.state.params, f).numpy().astype(np.float64),
            atol=PARAM_ATOL, err_msg=f)
    np.testing.assert_allclose(r8.state.contrast.numpy(),
                               r1.state.contrast.numpy(), **LOSS_TOL)
    assert int(r8.state.step) == int(r1.state.step) == 12


def assert_trees_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_trees_equal(getattr(a, f.name), getattr(b, f.name),
                               f"{path}.{f.name}")
    else:
        assert a == b, path


@pytest.mark.parametrize("background", ["black", "random"])
def test_graph_step_matches_train_step_across_sh_degree_step(scene,
                                                             background):
    """From state.step 998 the rows are iterations 999, 1000 (SH degree
    0 → 1) and 1001: one step a run, then the three as one chunk."""
    _, ts = states(scene, seed=23)
    _, td = scene_data(scene)
    ts = ts.replace(step=torch.tensor(998, dtype=torch.int32))
    cfg = TrainConfig()
    kw = dict(spatial_lr_scale=scene.extent, rasterizer="tiled")
    eager = make_train_step("event", cfg.optimization, cfg.event, **kw)
    graph = GraphTrainStep("event", cfg.optimization, cfg.event, **kw)
    rng = np.random.default_rng(5)
    views = [(3, 3, 4), (6, 6, 7), (4, 4, 5)]
    bgs = [rng.uniform(size=3) if background == "random" else np.zeros(3)
           for _ in views]
    rows = torch.from_numpy(np.stack([
        graph.row(999 + i, v, bg) for i, (v, bg) in enumerate(zip(views, bgs))
    ]))
    assert not torch.equal(rows[0, 7:], rows[1, 7:])  # the SH mask steps up

    one = FusedSteps(graph, ts, td, rows=1)
    state = ts
    for i, (v, bg) in enumerate(zip(views, bgs)):
        state, metrics = eager(state, td, *v,
                               torch.tensor(bg, dtype=torch.float32))
        (loss,) = one.run(rows[i:i + 1])
        assert loss == float(metrics["loss"])
        assert_trees_equal(one.state, state, f"step {i}")
        assert_trees_equal(one.slots.metrics, metrics, f"metrics {i}")
    chunk = FusedSteps(graph, ts, td, rows=3)
    losses = chunk.run(rows)
    assert losses[-1] == float(metrics["loss"])
    assert_trees_equal(chunk.state, state, "chunk")
    assert int(ts.step) == 998  # the caller's state


def children(records, parent):
    """The spans whose parent is ``parent`` (-1: the top), by start."""
    return sorted((r for r in records if r[1] == parent), key=lambda r: r[3])


class Bare:
    """A span that records and counts nothing: the loop as it runs without
    its spans."""

    n, ms = -1, 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_fused_loop_spans_and_host_syncs(scene, monkeypatch):
    """The fused loop (8 steps a chunk, the tiled rasterizer, a log tick and
    an instance-cap re-measure every 10 iterations) records a span at each
    layer boundary, counts each host wait once, and computes the same bits
    as with its spans replaced by ones that do nothing."""
    monkeypatch.setattr(tloop, "INSTANCE_RECHECK_INTERVAL", 10)
    _, ts = states(scene, seed=25)
    _, td = scene_data(scene)
    runs = {}
    for bare in (False, True):
        cfg = TrainConfig(optimization=OptimizationConfig(densify_until_iter=0))
        cfg.pipeline.rasterizer = "tiled"
        cfg.pipeline.fused_steps = 8
        ticks = []
        cb = TrainCallbacks(
            on_metrics=lambda it, m: ticks.append((it, len(m))) if "loss" in m else None,
            log_every=10)
        trace.clear()
        syncs, probes = trace.host_syncs, probe_instance_count.calls
        with monkeypatch.context() as m:
            if bare:
                m.setattr(trace, "span", lambda name, n=None: Bare())
                m.setattr(trace, "synced", lambda what: Bare())
            result = train_loop(ts, td, cfg, "event", scene.extent,
                                iterations=20, callbacks=cb)
        runs[bare] = (result, trace.spans(), trace.host_syncs - syncs,
                      probe_instance_count.calls - probes, ticks)
        trace.clear()

    (r_on, recs, syncs, probes, ticks), (r_bare, bare_recs, _, _, _) = \
        runs[False], runs[True]
    assert bare_recs == []
    assert r_on.history == r_bare.history and len(r_on.history) == 20
    assert_trees_equal(r_on.state, r_bare.state, "state")

    top = children(recs, -1)
    assert [r[2] for r in top] == ["train.prologue"] + 2 * [
        "train.chunk", "train.chunk", "train.log", "train.remeasure"]
    n_views = td.cameras.camera_center.shape[0]
    per_cap = len(range(0, n_views, max(1, n_views // 8)))
    assert probes == 3 * per_cap  # the prologue's and two re-measures
    for r in (top[0], top[4], top[8]):  # the prologue and the re-measures
        caps = [c for c in children(recs, r[0]) if c[2] == "train.instance_cap"]
        assert len(caps) == 1
        assert [c[2] for c in children(recs, caps[0][0])] == ["train.probe"] * per_cap
    assert "train.build_step" in [c[2] for c in children(recs, top[0][0])]
    chunks = [r for r in top if r[2] == "train.chunk"]
    assert [c[5] for c in chunks] == [8, 2, 8, 2]
    for c in chunks:
        inner = children(recs, c[0])
        assert [r[2] for r in inner] == ["train.rows", "fused.get", "fused.upload",
                                         "fused.launch", "fused.readback"]
        assert inner[3][5] == c[5]  # the launch's replays
        assert all(c[3] <= r[3] <= r[4] <= c[4] for r in inner)
    logs = [r for r in top if r[2] == "train.log"]
    assert [it for it, _ in ticks] == [10, 20]
    for log, (_, n_metrics) in zip(logs, ticks):
        assert [r[2] for r in children(recs, log[0])] == ["train.metric"] * n_metrics
    # every host wait once: the probes, an upload and a readback a chunk, a
    # read a metric
    assert syncs == probes + 2 * len(chunks) + sum(n for _, n in ticks)


def jax_next_event(iters, cfg, mode, log_every):
    """The JAX loop's chunk planner (a closure inside its ``train_loop``),
    taken from its source and bound to the values it closes over."""
    src = inspect.getsource(jloop.train_loop)
    start = src.index("    def next_event(")
    body = textwrap.dedent(src[start:src.index("\n    def ", start + 1)])
    callbacks = TrainCallbacks(log_every=log_every)
    env = dict(iters=iters, callbacks=callbacks, opt=cfg.optimization,
               opacity_reset_interval=opacity_reset_interval(cfg, mode),
               INSTANCE_RECHECK_INTERVAL=jloop.INSTANCE_RECHECK_INTERVAL,
               cfg=cfg)
    exec(body, env)
    return env["next_event"]


@pytest.mark.parametrize("mode,saves", [("event", ()),
                                        ("rgb", (7_000, 30_000))])
def test_next_event_matches_jax_chunk_planner(mode, saves):
    cfg = TrainConfig(save_iterations=saves, test_iterations=saves,
                      checkpoint_iterations=saves[:1])
    iters = cfg.optimization.iterations
    assert INSTANCE_RECHECK_INTERVAL == jloop.INSTANCE_RECHECK_INTERVAL
    plan = jax_next_event(iters, cfg, mode, 10)
    got = [next_event(i, iters, cfg, mode, 10) for i in range(1, iters + 1)]
    want = [plan(i) for i in range(1, iters + 1)]
    assert got == want
    # chunks of 8 over the run end on every log tick and densify iteration
    it, ends = 0, []
    while it < iters:
        it += min(8, next_event(it + 1, iters, cfg, mode, 10) - it)
        ends.append(it)
    assert set(range(10, iters + 1, 10)) <= set(ends)
    assert {cfg.optimization.densify_from_iter, 600, 15_000} <= set(ends)
    assert all(b - a <= 8 for a, b in zip([0] + ends, ends))


@pytest.mark.parametrize("fn", ["cumprod", "prod"])
def test_reference_chunk_products_take_pytorchs_gradients(fn):
    """The oracle's products over 1 - α (never 0: α ≤ 0.99) give PyTorch's
    own gradients bit for bit: its backward takes the same formula when no
    input is zero, after reading that on the host."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(0.01, 1.0, (64, 33)), dtype=torch.float32)
    up = torch.tensor(rng.normal(size=(64, 33) if fn == "cumprod" else 64),
                      dtype=torch.float32)
    ours = {"cumprod": NonzeroCumprod, "prod": NonzeroProd}[fn]
    stock = {"cumprod": lambda t: torch.cumprod(t, dim=1),
             "prod": lambda t: torch.prod(t, dim=1)}[fn]
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    out_a, out_b = ours.apply(a), stock(b)
    assert torch.equal(out_a, out_b)
    (ga,) = torch.autograd.grad(out_a, a, up)
    (gb,) = torch.autograd.grad(out_b, b, up)
    assert torch.equal(ga, gb)


def test_reference_oracle_gradients_match_jax_across_chunks():
    """The oracle's partials and their gradients (colors, opacities, means,
    conics) against the JAX oracle's with chunks of 16 over 90 Gaussians,
    so each chunk is recomputed in the backward pass and carries the next
    chunk's start: images at the JAX suite's atol 2e-5 / rtol 1e-4,
    gradients at its max-normalised atol 2e-4."""
    rng = np.random.default_rng(8)
    n, w, h = 90, 40, 36
    mean2d = rng.uniform([-4, -4], [w + 4, h + 4], (n, 2)).astype(np.float32)
    sig = rng.uniform(1.0, 6.0, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    cov = np.stack([sig[:, 0] ** 2, rho * sig[:, 0] * sig[:, 1],
                    sig[:, 1] ** 2], 1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    conic = np.stack([cov[:, 2], -cov[:, 1], cov[:, 0]], 1) / det[:, None]
    depth = rng.uniform(1.0, 5.0, n).astype(np.float32)
    radius = (3.0 * sig.max(1)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.99, n).astype(np.float32)
    up_rgb = rng.normal(size=(h, w, 3)).astype(np.float32)
    up_logt = rng.normal(size=(h, w)).astype(np.float32)
    conic = conic.astype(np.float32)

    def jloss(m2d, con, col, opa):
        proj = JProjected(mean2d=m2d, depth=jnp.asarray(depth), conic=con,
                          radius=jnp.asarray(radius), valid=jnp.asarray(valid))
        rgb, logt = jref_partials(proj, col, opa, w, h, chunk=16)
        return jnp.sum(rgb * up_rgb) + jnp.sum(logt * up_logt), (rgb, logt)

    jgrads, (jrgb, jlogt) = jax.grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (mean2d, conic, colors, opac)))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (mean2d, conic, colors, opac)]
    proj = ProjectedGaussians(mean2d=leaves[0], depth=torch.tensor(depth),
                              conic=leaves[1], radius=torch.tensor(radius),
                              valid=torch.tensor(valid))
    rgb, logt = rasterize_reference_partials(proj, leaves[2], leaves[3], w,
                                             h, chunk=16)
    loss = (rgb * torch.tensor(up_rgb)).sum() + (logt * torch.tensor(up_logt)).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(np.exp(logt.detach().numpy()),
                               np.exp(np.asarray(jlogt)), atol=2e-6)
    for name, t, j in zip(("mean2d", "conic", "colors", "opacity"), tgrads,
                          jgrads):
        j = np.asarray(j)
        scale = max(np.abs(j).max(), 1e-12)
        np.testing.assert_allclose(t.numpy() / scale, j / scale, atol=2e-4,
                                   err_msg=name)


def test_event_fused_loop_on_the_reference_rasterizer_matches_jax(scene):
    """The capture-safe oracle in the port's fused event loop (8 steps a
    chunk) against the JAX package's fused event loop: 12 iterations at
    the fused-loop tolerances."""
    js, ts = states(scene, seed=24)
    jd, td = scene_data(scene)
    kw = dict(densify_from_iter=10_000, densify_until_iter=0)
    jcfg = JTrainConfig(optimization=JOptCfg(**kw))
    tcfg = TrainConfig(optimization=OptimizationConfig(**kw))
    for cfg in (jcfg, tcfg):
        cfg.pipeline.rasterizer = "reference"
        cfg.pipeline.fused_steps = 8
    jr = jtrain_loop(js, jd, jcfg, "event", scene.extent, iterations=12)
    tr = train_loop(ts, td, tcfg, "event", scene.extent, iterations=12)
    np.testing.assert_allclose(tr.history, jr.history, **LOSS_TOL)
    for f in ("xyz", "opacity", "scaling"):
        np.testing.assert_allclose(getattr(tr.state.params, f).numpy(),
                                   np.asarray(getattr(jr.state.params, f)),
                                   atol=PARAM_ATOL, err_msg=f)
    np.testing.assert_allclose(tr.state.contrast.numpy(),
                               np.asarray(jr.state.contrast), **LOSS_TOL)
