"""The port's training slice against the JAX package's, on the CPU.

- The event step against the JAX step for 5 steps on
  ``make_synthetic_scene(60, 12, 64, 48)`` with the reference rasterizer on
  both sides (as tests/test_train_slice.py): losses, the contrast ``c``
  and every parameter within 1e-5 relative; one gray, one RGB and one
  event-deblur step; the port's tiled rasterizer (plain K1-K6) against its
  reference one for 3 steps.
- The training loop's view sequence and losses against the JAX loop.
- Checkpoints written by either package load in the other.
- ``cli.train --device cpu`` on a scene written by the port's
  ``tools/make_scene.synthesize_scene``, then ``cli.render --device cpu``
  on its PLY.

Each package gets its scene from its own ``make_synthetic_scene`` (the
same points and cameras; images within the render tolerance).

The parity states start from random rotations and anisotropic scales: at
the point-cloud init (identity rotations, isotropic scales) the rotation
gradient is exactly zero in exact arithmetic, so both packages compute
rounding noise there and Adam scales that noise to ±lr.
"""

import dataclasses
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.data.synthetic import make_synthetic_scene as jmake_scene
from event3dgs_tpu.models import init_from_point_cloud as jinit
from event3dgs_tpu.train import SceneData as JSceneData
from event3dgs_tpu.train import init_train_state as jinit_state
from event3dgs_tpu.train import make_train_step as jmake_step
from event3dgs_tpu.train import train_loop as jtrain_loop
from event3dgs_tpu.train.checkpoint import load_checkpoint as jload
from event3dgs_tpu.train.checkpoint import save_checkpoint as jsave
from event3dgs_tpu.utils.config import OptimizationConfig as JOptCfg
from event3dgs_tpu.utils.config import TrainConfig as JTrainConfig
from event3dgs_tpu_torch.data.synthetic import make_synthetic_scene as tmake_scene
from event3dgs_tpu_torch.models import init_from_point_cloud as tinit
from event3dgs_tpu_torch.train import SceneData as TSceneData
from event3dgs_tpu_torch.train import init_train_state as tinit_state
from event3dgs_tpu_torch.train import make_train_step as tmake_step
from event3dgs_tpu_torch.train import train_loop as ttrain_loop
from event3dgs_tpu_torch.train.checkpoint import load_checkpoint as tload
from event3dgs_tpu_torch.train.checkpoint import save_checkpoint as tsave
from event3dgs_tpu_torch.utils.config import OptimizationConfig as TOptCfg
from event3dgs_tpu_torch.utils.config import TrainConfig as TTrainConfig

torch.set_num_threads(1)

RTOL = 1e-5
PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity")


class Scenes(NamedTuple):
    """One synthetic scene as each package builds it."""

    jax: object
    port: object

    @property
    def points(self):
        return self.jax.points

    @property
    def colors(self):
        return self.jax.colors

    @property
    def extent(self):
        return self.jax.extent


@pytest.fixture(scope="module")
def scene():
    kw = dict(n_gaussians=60, n_views=12, width=64, height=48)
    scenes = Scenes(jmake_scene(**kw), tmake_scene(**kw, device="cpu"))
    np.testing.assert_array_equal(scenes.port.points, scenes.jax.points)
    return scenes


def states(scene, capacity=128, seed=11):
    """The same start state in both packages (see the module docstring)."""
    rng = np.random.default_rng(seed)
    jp = jinit(scene.points, scene.colors, capacity)
    rot = rng.normal(size=(capacity, 4)).astype(np.float32)
    scl = (np.asarray(jp.scaling)
           + rng.uniform(-0.3, 0.3, (capacity, 3))).astype(np.float32)
    jp = jp.replace(rotation=jnp.asarray(rot), scaling=jnp.asarray(scl))
    tp = dataclasses.replace(tinit(scene.points, scene.colors, capacity,
                                   device="cpu"),
                             rotation=torch.tensor(rot), scaling=torch.tensor(scl))
    return (jinit_state(jp, spatial_lr_scale=scene.extent),
            tinit_state(tp, spatial_lr_scale=scene.extent))


def scene_data(scene):
    j, cams, imgs = scene.jax, scene.port.cameras, scene.port.images
    return (JSceneData(cameras=j.cameras, images=j.images,
                       event_cameras=j.cameras, event_images=j.images),
            TSceneData(cameras=cams, images=imgs, event_cameras=cams,
                       event_images=imgs))


def rel_close(t, j, msg=""):
    j = np.asarray(j, np.float64)
    scale = max(np.abs(j).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(t, np.float64) / scale, j / scale,
                               atol=RTOL, err_msg=msg)


def assert_states_match(ts, js):
    for f in PARAM_FIELDS:
        rel_close(getattr(ts.params, f).numpy(), getattr(js.params, f), f)
    rel_close(ts.contrast.numpy(), js.contrast, "contrast")
    rel_close(ts.stats.grad_accum.numpy(), js.stats.grad_accum, "grad_accum")
    assert int(ts.step) == int(js.step)


def run_steps(step_fn, state, data, views, bg, to_index):
    losses = []
    for i in views:
        state, m = step_fn(state, data, to_index(i), to_index(i),
                           to_index(i + 1), bg)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def event_runs(scene):
    """Five event steps in each package from the same state."""
    js, ts = states(scene)
    jd, td = scene_data(scene)
    cfg = JTrainConfig()
    views = [3, 4, 5, 3, 6]
    jstep = jmake_step("event", cfg.optimization, cfg.event,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    tstep = tmake_step("event", cfg.optimization, cfg.event,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    j_out = run_steps(jstep, js, jd, views, jnp.zeros(3), jnp.asarray)
    t_out = run_steps(tstep, ts, td, views, torch.zeros(3), int)
    return j_out, t_out


def test_event_step_losses_match(event_runs):
    (_, jl), (_, tl) = event_runs
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert len(set(tl)) > 1


def test_event_step_state_matches(event_runs):
    (js, _), (ts, _) = event_runs
    assert_states_match(ts, js)
    assert float(ts.contrast) != 0.17


def test_gray_step_matches(scene):
    js, ts = states(scene, seed=12)
    jd, td = scene_data(scene)
    cfg = JTrainConfig()
    jstep = jmake_step("gray", cfg.optimization, cfg.event,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    tstep = tmake_step("gray", cfg.optimization, cfg.event,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    js, jl = run_steps(jstep, js, jd, [4], jnp.zeros(3), jnp.asarray)
    ts, tl = run_steps(tstep, ts, td, [4], torch.zeros(3), int)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert_states_match(ts, js)
    assert float(ts.contrast) == pytest.approx(0.17)  # frozen outside event modes


@pytest.mark.parametrize("mode", ["rgb", "event_deblur"])
def test_other_mode_steps_match(scene, mode):
    """The two remaining modes, one step each: RGB (L1 + SSIM) and the
    event loss mixed with L1 against blurry captures (a 3-view average)."""
    js, ts = states(scene, seed=18)
    jd, td = scene_data(scene)

    def blurry(imgs):
        return ((np.roll(imgs, 1, axis=0) + imgs + np.roll(imgs, -1, axis=0))
                / 3.0).astype(np.float32)

    jd = jd._replace(blurry_images=jnp.asarray(blurry(np.asarray(jd.images))))
    td = td._replace(blurry_images=torch.tensor(blurry(td.images.numpy())))
    cfg = JTrainConfig()
    jstep = jmake_step(mode, cfg.optimization, cfg.event,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    tstep = tmake_step(mode, cfg.optimization, cfg.event,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    js, jl = run_steps(jstep, js, jd, [5], jnp.zeros(3), jnp.asarray)
    ts, tl = run_steps(tstep, ts, td, [5], torch.zeros(3), int)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert_states_match(ts, js)


def test_step_at_max_sh_degree_4_matches(scene):
    """One RGB step with 25 SH coefficients at step 4000, where the active
    degree has reached 4."""
    rng = np.random.default_rng(19)
    cap = 128
    rest = rng.normal(0, 0.1, (cap, 24, 3)).astype(np.float32)
    rot = rng.normal(size=(cap, 4)).astype(np.float32)
    jp = jinit(scene.points, scene.colors, cap, max_sh_degree=4)
    scl = (np.asarray(jp.scaling)
           + rng.uniform(-0.3, 0.3, (cap, 3))).astype(np.float32)
    jp = jp.replace(features_rest=jnp.asarray(rest), rotation=jnp.asarray(rot),
                    scaling=jnp.asarray(scl))
    tp = dataclasses.replace(
        tinit(scene.points, scene.colors, cap, max_sh_degree=4, device="cpu"),
        features_rest=torch.tensor(rest), rotation=torch.tensor(rot),
        scaling=torch.tensor(scl))
    js = jinit_state(jp, spatial_lr_scale=scene.extent)
    ts = tinit_state(tp, spatial_lr_scale=scene.extent)
    js = js.replace(step=jnp.asarray(4000, jnp.int32))
    ts = ts.replace(step=torch.tensor(4000, dtype=torch.int32))
    jd, td = scene_data(scene)
    cfg = JTrainConfig()
    jstep = jmake_step("rgb", cfg.optimization, cfg.event, max_sh_degree=4,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    tstep = tmake_step("rgb", cfg.optimization, cfg.event, max_sh_degree=4,
                       spatial_lr_scale=scene.extent, rasterizer="reference")
    js, jl = run_steps(jstep, js, jd, [5], jnp.zeros(3), jnp.asarray)
    ts, tl = run_steps(tstep, ts, td, [5], torch.zeros(3), int)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert_states_match(ts, js)
    # the degree-4 coefficients (16-24) got gradient and moved
    moved = ts.params.features_rest[:, 15:] - torch.tensor(rest)[:, 15:]
    assert moved.abs().max() > 0


def test_tiled_step_matches_reference_step(scene):
    """The kernel path's plain versions (tiled) against the oracle
    rasterizer inside the port, 3 event steps."""
    _, ts = states(scene, seed=13)
    _, td = scene_data(scene)
    cfg = TTrainConfig()
    out = {}
    for rast in ("reference", "tiled"):
        step = tmake_step("event", cfg.optimization, cfg.event,
                          spatial_lr_scale=scene.extent, rasterizer=rast)
        out[rast] = run_steps(step, ts, td, [3, 5, 4], torch.zeros(3), int)
    np.testing.assert_allclose(out["tiled"][1], out["reference"][1], rtol=RTOL)
    for f in PARAM_FIELDS:
        rel_close(getattr(out["tiled"][0].params, f).numpy(),
                  getattr(out["reference"][0].params, f).numpy(), f)


def test_step_is_deterministic_and_leaves_its_input(scene):
    _, ts = states(scene, seed=14)
    _, td = scene_data(scene)
    cfg = TTrainConfig()
    step = tmake_step("event", cfg.optimization, cfg.event,
                      spatial_lr_scale=scene.extent, rasterizer="tiled")
    before = ts.params.xyz.clone()
    torch.use_deterministic_algorithms(True)
    try:
        a, _ = step(ts, td, 3, 3, 4, torch.zeros(3))
        b, _ = step(ts, td, 3, 3, 4, torch.zeros(3))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(ts.params.xyz, before)
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(a.params, f), getattr(b.params, f)), f
    assert torch.equal(a.stats.grad_accum, b.stats.grad_accum)


def test_train_loop_matches_jax_loop(scene):
    """Same seed → same view picks (random.Random) and the same losses;
    densification off (its split samples differ by framework)."""
    js, ts = states(scene, seed=15)
    jd, td = scene_data(scene)
    kw = dict(densify_from_iter=10_000, densify_until_iter=0)
    jcfg = JTrainConfig(optimization=JOptCfg(**kw))
    jcfg.pipeline.rasterizer = "reference"
    tcfg = TTrainConfig(optimization=TOptCfg(**kw))
    tcfg.pipeline.rasterizer = "reference"
    jr = jtrain_loop(js, jd, jcfg, "event", scene.extent, iterations=8)
    tr = ttrain_loop(ts, td, tcfg, "event", scene.extent, iterations=8)
    np.testing.assert_allclose(tr.history, jr.history, rtol=RTOL)
    assert_states_match(tr.state, jr.state)


def test_checkpoints_load_in_both_packages(scene, tmp_path):
    js, ts = states(scene, seed=16)
    jd, td = scene_data(scene)
    cfg = JTrainConfig()
    js, _ = run_steps(jmake_step("event", cfg.optimization, cfg.event,
                                 rasterizer="reference"),
                      js, jd, [3, 4], jnp.zeros(3), jnp.asarray)
    ts, _ = run_steps(tmake_step("event", cfg.optimization, cfg.event,
                                 rasterizer="reference"),
                      ts, td, [5], torch.zeros(3), int)
    _, t_template = states(scene, seed=17)
    j_template, _ = states(scene, seed=17)

    jsave(str(tmp_path / "jax.npz"), js, 2)
    loaded, it = tload(str(tmp_path / "jax.npz"), t_template)
    assert it == 2
    tsave(str(tmp_path / "port.npz"), ts, 1)
    jloaded, jit_ = jload(str(tmp_path / "port.npz"), j_template)
    assert jit_ == 1

    def leaves(state, j):
        p, o, c = state.params, state.opt_state, state.contrast_opt
        out = {f"params/{f}": getattr(p, f) for f in PARAM_FIELDS + ("alive",)}
        out.update({f"mu/{k}": o.mu[k] for k in PARAM_FIELDS})
        out.update({f"nu/{k}": o.nu[k] for k in PARAM_FIELDS})
        out.update({"count": o.count, "contrast": state.contrast,
                    "c_mu": c.mu, "c_nu": c.nu, "c_count": c.count,
                    "step": state.step, "grad_accum": state.stats.grad_accum,
                    "denom": state.stats.denom,
                    "max_radii2d": state.stats.max_radii2d})
        return {k: np.asarray(v) if j else v.numpy() for k, v in out.items()}

    for got, want in ((leaves(loaded, False), leaves(js, True)),
                      (leaves(jloaded, True), leaves(ts, False))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="capacity"):
        tload(str(tmp_path / "jax.npz"), states(scene, capacity=96)[1])


def test_cli_train_then_render_on_cpu(tmp_path, capsys):
    from event3dgs_tpu_torch.tools.make_scene import synthesize_scene
    from event3dgs_tpu_torch.cli import render as trender
    from event3dgs_tpu_torch.cli import train as ttrain

    src, model = str(tmp_path / "scene"), str(tmp_path / "model")
    synthesize_scene(src, n_views=8, width=48, height=48, n_gaussians=60,
                     white_background=True, device="cpu")
    rc = ttrain.main([
        "-s", src, "-m", model, "--gray", "--event", "-r", "1", "-w",
        "--iterations", "6", "--densify_from_iter", "2",
        "--densification_interval", "3", "--densify_grad_threshold", "1e-7",
        "--save_iterations", "6", "--checkpoint_iterations", "6",
        "--device", "cpu",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "num_alive" in out and "Training complete: 6 optimizer steps" in out
    ply = os.path.join(model, "point_cloud", "iteration_6", "point_cloud.ply")
    ck = np.load(os.path.join(model, "chkpnt6.npz"))
    assert os.path.exists(ply) and int(ck["step"]) == 6
    # densify at iteration 6 resets the stats the 6 steps accumulated
    assert not ck["stats/denom"].any()
    assert ck["params/alive"].sum() > 60  # split/clone added Gaussians
    assert np.isfinite(ck["params/xyz"]).all() and float(ck["contrast"]) != 0.17

    assert trender.main(["-m", model, "--device", "cpu"]) == 0
    for sub in ("train", "test"):
        renders = os.path.join(model, sub, "ours_6", "renders")
        assert len(os.listdir(renders)) == 8, sub
    with pytest.raises(SystemExit):  # no --source_path
        ttrain.main(["--port", "6009", "--device", "cpu"])
