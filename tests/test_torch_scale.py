"""``event3dgs_tpu_torch/tools/scale.py`` against the JAX package's scale
scripts, on the CPU at a small size.

- The ``step`` and ``maxcap`` scenes at n = 4,096 and 64×48: the scripts'
  own code (``experiments/tools_scale_1m.py``, ``tools_r5_maxcap.py``,
  their ``main`` up to the scene data, run with the small size) against
  the port's recipes: parameters and images equal, then one event step on
  the tiled rasterizer from each at ``tests/test_torch_train.py``'s
  tolerance (loss, contrast and parameters within 1e-5 relative; see :func:`assert_one_adam_step_close` for the few elements
  Adam's first update moves by its learning rate).
- ``train`` at 4,096 slots, 400 true points, 6 views at 64×48 (rgb mode's
  view pick needs 5): the script's world and model against the port's
  (ground truth at the render tolerance, parameters equal), and the loss
  history of 5 iterations against the JAX ``train_loop`` from the same
  images and the same perturbed model at 1e-5 relative; with densify (every 5): finite, decreasing
  losses and the alive count after the densify.
- ``mesh`` at C = 4,096 on 2 gloo ranks: C/K rows of every per-Gaussian
  tensor before and after the step, the rank's state its C/K share of the
  whole state's (under half of it needs more than 2 ranks), a finite
  loss.
- ``mesh``'s scene built once: the ranks' shards together are the whole
  initialised cloud, and the whole state's bytes are counted from it.
- Each subcommand's JSON line, ``maxcap``'s ``"oom"`` status and exit
  code, a run that does not count (a non-finite loss, an instance past
  the cap) and the search stopping at it, the ``--search`` bisection, and
  the graphed search's ``--fused_steps``.
"""

import importlib.util
import inspect
import json
import pathlib
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event3dgs_tpu.train import train_loop as jtrain_loop
from event3dgs_tpu.train.loop import measure_instance_cap as jmeasure_cap
from event3dgs_tpu.train.step import make_train_step as jmake_step
from event3dgs_tpu.utils.config import EventConfig as JEventCfg
from event3dgs_tpu.utils.config import OptimizationConfig as JOptCfg
from event3dgs_tpu.utils.config import TrainConfig as JTrainConfig
from event3dgs_tpu_torch.models.gaussians import FIELDS
from event3dgs_tpu_torch.tools import scale
from event3dgs_tpu_torch.train.loop import measure_instance_cap
from event3dgs_tpu_torch.train.step import _lr_tree
from test_torch_train import RTOL, rel_close

torch.set_num_threads(1)

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"
N, W, H = 4096, 64, 48


def script_scene(name, **overrides):
    """Run ``experiments/<name>.py``'s ``main`` up to its scene data with
    its size constants replaced: the names it has bound there."""
    spec = importlib.util.spec_from_file_location(name, EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    argv, path = sys.argv, list(sys.path)
    sys.argv = [name]  # the scripts read their size from argv or the env
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv, sys.path[:] = argv, path
    src = textwrap.dedent(inspect.getsource(mod.main))
    body = textwrap.dedent(src[src.index("\n") + 1:src.index("    data = SceneData(")])
    env = dict(vars(mod), **overrides)
    exec(body, env)
    return env


def assert_params_equal(tp, jp):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


@pytest.mark.parametrize("probe,script,size", [
    ("step", "tools_scale_1m", "N"), ("maxcap", "tools_r5_maxcap", "CAP")])
def test_scene_recipe_and_event_step_match_the_jax_script(probe, script, size):
    env = script_scene(script, **{size: N, "W": W, "H": H})
    ts, td = scale.SCENES[probe](N, W, H, "cpu")
    assert_params_equal(ts.params, env["params"])
    np.testing.assert_array_equal(td.images.numpy(), np.asarray(env["images"]))
    for f in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_allclose(getattr(td.cameras, f).numpy(),
                                   np.asarray(getattr(env["cameras"], f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)

    cams = env["cameras"]
    jdata = dict(cameras=cams, images=env["images"], event_cameras=cams,
                 event_images=env["images"])
    from event3dgs_tpu.train import SceneData as JSceneData

    jcap = jmeasure_cap(env["state"].params, cams)
    tcap = measure_instance_cap(ts.params, td.cameras)
    assert tcap == jcap
    jstep = jmake_step("event", JOptCfg(), JEventCfg(), spatial_lr_scale=3.0,
                       rasterizer="tiled", instance_cap=jcap)
    js, jm = jstep(env["state"], JSceneData(**jdata), *(jnp.asarray(v) for v in
                                                       scale.STEP_VIEWS),
                   jnp.zeros(3))
    held = [ts]
    tstate, rec = scale.eager_steps(held, td, tcap, 0, "cpu")
    np.testing.assert_allclose(rec["loss"], float(jm["loss"]), rtol=RTOL)
    assert_one_adam_step_close(tstate, js)


def assert_adam_close(t, j, lr, steps, what):
    """``t`` and ``j`` within 1e-5 relative at all but 0.1 % of the
    elements, and everywhere within 2·lr per Adam step (each step moves a
    parameter by at most lr, in either direction) and the float32 rounding
    of those steps."""
    t = t.numpy().astype(np.float64)
    j = np.asarray(j, np.float64)
    off = np.abs(t - j) > RTOL * max(np.abs(j).max(), 1e-12)
    assert off.mean() < 1e-3, what
    ulp = np.spacing(np.float32(np.abs(j).max()))
    assert np.abs(t - j).max() <= steps * 2 * (lr + ulp), what


def assert_one_adam_step_close(ts, js):
    """After one step from equal states: the contrast within 1e-5
    relative, the densify stat near 0 in both; each parameter within 1e-5 relative but where
    Adam's first update (±lr wherever the gradient is not 0) took the other
    sign from a gradient at rounding-noise level (``test_torch_train``'s
    trap, here with the scripts' identity rotations and splats that barely
    reach a pixel): there within 2·lr of its group, at under 0.1 % of the
    elements."""
    lrs = _lr_tree(JOptCfg(), 1, 3.0)
    for f in FIELDS[:-1]:
        assert_adam_close(getattr(ts.params, f), getattr(js.params, f),
                          lrs[f], 1, f)
    assert np.array_equal(ts.params.alive.numpy(), np.asarray(js.params.alive))
    rel_close(ts.contrast.numpy(), js.contrast, "contrast")
    # the event pair's coverage is 1 on the scripts' random images, so the
    # main view's gradient, the densify stat, is 0 in exact arithmetic
    # (the port's is 0; JAX's fused sums leave ~4e-12)
    np.testing.assert_allclose(ts.stats.grad_accum.numpy(),
                               np.asarray(js.stats.grad_accum), atol=1e-9)
    np.testing.assert_array_equal(ts.stats.denom.numpy(),
                                  np.asarray(js.stats.denom))
    assert int(ts.step) == int(js.step) == 1


@pytest.fixture(scope="module")
def train_scripts():
    """The train script's world and model (DENSIFY unset), and the port's."""
    import os

    os.environ.pop("DENSIFY", None)
    env = script_scene("tools_scale_1m_train", N_TRUE=400, CAPACITY=N,
                       N_VIEWS=6, W=W, H=H)
    port = scale.train_scene(N, False, 400, 6, W, H, "cpu")
    return env, port


def test_train_scene_matches_the_jax_script(train_scripts):
    env, (ts, td) = train_scripts
    np.testing.assert_allclose(td.images.numpy(), np.asarray(env["images"]),
                               atol=2e-5, rtol=1e-4)
    assert_params_equal(ts.params, env["params"])
    assert int(ts.params.alive.sum()) == N


def test_train_losses_match_the_jax_train_loop(train_scripts):
    """From the script's model with its rotations and scales perturbed
    alike in both packages (at the point-cloud init the rotation gradient
    is rounding noise, which Adam scales to ±lr: ``test_torch_train``'s
    trap), on the port's ground truth: the losses at 1e-5 relative.  The
    parameters are not compared: the splats that barely reach a pixel
    keep gradients at noise level, and Adam moves each of them by ±lr (a
    tenth of the opacities after 5 steps)."""
    from event3dgs_tpu.train import SceneData as JSceneData
    from event3dgs_tpu.train import init_train_state as jinit_state
    from event3dgs_tpu_torch.train import init_train_state

    env, (ts, td) = train_scripts
    rng = np.random.default_rng(11)
    rot = rng.normal(size=(N, 4)).astype(np.float32)
    scl = (np.asarray(env["params"].scaling)
           + rng.uniform(-0.3, 0.3, (N, 3))).astype(np.float32)
    js = jinit_state(env["params"].replace(rotation=jnp.asarray(rot),
                                           scaling=jnp.asarray(scl)),
                     spatial_lr_scale=4.4)
    ts = init_train_state(ts.params.__class__(**{
        **{f: getattr(ts.params, f) for f in FIELDS},
        "rotation": torch.tensor(rot), "scaling": torch.tensor(scl)}),
        spatial_lr_scale=4.4)
    jcfg = JTrainConfig(optimization=JOptCfg(densify_from_iter=10 ** 9,
                                             densify_until_iter=0))
    jcfg.pipeline.rasterizer = "tiled"
    jdata = JSceneData(cameras=env["cameras"], images=jnp.asarray(td.images.numpy()))
    jr = jtrain_loop(js, jdata, jcfg, "rgb", 4.4, iterations=5)
    rec, tr = scale.run_train(iters=5, capacity=N, n_true=400, n_views=6,
                              width=W, height=H, device="cpu",
                              scene=(ts, td))
    np.testing.assert_allclose(tr.history, jr.history, rtol=RTOL)
    assert rec["status"] == "ok" and rec["alive_end"] == N
    assert rec["instance_overflow"] == 0


def test_train_with_densify_reports_alive():
    rec, res = scale.run_train(iters=12, densify=True, capacity=N,
                               n_true=400, n_views=6, width=W, height=H,
                               device="cpu", densify_every=5)
    assert rec["alive_start"] == N * 9 // 10
    assert [it for it, _ in rec["alive"]] == [10]
    assert rec["alive"][0][1] == rec["alive_end"] == int(res.state.params.alive.sum())
    assert rec["finite"] and rec["decreasing"] and rec["status"] == "ok"
    assert rec["instance_overflow"] == 0
    assert len(rec["loss_curve"]) == 12


def test_mesh_holds_the_memory_contract_on_two_ranks():
    rec = scale.run_mesh(capacity=N, ranks=2, width=32, height=24,
                         n_views=16, timeout=240)
    assert rec["status"] == "ok", rec
    assert rec["rows_per_rank"] == N // 2 and rec["backend"] == "gloo"
    assert all(rec["checks"].values())
    assert "rank_state_under_half" not in rec["checks"]  # 2 ranks: half
    # params (7), Adam moments (12) and densify stats (3)
    assert rec["per_gaussian_tensors"] == 22
    assert np.isfinite(rec["loss"])


def json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    return json.loads(lines[0])


SMALL = ["--device", "cpu", "--width", "64", "--height", "48"]
KEYS = {
    "step": {"probe", "status", "capacity", "state_gib", "instance_cap",
             "instances_per_splat", "eager", "graphed", "same_loss", "card"},
    "maxcap": {"probe", "status", "capacity", "state_gib", "instance_cap",
               "eager", "graphed", "failed_in", "card"},
    "train": {"probe", "status", "alive_start", "alive_end", "it_s",
              "loss_curve", "finite", "decreasing", "instance_overflow",
              "capacity_end", "card"},
    "mesh": {"probe", "status", "capacity", "ranks", "rows_per_rank",
             "full_state_gib", "rank_state_gib", "loss", "checks"},
}


@pytest.mark.parametrize("argv", [
    ["step", "--gaussians", "300", "--steps", "1", "--fused_steps", "2"],
    ["maxcap", "--capacity", "256", "--iters", "1"],
    ["train", "--capacity", "512", "--true_points", "100", "--views", "6",
     "--iters", "10"],
    ["mesh", "--capacity", "512", "--ranks", "2", "--views", "4"],
], ids=["step", "maxcap", "train", "mesh"])
def test_each_subcommand_prints_one_json_line(argv, capsys):
    extra = [] if argv[0] == "mesh" else SMALL
    assert scale.main(argv + extra) == 0
    rec = json_line(capsys)
    assert KEYS[argv[0]] <= set(rec) and rec["probe"] == argv[0]
    assert rec["status"] == "ok"
    if argv[0] == "step":
        assert rec["same_loss"] and rec["graphed"]["replays"] == 0
    for run in ("eager", "graphed"):
        if argv[0] in scale.SCENES and rec[run]:
            assert rec[run]["finite"] and rec[run]["instance_overflow"] == 0


def test_maxcap_reports_running_out_of_memory(monkeypatch, capsys):
    """An OOM is the probe's result: status "oom", the phase, exit 1."""
    def no_room(*args):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")

    monkeypatch.setitem(scale.SCENES, "maxcap", no_room)
    assert scale.main(["maxcap", "--capacity", "256"] + SMALL) == 1
    rec = json_line(capsys)
    assert rec["status"] == "oom" and rec["failed_in"] == "init"
    assert "out of memory" in rec["error"]
    assert scale.is_oom(RuntimeError("CUBLAS_STATUS_ALLOC_FAILED"))
    assert not scale.is_oom(ValueError("out of memory"))


def test_search_bisects_to_the_granularity(capsys):
    """Grid up to the first OOM, then bisection to 256 slots: the ceiling
    is the largest multiple of 256 that runs; an error that is not an OOM
    ends the search."""
    limit = 5_000_000
    seen = []

    def probe(c, args):
        seen.append(c)
        return {"capacity": c, "status": "ok" if c <= limit else "oom"}

    args = scale.build_parser().parse_args(["maxcap", "--search"])
    out = scale.search_ceiling(args, probe)
    assert out["ceiling"] == limit // 256 * 256
    assert out["first_oom"] == out["ceiling"] + 256
    assert seen[:3] == [2_097_152, 4_194_304, 8_388_608]
    assert out["probes"] == len(seen) <= 3 + 15
    with pytest.raises(SystemExit):
        scale.search_ceiling(args, lambda c, a: {"capacity": c,
                                                 "status": "error"})


@pytest.mark.parametrize("fault", ["overflow", "non-finite loss"])
def test_maxcap_counts_a_run_only_with_finite_losses_and_no_overflow(
        fault, monkeypatch):
    """A run whose end state passes the instance cap, or whose loss is not
    finite, is "failed" (the search stops there), never "ok"."""
    if fault == "overflow":
        monkeypatch.setattr(scale, "instance_overflow", lambda *a: 3)
    else:
        scene = scale.SCENES["maxcap"]

        def with_nan(*args):
            state, data = scene(*args)
            data.images[:, 0, 0] = float("nan")
            return state, data

        monkeypatch.setitem(scale.SCENES, "maxcap", with_nan)
    rec = scale.run_scene("maxcap", 256, 1, 2, False, W, H, "cpu")
    assert rec["status"] == "failed" and rec["failed_in"] == "eager"
    eager = rec["eager"]
    assert (eager["instance_overflow"] == 3 if fault == "overflow"
            else not eager["finite"])
    with pytest.raises(SystemExit):
        scale.search_ceiling(scale.build_parser().parse_args(
            ["maxcap", "--search"]), lambda c, a: rec)


@pytest.mark.parametrize("argv,graphed", [
    ([], scale.SEARCH_FUSED_STEPS), (["--fused_steps", "4"], 4)])
def test_search_passes_fused_steps_through(argv, graphed, monkeypatch):
    seen = []
    monkeypatch.setattr(scale, "search_ceiling",
                        lambda a: seen.append(a.fused_steps) or {})
    monkeypatch.setattr(scale, "card", lambda device: "")
    out = scale.run_search(scale.build_parser().parse_args(
        ["maxcap", "--search"] + argv))
    assert seen == [1, graphed] and out["fused_steps"] == graphed


def test_mesh_scene_is_one_init_cut_into_rank_slices(tmp_path):
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.train import init_train_state

    c, ranks = 512, 4
    whole = scale.mesh_scene(c, ranks, 32, 24, 5, str(tmp_path))
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(c, 3)) * np.array([0.9, 0.6, 0.9])).astype(
        np.float32)
    full = init_from_point_cloud(pts, rng.uniform(0.1, 1.0, (c, 3)).astype(
        np.float32), capacity=c, device="cpu")
    shards = [torch.load(tmp_path / f"shard{r}.pt") for r in range(ranks)]
    for f in FIELDS:
        assert torch.equal(torch.cat([sh[f] for sh in shards]),
                           getattr(full, f)), f
    assert whole == scale.state_bytes(init_train_state(
        full, spatial_lr_scale=scale.TRAIN_EXTENT))
    state, data = scale.mesh_shard(1, 32, 24, 5, str(tmp_path))
    assert state.params.capacity == c // ranks
    assert data.images.shape == (5, 24, 32, 3)
