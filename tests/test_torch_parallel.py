"""The port's multi-rank training pieces (``event3dgs_tpu_torch/parallel``)
on gloo ranks on the CPU, against the port's unsharded functions and the
JAX package's sharded step, at the tolerances of tests/test_parallel.py.

One spawn of four ranks (``tests/_torch_rank_worker.py``) runs every
scenario; the tests below read its results:

- mesh: the (data, gauss) grid, its groups and each rank's slots and batch;
  each host's view slots and the global view batch built from them;
- merge: ``merge_depth_partials`` at K = 4 against sequential compositing,
  image and gradients (atol 1e-6 / 1e-5);
- exchange: ``render_view_exchange`` at gauss 2 and 4 on a full orbit
  against the unsharded render, loss rel 1e-5, gradients atol 1e-4;
- the data 2 × gauss 2 event step on one view against the port's plain
  step and against JAX's ``make_sharded_train_step`` on a 4-device mesh
  (loss rel 1e-4, contrast abs 1e-6, parameters atol 3e-3, ``denom`` 4×
  within 1e-6, ``grad_accum`` 4× within 2e-3, ``max_radii2d`` 1e-4);
- the rgb, gray and event_deblur steps against the plain step;
- the step over four distinct views: densify stats equal to the sum of
  four single-view steps (a missed or doubled reduction inflates them),
  data replicas' parameters bitwise identical, C/K rows per rank;
- the partials strategy runs, and its orbit merge error;
- a B = 1 step on a world of one rank equal to the plain step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_worker as worker
from event3dgs_tpu.core.camera import stack_cameras as jstack
from event3dgs_tpu.data.synthetic import orbit_cameras as jorbit
from event3dgs_tpu.models import init_from_point_cloud as jinit
from event3dgs_tpu.parallel import make_mesh as jmake_mesh
from event3dgs_tpu.parallel import make_sharded_train_step as jmake_sharded
from event3dgs_tpu.parallel import shard_train_state as jshard
from event3dgs_tpu.parallel import unshard_state as junshard
from event3dgs_tpu.parallel.partition import depth_partition_perm as jperm
from event3dgs_tpu.train import SceneData as JSceneData
from event3dgs_tpu.train import init_train_state as jinit_state
from event3dgs_tpu.utils.config import EventConfig as JEventConfig
from event3dgs_tpu.utils.config import OptimizationConfig as JOptConfig
from event3dgs_tpu_torch.models import activated, init_from_point_cloud
from event3dgs_tpu_torch.models.gaussians import trainable_dict, with_trainable
from event3dgs_tpu_torch.ops.render import render
from event3dgs_tpu_torch.parallel.mesh import mesh_shape
from event3dgs_tpu_torch.parallel.partition import (
    depth_partition_perm,
    repartition_by_depth,
)
from event3dgs_tpu_torch.parallel.sharded_train import make_sharded_train_step
from event3dgs_tpu_torch.train import init_train_state, make_train_step
from event3dgs_tpu_torch.train.state import SceneData, map_tensors
from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

torch.set_num_threads(1)

FIELDS = ("xyz", "features_dc", "scaling", "opacity", "rotation")
SCENARIOS = ("mesh", "hosts", "merge", "exchange2", "exchange4",
             "step_same_view", "modes", "step_distinct", "partials")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn(tmp_path_factory.mktemp("ranks4"), 4, SCENARIOS)


@pytest.fixture(scope="module")
def small():
    return worker.small_scene()


def plain_step(mode, state, data, views, extent):
    step = make_train_step(mode, OptimizationConfig(), EventConfig(),
                           spatial_lr_scale=extent, rasterizer="tiled")
    return step(state, data, *views, torch.zeros(3))


def test_mesh_shape_rules_and_errors():
    assert mesh_shape(8) == (8, 1)
    assert mesh_shape(8, gauss=2) == (4, 2)
    assert mesh_shape(8, data=2) == (2, 4)
    with pytest.raises(ValueError, match="mesh 3x3 != 8"):
        mesh_shape(8, data=3, gauss=3)
    with pytest.raises(ValueError, match="gauss_mode"):
        make_sharded_train_step("event", OptimizationConfig(), EventConfig(),
                                None, gauss_mode="sharded")


def test_mesh_grid_groups_and_slots(ranks):
    for r, res in enumerate(ranks):
        m = res["mesh"]
        d, g = divmod(r, 2)
        assert m["shape"] == {"data": 2, "gauss": 2}
        assert (m["data_rank"], m["gauss_rank"], m["rank"]) == (d, g, r)
        assert m["dim_names"] == ("data", "gauss")
        # the gauss axis is innermost: a gauss group is consecutive ranks
        assert m["gauss_ranks"] == [2 * d, 2 * d + 1]
        assert m["data_ranks"] == [g, 2 + g]
        assert m["slots"] == slice(32 * g, 32 * (g + 1))
        assert m["batch"] == slice(2 * d, 2 * d + 2)


def test_host_view_slots_and_global_batch(ranks):
    """Two hosts of two ranks: host h owns slots 2h, 2h + 1 and data rank
    h; the global batch is assembled in slot order on every rank."""
    for r, res in enumerate(ranks):
        h = res["hosts"]
        assert h["process"] == r // 2
        assert h["slots"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert h["data_ranks"] == [r // 2]
        assert h["exact"] == [10, 11, 12, 13]
        assert h["partials"] == [20, 21]


def test_depth_partition_perm_matches_jax(small):
    cams, _, points, colors = worker.layered_scene()
    params = init_from_point_cloud(points, colors, 64, device="cpu")
    jcams = jstack(jorbit(6, radius=4.0, width=64, img_height=32, arc=0.3))
    xyz, alive = params.xyz.numpy(), params.alive.numpy()
    perm = depth_partition_perm(xyz, alive, cams, 2)
    np.testing.assert_array_equal(perm, jperm(xyz, alive, jcams, 2))
    s0, s1 = perm[:32][alive[perm[:32]]], perm[32:][alive[perm[32:]]]
    assert len(s0) == 20 and len(s1) == 20
    assert xyz[s0][:, 2].max() < xyz[s1][:, 2].min()
    with pytest.raises(ValueError, match="not divisible"):
        depth_partition_perm(xyz[:63], alive[:63], cams, 2)

    state = init_train_state(init_from_point_cloud(
        small.points, small.colors, 64, device="cpu"), small.extent)
    out = repartition_by_depth(state, small.cameras, 4)
    assert int(out.params.alive.sum()) == int(state.params.alive.sum())
    np.testing.assert_array_equal(np.sort(out.params.xyz.numpy(), axis=0),
                                  np.sort(state.params.xyz.numpy(), axis=0))


def test_merge_matches_sequential_compositing(ranks):
    rgb, logt, bg = worker.merge_inputs()
    rgb.requires_grad_(True)
    logt.requires_grad_(True)
    prefix = torch.cumsum(logt, dim=0) - logt
    ref = (torch.sum(torch.exp(prefix)[..., None] * rgb, dim=0)
           + torch.exp(logt.sum(0))[..., None] * bg[None, None, :])
    g_rgb, g_logt = torch.autograd.grad(torch.sum(ref ** 2), [rgb, logt])
    for res in ranks:
        m = res["merge"]
        k = m["shard"]
        np.testing.assert_allclose(m["image"], ref.detach(), atol=1e-6)
        np.testing.assert_allclose(m["g_rgb"], g_rgb[k], atol=1e-5)
        np.testing.assert_allclose(m["g_logt"], g_logt[k], atol=1e-5)


@pytest.mark.parametrize("gauss", [2, 4])
def test_exchange_matches_unsharded_full_orbit(ranks, gauss):
    scene = worker.orbit_scene()
    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    bg = torch.tensor([0.15, 0.25, 0.35])
    per = 64 // gauss
    for view in (0, 3, 6):
        tree = {k: v.detach().clone().requires_grad_(True)
                for k, v in trainable_dict(params).items()}
        act = activated(with_trainable(params, tree))
        out = render(act.means3d, act.features, act.opacities, act.scales,
                     act.rotations, scene.cameras[view], bg, sh_degree=3,
                     rasterizer="tiled")
        loss = torch.mean(torch.abs(out.image - scene.images[view]))
        grads = dict(zip(tree, torch.autograd.grad(loss, list(tree.values()))))
        for res in ranks:
            ex = res[f"exchange{gauss}"]
            got = ex["views"][view]
            assert got["loss"] == pytest.approx(float(loss.detach()), rel=1e-5)
            block = slice(ex["shard"] * per, (ex["shard"] + 1) * per)
            for k, g in grads.items():
                np.testing.assert_allclose(
                    got["grads"][k], g[block], atol=1e-4,
                    err_msg=f"grad {k}, view {view}, gauss {gauss}")


@pytest.fixture(scope="module")
def same_view_refs():
    """The port's plain step and JAX's 2 × 2 sharded step on view 2."""
    cams, images, points, colors = worker.layered_scene()
    params = init_from_point_cloud(points, colors, 64, device="cpu")
    plain, plain_m = plain_step("event", init_train_state(params, 3.0),
                                worker.event_data(cams, images), (2, 2, 3), 3.0)
    jcams = jstack(jorbit(6, radius=4.0, width=64, img_height=32, arc=0.3))
    jimages = jnp.asarray(images.numpy())
    jstate = jinit_state(jinit(points, colors, capacity=64),
                         spatial_lr_scale=3.0)
    mesh = jmake_mesh(4, gauss=2)
    step = jmake_sharded(
        "event", JOptConfig(), JEventConfig(), mesh, spatial_lr_scale=3.0)
    idx = jnp.full((4,), 2, jnp.int32)
    js, jm = step(jshard(jstate, mesh),
                  JSceneData(cameras=jcams, images=jimages,
                             event_cameras=jcams, event_images=jimages),
                  idx, idx, idx + 1, jnp.zeros(3))
    return (plain, plain_m), (junshard(js), jm)


def test_sharded_event_step_matches_plain_step(ranks, same_view_refs):
    (s1, m1), _ = same_view_refs
    for res in ranks:
        s2 = res["step_same_view"]
        assert s2["metrics"]["loss"] == pytest.approx(float(m1["loss"]),
                                                      rel=1e-4)
        assert s2["contrast"] == pytest.approx(float(s1.contrast), abs=1e-6)
        for f in FIELDS:
            np.testing.assert_allclose(s2["params"][f], getattr(s1.params, f),
                                       atol=3e-3, err_msg=f)
        # the stats hold exactly B = 4 single-view accumulations
        np.testing.assert_allclose(s2["stats"]["denom"], 4 * s1.stats.denom,
                                   atol=1e-6)
        np.testing.assert_allclose(s2["stats"]["grad_accum"],
                                   4 * s1.stats.grad_accum, atol=2e-3)
        np.testing.assert_allclose(s2["stats"]["max_radii2d"],
                                   s1.stats.max_radii2d, atol=1e-4)
        assert s2["step"] == 4


def test_sharded_event_step_matches_jax_sharded_step(ranks, same_view_refs):
    _, (js, jm) = same_view_refs
    for res in ranks:
        s2 = res["step_same_view"]
        assert s2["metrics"]["loss"] == pytest.approx(float(jm["loss"]),
                                                      rel=1e-4)
        assert s2["metrics"]["num_visible"] == int(jm["num_visible"])
        assert s2["contrast"] == pytest.approx(float(js.contrast), abs=1e-6)
        for f in FIELDS:
            np.testing.assert_allclose(s2["params"][f],
                                       np.asarray(getattr(js.params, f)),
                                       atol=3e-3, err_msg=f)
        np.testing.assert_allclose(s2["stats"]["denom"],
                                   np.asarray(js.stats.denom), atol=1e-6)
        np.testing.assert_allclose(s2["stats"]["grad_accum"],
                                   np.asarray(js.stats.grad_accum), atol=2e-3)
        np.testing.assert_allclose(s2["stats"]["max_radii2d"],
                                   np.asarray(js.stats.max_radii2d), atol=1e-4)
        assert s2["step"] == int(js.step)


@pytest.mark.parametrize("mode", ["rgb", "gray", "event_deblur"])
def test_sharded_step_other_modes_match_plain_step(ranks, small, mode):
    """The three other loss modes, every rank on view 3: the plain step's
    loss, parameters and 4× its visit counts (the event step's
    tolerances)."""
    state = init_train_state(init_from_point_cloud(
        small.points, small.colors, 64, device="cpu"), small.extent)
    s1, m1 = plain_step(mode, state, worker.mode_data(small), (3, 3, 4),
                        small.extent)
    for res in ranks:
        got = res["modes"][mode]
        assert got["loss"] == pytest.approx(float(m1["loss"]), rel=1e-4)
        assert got["contrast"] == pytest.approx(float(s1.contrast), abs=1e-6)
        for f in FIELDS:
            np.testing.assert_allclose(got["params"][f], getattr(s1.params, f),
                                       atol=3e-3, err_msg=f"{mode} {f}")
        np.testing.assert_allclose(got["denom"], 4 * s1.stats.denom,
                                   atol=1e-6)


def test_batched_stats_match_per_view_sum(ranks, small):
    """Four distinct views in one step: the densify stats equal the sum of
    four single-view steps at the same parameters."""
    state0 = init_train_state(init_from_point_cloud(
        small.points, small.colors, 64, device="cpu"), small.extent)
    data = worker.event_data(small.cameras, small.images)
    acc = torch.zeros(64)
    for v in (2, 3, 4, 5):
        s, _ = plain_step("event", state0, data, (v, v, v + 1), small.extent)
        acc += s.stats.grad_accum
    for res in ranks:
        st = res["step_distinct"]
        np.testing.assert_allclose(st["grad_accum"], acc, rtol=1e-4, atol=1e-9)
        # every alive splat is visible in the four views
        assert float(st["denom"].sum()) == pytest.approx(
            4 * int(state0.params.alive.sum()), abs=0.1)
        assert st["step"] == 4 and np.isfinite(st["metrics"]["loss"])


def test_data_replicas_bitwise_identical(ranks):
    for g in (0, 1):
        a, b = ranks[g]["step_distinct"], ranks[2 + g]["step_distinct"]
        for f, t in a["local"].items():
            assert torch.equal(t, b["local"][f]), (g, f)
    contrasts = {float(r["step_distinct"]["local_contrast"]) for r in ranks}
    assert len(contrasts) == 1
    # the two gauss shards differ: the comparison is not vacuous
    assert not torch.equal(ranks[0]["step_distinct"]["local"]["xyz"],
                           ranks[1]["step_distinct"]["local"]["xyz"])


def test_rank_state_is_capacity_over_gauss(ranks, small):
    """The memory contract: after a step every per-Gaussian tensor of a
    rank's state has C/K = 32 rows and the rank holds half the state."""
    full = init_train_state(init_from_point_cloud(
        small.points, small.colors, 64, device="cpu"), small.extent)
    full_bytes, n_capacity = 0, 0

    def count(t):
        nonlocal full_bytes, n_capacity
        full_bytes += t.numel() * t.element_size()
        n_capacity += t.ndim >= 1 and t.shape[0] == 64

    map_tensors(count, full)
    for res in ranks:
        st = res["step_distinct"]
        rows = [s[0][0] for s in st["shapes"] if len(s[0]) >= 1]
        assert rows == [32] * n_capacity == [32] * 22
        assert st["specs"].count("gauss") == 22
        assert sum(b for _, b in st["shapes"]) < full_bytes / 2 + 64


def test_partials_mode_runs_and_orbit_error(ranks):
    for res in ranks:
        p = res["partials"]
        assert np.isfinite(p["loss"]) and p["step"] == 2 and p["rows"] == 32
    first = ranks[0]["partials"]
    scene = worker.orbit_scene()
    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    params = dataclasses.replace(params, alive=first["orbit_alive"],
                                 **first["orbit_params"])
    act = activated(params)
    static_err, ranked_err = [], []
    for view, (img_s, img_r) in first["orbit_images"].items():
        ref = render(act.means3d, act.features, act.opacities, act.scales,
                     act.rotations, scene.cameras[view], torch.zeros(3),
                     sh_degree=3, rasterizer="tiled").image.detach()
        static_err.append(float((img_s - ref).abs().max()))
        ranked_err.append(float((img_r - ref).abs().max()))
        for res in ranks[1:]:  # the merged image is the same on every rank
            s, r = res["partials"]["orbit_images"][view]
            assert torch.equal(s, img_s) and torch.equal(r, img_r)
    # rank order never loses to the static order; the error is real
    assert all(r <= s + 1e-6 for r, s in zip(ranked_err, static_err))
    assert max(ranked_err) < max(static_err) or max(static_err) < 1e-4
    assert max(ranked_err) < 0.1


def test_world_one_step_equals_plain_step(tmp_path, small):
    res = worker.spawn(tmp_path, 1, ["world1_step"])[0]["world1_step"]
    assert res["shape"] == {"data": 1, "gauss": 1}
    state = init_train_state(init_from_point_cloud(
        small.points, small.colors, 64, device="cpu"), small.extent)
    s1, m1 = plain_step("rgb", state, SceneData(cameras=small.cameras,
                                                images=small.images),
                        (3, 3, 4), small.extent)
    assert res["loss"] == pytest.approx(float(m1["loss"]), rel=1e-5)
    np.testing.assert_allclose(res["xyz"], s1.params.xyz, atol=1e-6)
    np.testing.assert_allclose(res["grad_accum"], s1.stats.grad_accum,
                               atol=1e-6)
