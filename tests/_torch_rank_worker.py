"""Rank workers for the port's multi-rank tests (gloo ranks on the CPU).

``run_scenarios`` is started on every rank by
``event3dgs_tpu_torch.parallel.distributed.spawn_ranks``: it joins the
job through a ``file://`` rendezvous, runs the named scenarios in order
(the same order on every rank, since they call collectives) and saves
each rank's results with ``torch.save`` to ``<out>/rank<r>.pt``.  The
parent test compares them with the port's unsharded functions and with the
JAX package.  This module imports torch, numpy and the port only.
"""

import dataclasses
import os
from datetime import timedelta

import numpy as np
import torch

TIMEOUT = timedelta(seconds=90)  # every collective of a scenario


def orbit_scene():
    """48 Gaussians, 8 views around a full orbit (64×48)."""
    from event3dgs_tpu_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(48, 8, 64, 48, arc=2 * np.pi, device="cpu")


def small_scene():
    """40 Gaussians, 12 views on a 0.5 rad arc (64×48)."""
    from event3dgs_tpu_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(40, 12, 64, 48, arc=0.5, device="cpu")


def layered_scene():
    """Two depth-separated clusters, 6 views on a 0.3 rad arc (64×32) and
    random images (the JAX suite's ``layered_scene`` fixture)."""
    from event3dgs_tpu_torch.core.camera import stack_cameras
    from event3dgs_tpu_torch.data.synthetic import orbit_cameras

    rng = np.random.default_rng(7)
    near = np.c_[rng.uniform(-0.6, 0.6, 20), rng.uniform(-0.4, 0.4, 20),
                 rng.uniform(-1.5, -1.0, 20)]
    far = np.c_[rng.uniform(-0.8, 0.8, 20), rng.uniform(-0.6, 0.6, 20),
                rng.uniform(1.0, 1.6, 20)]
    points = np.concatenate([near, far], axis=0)
    colors = rng.uniform(0.1, 1.0, (40, 3))
    cams = stack_cameras(orbit_cameras(6, radius=4.0, width=64, img_height=32,
                                       arc=0.3, device="cpu"))
    images = torch.tensor(rng.uniform(0, 1, (6, 32, 64, 3)), dtype=torch.float32)
    return cams, images, points, colors


def merge_inputs():
    rng = np.random.default_rng(0)
    rgb = torch.tensor(rng.uniform(0, 0.3, (4, 4, 8, 3)), dtype=torch.float32)
    logt = torch.tensor(-rng.uniform(0, 1.0, (4, 4, 8)), dtype=torch.float32)
    return rgb, logt, torch.tensor([0.2, 0.4, 0.6])


def event_data(cameras, images):
    from event3dgs_tpu_torch.train.state import SceneData

    return SceneData(cameras=cameras, images=images, event_cameras=cameras,
                     event_images=images)


def shard_params(params, mesh):
    from event3dgs_tpu_torch.parallel.mesh import gauss_sharding

    block = gauss_sharding(mesh, params.capacity)
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name)[block]
        for f in dataclasses.fields(params)})


def tree_leaves(tree):
    """The leaves of a state tree (dataclasses and dicts), in order."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def local_leaves(state):
    p = state.params
    return {f: getattr(p, f).clone() for f in
            ("xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity")}


# ------------------------------------------------------------- scenarios


def sc_mesh(ctx):
    from event3dgs_tpu_torch.parallel.mesh import (
        data_sharding,
        gauss_sharding,
        make_mesh,
    )
    import torch.distributed as dist

    mesh = make_mesh(data=2, gauss=2, timeout=TIMEOUT)
    return dict(
        shape=mesh.shape, data_rank=mesh.data_rank, gauss_rank=mesh.gauss_rank,
        rank=mesh.rank, global_rank=dist.get_rank(),
        dim_names=tuple(mesh.device_mesh.mesh_dim_names),
        gauss_ranks=dist.get_process_group_ranks(mesh.gauss_group),
        data_ranks=dist.get_process_group_ranks(mesh.data_group),
        slots=gauss_sharding(mesh, 64), batch=data_sharding(mesh, 4))


def sc_hosts(ctx):
    """The view batch of a job split over two hosts of two ranks each:
    every host supplies the views of its own slots (exact) or data ranks
    (partials), and every rank gets the whole batch."""
    from event3dgs_tpu_torch.parallel.distributed import (
        RankInfo,
        make_global_mesh,
        make_global_view_batch,
        process_data_ranks,
        process_view_slots,
    )

    mesh = make_global_mesh(gauss=2)
    info = RankInfo(rank=ctx.rank, world_size=4, local_rank=ctx.rank % 2,
                    local_ranks=2, device=ctx.device)
    slots = process_view_slots(mesh, info)
    data_ranks = process_data_ranks(mesh, info)
    return dict(slots=slots, data_ranks=data_ranks, process=info.process_id,
                exact=make_global_view_batch(mesh, info,
                                             [10 + s for s in slots]),
                partials=make_global_view_batch(
                    mesh, info, [20 + d for d in data_ranks], "partials"))


def sc_merge(ctx):
    """K = 4 merge of random partials; loss Σ image², own-slice grads."""
    from event3dgs_tpu_torch.parallel.compose import merge_depth_partials
    from event3dgs_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, gauss=4, timeout=TIMEOUT)
    rgb, logt, bg = merge_inputs()
    k = mesh.gauss_rank
    r = rgb[k].clone().requires_grad_(True)
    lt = logt[k].clone().requires_grad_(True)
    img = merge_depth_partials(r, lt, bg, mesh.gauss_group, 4)
    g_r, g_l = torch.autograd.grad(torch.sum(img ** 2), [r, lt])
    return dict(image=img.detach(), g_rgb=g_r, g_logt=g_l, shard=k)


def _exchange(gauss):
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.models.gaussians import (
        activated,
        trainable_dict,
        with_trainable,
    )
    from event3dgs_tpu_torch.parallel.exchange import render_view_exchange
    from event3dgs_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=4 // gauss, gauss=gauss, timeout=TIMEOUT)
    scene = orbit_scene()
    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    local = shard_params(params, mesh)
    bg = torch.tensor([0.15, 0.25, 0.35])
    out = {"shard": mesh.gauss_rank, "views": {}}
    for view in (0, 3, 6):
        tree = {k: v.detach().clone().requires_grad_(True)
                for k, v in trainable_dict(local).items()}
        act = activated(with_trainable(local, tree))
        ex = render_view_exchange(
            act.means3d, act.features, act.opacities, act.scales,
            act.rotations, scene.cameras, [view] * gauss, mesh.gauss_group, 3)
        img = ex.rgb + torch.exp(ex.logt)[:, :, None] * bg[None, None, :]
        loss = torch.mean(torch.abs(img - scene.images[view]))
        # every rank of the group rendered the same view: the loss counts
        # once, as the JAX test's pmean makes it
        grads = torch.autograd.grad(loss / gauss, list(tree.values()))
        out["views"][view] = dict(loss=float(loss.detach()), grads=dict(
            zip(tree, grads)))
    return out


def sc_exchange2(ctx):
    return _exchange(2)


def sc_exchange4(ctx):
    return _exchange(4)


def sc_step_same_view(ctx):
    """data 2 × gauss 2 event step, every rank on view 2 (layered scene)."""
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
        unshard_state,
    )
    from event3dgs_tpu_torch.train.state import init_train_state
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    mesh = make_mesh(data=2, gauss=2, timeout=TIMEOUT)
    cams, images, points, colors = layered_scene()
    params = init_from_point_cloud(points, colors, 64, device="cpu")
    state = shard_train_state(init_train_state(params, spatial_lr_scale=3.0),
                              mesh)
    step = make_sharded_train_step("event", OptimizationConfig(),
                                   EventConfig(), mesh, spatial_lr_scale=3.0)
    idx = [2, 2, 2, 2]
    new, metrics = step(state, event_data(cams, images), idx, idx,
                        [3, 3, 3, 3], torch.zeros(3))
    full = unshard_state(new, mesh)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                params=local_leaves(full), contrast=float(full.contrast),
                stats=dataclasses.asdict(full.stats), step=int(full.step))


def mode_data(scene):
    """The small scene's data with blurry captures (a 3-view average)."""
    imgs = scene.images
    blurry = (torch.roll(imgs, 1, 0) + imgs + torch.roll(imgs, -1, 0)) / 3.0
    return event_data(scene.cameras, imgs)._replace(blurry_images=blurry)


def sc_modes(ctx):
    """The other three loss modes: a data 2 × gauss 2 step on view 3."""
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
        unshard_state,
    )
    from event3dgs_tpu_torch.train.state import init_train_state
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    mesh = make_mesh(data=2, gauss=2, timeout=TIMEOUT)
    scene = small_scene()
    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    state = shard_train_state(
        init_train_state(params, spatial_lr_scale=scene.extent), mesh)
    out = {}
    for mode in ("rgb", "gray", "event_deblur"):
        step = make_sharded_train_step(mode, OptimizationConfig(),
                                       EventConfig(), mesh,
                                       spatial_lr_scale=scene.extent)
        new, metrics = step(state, mode_data(scene), [3] * 4, [3] * 4,
                            [4] * 4, torch.zeros(3))
        full = unshard_state(new, mesh)
        out[mode] = dict(loss=float(metrics["loss"]),
                         params=local_leaves(full),
                         contrast=float(full.contrast),
                         denom=full.stats.denom)
    return out


def sc_step_distinct(ctx):
    """data 2 × gauss 2 event step over four distinct views (small scene):
    the batched stats, the replicas' parameters and the per-rank state."""
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
        state_partition_specs,
        unshard_state,
    )
    from event3dgs_tpu_torch.train.state import init_train_state, map_tensors
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    mesh = make_mesh(data=2, gauss=2, timeout=TIMEOUT)
    scene = small_scene()
    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    state0 = init_train_state(params, spatial_lr_scale=scene.extent)
    state = shard_train_state(state0, mesh)
    step = make_sharded_train_step("event", OptimizationConfig(),
                                   EventConfig(), mesh,
                                   spatial_lr_scale=scene.extent)
    idx = [2, 3, 4, 5]
    new, metrics = step(state, event_data(scene.cameras, scene.images), idx,
                        idx, [i + 1 for i in idx], torch.zeros(3))
    shapes = []
    map_tensors(lambda t: shapes.append((tuple(t.shape), t.numel()
                                         * t.element_size())), new)
    specs = [x for x in tree_leaves(state_partition_specs(state0, mesh))
             if x is None or isinstance(x, str)]
    full = unshard_state(new, mesh)
    return dict(local=local_leaves(new), local_contrast=new.contrast.clone(),
                shapes=shapes, specs=specs, step=int(new.step),
                grad_accum=full.stats.grad_accum, denom=full.stats.denom,
                metrics={k: float(v) for k, v in metrics.items()})


def sc_partials(ctx):
    """The partials strategy: a data 2 × gauss 2 event step on the
    depth-partitioned small scene, and the orbit merge error with the
    per-view rank order and with the scene-static order."""
    from event3dgs_tpu_torch.models import activated, init_from_point_cloud
    from event3dgs_tpu_torch.ops.render import render_partials
    from event3dgs_tpu_torch.parallel.compose import (
        merge_depth_partials,
        view_depth_ranks,
    )
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.parallel.partition import repartition_by_depth
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
    )
    from event3dgs_tpu_torch.train.state import init_train_state
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    mesh = make_mesh(data=2, gauss=2, timeout=TIMEOUT)
    scene = small_scene()
    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    state = init_train_state(params, spatial_lr_scale=scene.extent)
    state = shard_train_state(repartition_by_depth(state, scene.cameras, 2),
                              mesh)
    step = make_sharded_train_step("event", OptimizationConfig(),
                                   EventConfig(), mesh,
                                   spatial_lr_scale=scene.extent,
                                   gauss_mode="partials")
    new, metrics = step(state, event_data(scene.cameras, scene.images),
                        [2, 3], [2, 3], [3, 4], torch.zeros(3))
    out = dict(loss=float(metrics["loss"]), step=int(new.step),
               rows=new.params.xyz.shape[0])

    orbit = orbit_scene()
    oparams = init_from_point_cloud(orbit.points, orbit.colors, 64,
                                    device="cpu")
    ostate = repartition_by_depth(
        init_train_state(oparams, spatial_lr_scale=orbit.extent),
        orbit.cameras, 2)
    a = activated(shard_params(ostate.params, mesh))
    out["orbit_params"] = local_leaves(ostate) if mesh.rank == 0 else None
    out["orbit_alive"] = ostate.params.alive if mesh.rank == 0 else None
    bg = torch.zeros(3)
    images = {}
    with torch.no_grad():
        for view in range(0, 8, 2):
            pm = render_partials(a.means3d, a.features, a.opacities, a.scales,
                                 a.rotations, orbit.cameras[view], sh_degree=3)
            static = merge_depth_partials(pm.rgb, pm.logt, bg,
                                          mesh.gauss_group, 2)
            ranks = view_depth_ranks(pm.depth, pm.visibility,
                                     mesh.gauss_group, 2)
            ranked = merge_depth_partials(pm.rgb, pm.logt, bg,
                                          mesh.gauss_group, 2, ranks=ranks)
            images[view] = (static, ranked)
    out["orbit_images"] = images
    return out


def sc_world1_step(ctx):
    """A B = 1 RGB step on the 1×1 mesh (small scene), for the plain step."""
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.parallel.sharded_train import (
        make_sharded_train_step,
        shard_train_state,
        unshard_state,
    )
    from event3dgs_tpu_torch.train.state import SceneData, init_train_state
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    mesh = make_mesh(timeout=TIMEOUT)
    scene = small_scene()
    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    state = shard_train_state(
        init_train_state(params, spatial_lr_scale=scene.extent), mesh)
    step = make_sharded_train_step("rgb", OptimizationConfig(), EventConfig(),
                                   mesh, spatial_lr_scale=scene.extent)
    new, metrics = step(state, SceneData(cameras=scene.cameras,
                                         images=scene.images),
                        [3], [3], [4], torch.zeros(3))
    full = unshard_state(new, mesh)
    return dict(loss=float(metrics["loss"]), xyz=full.params.xyz,
                grad_accum=full.stats.grad_accum, shape=mesh.shape)


def loop_config(threshold=1e-7):
    """Event training with a densify at view 8 (the JAX suite's sharded
    loop settings, at a threshold every visible splat crosses)."""
    from event3dgs_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig()
    cfg.pipeline.rasterizer = "tiled"
    cfg.optimization.densify_from_iter = 4
    cfg.optimization.densification_interval = 8
    cfg.optimization.densify_grad_threshold = threshold
    return cfg


def _loop_state(scene):
    from event3dgs_tpu_torch.models import init_from_point_cloud
    from event3dgs_tpu_torch.train.state import init_train_state

    params = init_from_point_cloud(scene.points, scene.colors, 64, device="cpu")
    return init_train_state(params, spatial_lr_scale=scene.extent)


def sc_loop(ctx):
    """``train_loop_sharded`` at data 2 × gauss 2 for 12 views (3 steps,
    densify after the second)."""
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.train.loop import TrainCallbacks
    from event3dgs_tpu_torch.train.loop_sharded import train_loop_sharded

    mesh = make_mesh(data=2, gauss=2, timeout=TIMEOUT)
    scene = small_scene()
    seen = []
    res = train_loop_sharded(
        _loop_state(scene), event_data(scene.cameras, scene.images),
        loop_config(), "event", scene.extent, mesh, iterations=12,
        callbacks=TrainCallbacks(on_metrics=lambda it, m: seen.append((it, m)),
                                 log_every=4))
    return dict(history=res.history, params=local_leaves(res.state),
                alive=res.state.params.alive, step=int(res.state.step),
                metrics=seen)


def sc_loop_world1(ctx):
    """On a world of one rank: ``train_loop_sharded`` (1 × 1, exact) and
    ``train_loop`` from the same state over the same views, through two
    densify passes."""
    from event3dgs_tpu_torch.parallel.mesh import make_mesh
    from event3dgs_tpu_torch.train.loop import train_loop
    from event3dgs_tpu_torch.train.loop_sharded import train_loop_sharded

    mesh = make_mesh(timeout=TIMEOUT)
    scene = small_scene()
    data = event_data(scene.cameras, scene.images)
    cfg = loop_config()
    cfg.optimization.densification_interval = 3
    cfg.optimization.densify_from_iter = 2
    sharded = train_loop_sharded(_loop_state(scene), data, cfg, "event",
                                 scene.extent, mesh, iterations=7)
    plain = train_loop(_loop_state(scene), data, cfg, "event", scene.extent,
                       iterations=7)
    return dict(sharded=sharded.history, plain=plain.history,
                sharded_xyz=sharded.state.params.xyz,
                plain_xyz=plain.state.params.xyz,
                alive=int(sharded.state.params.alive.sum()))


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items()
             if name.startswith("sc_")}


def run_scenarios(local_rank, url, world, out_dir, names):
    import torch.distributed as dist

    from event3dgs_tpu_torch.parallel.distributed import init_distributed

    info = init_distributed(url, 1, 0, local_ranks=world,
                            local_rank=local_rank, device="cpu",
                            timeout=TIMEOUT)
    try:
        results = {name: SCENARIOS[name](info) for name in names}
        torch.save(results, os.path.join(out_dir, f"rank{info.rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(tmp_dir, world, names, timeout=240):
    """Run ``names`` on ``world`` spawned ranks; their results by rank."""
    from event3dgs_tpu_torch.parallel.distributed import spawn_ranks

    os.makedirs(tmp_dir, exist_ok=True)
    url = f"file://{os.path.join(tmp_dir, 'rendezvous')}"
    spawn_ranks(run_scenarios, (url, world, str(tmp_dir), list(names)),
                nprocs=world, timeout=timeout, threads_per_rank=1)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
