"""Training entry point (counterpart of ``event3dgs_tpu/cli/train.py``).

The reference's recommended event recipe (Readme.md:90):

    python -m event3dgs_tpu_torch.cli.train -s <colmap scene> --gray --event \\
        [--iterations 8000] [--device cuda|cpu]

Runs on the CUDA card unless ``--device cpu`` is given (then every kernel
wrapper takes its plain PyTorch version).  Writes ``cfg.json``,
``cameras.json``, ``point_cloud/iteration_N/point_cloud.ply`` at the save
iterations and ``chkpnt{N}.npz`` at the checkpoint iterations, in the
JAX package's formats, and TensorBoard scalars when the ``tensorboard``
package is installed.  ``--port`` serves the SIBR remote viewer.

Multi-GPU: ``--mesh_data D --mesh_gauss K`` trains on D·K ranks, one card
each (NCCL), through ``train/loop_sharded.py``: this process starts them
itself.  With ``--device cpu`` the ranks are gloo processes on the CPU.
Across hosts, every host runs the same command with ``--coordinator
host:port --num_processes P --process_id i`` and starts its own D·K/P
ranks (rank = i·D·K/P + local rank); a mesh factor left out takes the rest
of the job's cards (on the CPU: 1).  Only global rank 0 writes files,
logs and serves the viewer.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from event3dgs_tpu_torch.cli.common import (
    add_event_args,
    add_model_args,
    add_optimization_args,
    add_pipeline_args,
    config_from_args,
    load_scene_and_state,
    mode_from_config,
    prepare_output_dir,
)
from event3dgs_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    save_point_cloud,
)
from event3dgs_tpu_torch.train.loop import TrainCallbacks, train_loop
from event3dgs_tpu_torch.utils.device import resolve_device

DEFAULT_SAVE_ITERATIONS = [
    399, 999, 1399, 1699, 1999, 2999, 3999, 4999, 5999, 6999, 7999, 8999,
    9999, 10999, 13999,
]  # reference `train.py:413,415`


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train an Event-3DGS model")
    add_model_args(p)
    add_pipeline_args(p)
    add_optimization_args(p)
    add_event_args(p)
    p.add_argument("--test_iterations", nargs="+", type=int, default=[])
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=DEFAULT_SAVE_ITERATIONS)
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=DEFAULT_SAVE_ITERATIONS)
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    # GUI server (reference network_gui; `--port -1` disables)
    p.add_argument("--ip", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=-1)
    # the (data × gauss) rank grid (parallel/): views batch over `data`,
    # Gaussian storage shards over `gauss`; 0 = the single-device loop
    p.add_argument("--mesh_data", type=int, default=0)
    p.add_argument("--mesh_gauss", type=int, default=0)
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port (or a tcp:// or file:// URL) of the "
                        "job's rendezvous, for jobs across hosts")
    p.add_argument("--num_processes", type=int, default=None,
                   help="hosts of the job (default 1)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this host's index (default 0)")
    return p


def main(argv=None):
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if not args.source_path:
        parser.error("--source_path/-s is required")
    if args.mesh_data > 1 or args.mesh_gauss > 1 or args.coordinator:
        return launch_ranks(parser, args, argv)
    return train(args, resolve_device(args.device))


def launch_ranks(parser, args, argv) -> int:
    """Start this host's ranks of the (data × gauss) job and wait for
    them."""
    from event3dgs_tpu_torch.parallel.distributed import spawn_ranks
    from event3dgs_tpu_torch.parallel.mesh import mesh_shape

    hosts = args.num_processes or 1
    host = args.process_id or 0
    cuda = resolve_device(args.device).type == "cuda"
    data, gauss = args.mesh_data or None, args.mesh_gauss or None
    if data is None or gauss is None:
        # a missing factor takes the rest of the job's cards; on the CPU it
        # is 1 (one rank per host when both are missing)
        if cuda:
            n = torch.cuda.device_count() * hosts
        elif data is None and gauss is None:
            n = hosts
        else:
            n = (data or 1) * (gauss or 1)
        data, gauss = mesh_shape(n, data, gauss)
    world = data * gauss
    if world % hosts:
        parser.error(f"mesh {data}x{gauss} does not split over {hosts} hosts")
    local = world // hosts
    if cuda and local > torch.cuda.device_count():
        parser.error(f"{local} ranks per host need {local} CUDA cards, "
                     f"found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        coordinator = args.coordinator or f"file://{tmp}/rendezvous"
        spawn_ranks(_rank_main,
                    (argv, coordinator, hosts, host, local, data, gauss),
                    nprocs=local,
                    threads_per_rank=None if cuda
                    else max(1, (os.cpu_count() or 1) // local))
    return 0


def _rank_main(local_rank, argv, coordinator, hosts, host, local, data,
               gauss):
    import torch.distributed as dist

    from event3dgs_tpu_torch.parallel.distributed import (
        init_distributed,
        make_global_mesh,
    )

    args = build_parser().parse_args(argv)
    info = init_distributed(coordinator, hosts, host, local_ranks=local,
                            local_rank=local_rank,
                            device=resolve_device(args.device).type)
    try:
        mesh = make_global_mesh(data, gauss, device=info.device)
        train(args, info.device, mesh)
    finally:
        dist.destroy_process_group()


def train(args, device: torch.device, mesh=None) -> int:
    """Train on ``device``: alone, or as one rank of ``mesh``."""
    import torch.distributed as dist

    lead = mesh is None or dist.get_rank() == 0  # writes files and logs
    cfg = config_from_args(args)
    cfg.save_iterations = tuple(
        sorted(set(args.save_iterations) | {cfg.optimization.iterations}))
    cfg.checkpoint_iterations = tuple(args.checkpoint_iterations)
    cfg.test_iterations = tuple(args.test_iterations)
    cfg.seed = args.seed
    mode = mode_from_config(cfg)

    info, data, state, extent = load_scene_and_state(cfg, device)
    model_path = prepare_output_dir(cfg, info) if lead else None
    if lead:
        print(f"Optimizing {model_path} [mode={mode}, {data.num_views} "
              f"views, extent {extent:.2f}, {int(state.params.alive.sum())} "
              f"gaussians, device {device}]")

    if args.start_checkpoint:
        state, start_iter = load_checkpoint(args.start_checkpoint, state)
        if lead:
            print(f"resumed from {args.start_checkpoint} at iteration "
                  f"{start_iter}")

    gui = None
    if args.port > 0 and lead:
        from event3dgs_tpu_torch.train.network_gui import NetworkGui

        gui = NetworkGui(args.ip, args.port, state, data, cfg)
        gui.start()

    # TensorBoard scalars (reference `training_report`, `train.py:360-398`)
    tb = None
    if lead:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(model_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")

    def on_metrics(it, metrics):
        if not lead:
            return
        if tb is not None and "loss" in metrics:
            tb.add_scalar("train_loss_patches/total_loss",
                          float(metrics["loss"]), it)
            if "l1" in metrics:
                tb.add_scalar("train_loss_patches/l1_loss",
                              float(metrics["l1"]), it)
            if "contrast" in metrics:
                tb.add_scalar("event/contrast", float(metrics["contrast"]), it)
            if "num_visible" in metrics:
                tb.add_scalar("total_points", int(metrics["num_visible"]), it)
        if args.quiet:
            return
        if "loss" in metrics:
            extra = ""
            if "contrast" in metrics:
                extra = f" c={float(metrics['contrast']):.4f}"
            print(f"[{it:6d}] loss={float(metrics['loss']):.6f}{extra}",
                  flush=True)
        else:
            print(f"[{it:6d}] " + " ".join(f"{k}={v}" for k, v in metrics.items()),
                  flush=True)

    def on_save(it, st):
        if lead:
            print(f"\n[ITER {it}] Saving Gaussians")
            save_point_cloud(model_path, it, st)

    def on_checkpoint(it, st):
        if lead:
            print(f"\n[ITER {it}] Saving Checkpoint")
            save_checkpoint(os.path.join(model_path, f"chkpnt{it}.npz"), st, it)

    callbacks = TrainCallbacks(on_metrics=on_metrics, on_save=on_save,
                               on_checkpoint=on_checkpoint, log_every=100)
    if gui is not None:
        callbacks = gui.wrap_callbacks(callbacks)
    elif args.port > 0:
        # the other ranks take part in the lead's state gathers
        callbacks.on_tick = lambda it, st: None

    if mesh is None:
        result = train_loop(state, data, cfg, mode, extent, callbacks=callbacks)
    else:
        from event3dgs_tpu_torch.train.loop_sharded import train_loop_sharded

        if lead:
            print(f"mesh: data={mesh.data} gauss={mesh.gauss} "
                  f"({cfg.pipeline.gauss_mode})")
        result = train_loop_sharded(state, data, cfg, mode, extent, mesh,
                                    callbacks=callbacks)
    # optimizer steps drive the rate; views consumed differ by the batch
    n_steps = len(result.history)
    if lead:
        print(f"\nTraining complete: {n_steps} optimizer steps "
              f"({int(result.state.step)} views) in {result.wall_time:.1f}s "
              f"({n_steps / max(result.wall_time, 1e-9):.1f} steps/s); "
              f"last loss "
              f"{result.history[-1] if n_steps else float('nan'):.6f}",
              flush=True)
    if tb is not None:
        tb.close()
    if gui is not None:
        gui.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
