"""Training entry point (counterpart of ``event3dgs_tpu/cli/train.py``).

The reference's recommended event recipe (Readme.md:90):

    python -m event3dgs_tpu_torch.cli.train -s <colmap scene> --gray --event \\
        [--iterations 8000] [--device cuda|cpu]

Runs on the CUDA card unless ``--device cpu`` is given (then every kernel
wrapper takes its plain PyTorch version).  Writes ``cfg.json``,
``cameras.json``, ``point_cloud/iteration_N/point_cloud.ply`` at the save
iterations and ``chkpnt{N}.npz`` at the checkpoint iterations, in the
JAX package's formats.  The multi-chip mesh (``--mesh_data``,
``--mesh_gauss``, ``--coordinator``) and the GUI server (``--port``) are
not yet ported and are rejected.
"""

from __future__ import annotations

import argparse
import os

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
    p.add_argument("--ip", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=-1)
    p.add_argument("--mesh_data", type=int, default=0)
    p.add_argument("--mesh_gauss", type=int, default=0)
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.source_path:
        parser.error("--source_path/-s is required")
    for flag, on in (("--mesh_data/--mesh_gauss",
                      args.mesh_data > 1 or args.mesh_gauss > 1),
                     ("--coordinator", args.coordinator is not None),
                     ("--port", args.port > 0)):
        if on:
            parser.error(f"{flag} is not yet ported to event3dgs_tpu_torch "
                         "(the JAX package's event3dgs_tpu.cli.train has it)")
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    cfg.save_iterations = tuple(
        sorted(set(args.save_iterations) | {cfg.optimization.iterations}))
    cfg.checkpoint_iterations = tuple(args.checkpoint_iterations)
    cfg.test_iterations = tuple(args.test_iterations)
    cfg.seed = args.seed
    mode = mode_from_config(cfg)

    info, data, state, extent = load_scene_and_state(cfg, device)
    model_path = prepare_output_dir(cfg, info)
    print(f"Optimizing {model_path} [mode={mode}, {data.num_views} views, "
          f"extent {extent:.2f}, {int(state.params.alive.sum())} gaussians, "
          f"device {device}]")

    if args.start_checkpoint:
        state, start_iter = load_checkpoint(args.start_checkpoint, state)
        print(f"resumed from {args.start_checkpoint} at iteration {start_iter}")

    def on_metrics(it, metrics):
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
        print(f"\n[ITER {it}] Saving Gaussians")
        save_point_cloud(model_path, it, st)

    def on_checkpoint(it, st):
        print(f"\n[ITER {it}] Saving Checkpoint")
        save_checkpoint(os.path.join(model_path, f"chkpnt{it}.npz"), st, it)

    callbacks = TrainCallbacks(on_metrics=on_metrics, on_save=on_save,
                               on_checkpoint=on_checkpoint, log_every=100)
    result = train_loop(state, data, cfg, mode, extent, callbacks=callbacks)
    n_steps = len(result.history)
    print(f"\nTraining complete: {n_steps} optimizer steps in "
          f"{result.wall_time:.1f}s "
          f"({n_steps / max(result.wall_time, 1e-9):.1f} steps/s); "
          f"last loss {result.history[-1] if n_steps else float('nan'):.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
