"""Where one replay of the graphed event step spends its device time.

    python3 -m event3dgs_tpu_torch.tools.step_split

captures the event train step (``train/step.GraphTrainStep`` in
``train/fused.FusedSteps``, views 1, 1 → 2) at ``bench.py``'s state (100k
Gaussians, 1080p, 4 cameras) and at ``tools/scale.py``'s 2,097,152-slot
maxcap state, profiles one replay of each (``torch.profiler``) and adds up
the device time of its kernels by group (:func:`split_group`): K1, K2, K3,
the binning's kernels, its ``argsort``, the preprocess kernels (projection
and SH colours, ``csrc/preprocess.cu``) forward and backward, the sums of
the three renders' feature gradients, the rasterizer's other work, the
loss (its two kernels, ``csrc/loss.cu``), Adam (its kernel,
``csrc/adam.cu``, and the step counts' increments), the densify stats, the copies outside the stages and the
rest.  One JSON line per state,
then the card's name and power limit and a table.

A graph's replay runs no Python, so the stages are told apart by marker
kernels (``torch.cuda._sleep(0)``) that this tool alone adds while it
captures: :class:`stage_markers` wraps the step's stage functions so that
each marks where it begins and ends, forward and backward (identity
autograd nodes around its inputs and outputs mark the backward), and
notes each marker's label.  The features a render takes pass through a
marker of their own on the way back, so the sum autograd takes of the
three renders' [N, K, 3] feature gradients is a group of its own.  The
markers' own time is printed apart.  A step captured with them is for
timing only: their identity nodes may change the order in which autograd
adds a tensor's gradients.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):  # run as a script: the repository's root
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from event3dgs_tpu_torch.tools.kernel_timing import (  # noqa: E402
    bench_state,
    card,
    cuda_ms,
    kernel_name,
    scale_view,
)

# the replay split's groups of the port's own CUDA functions (csrc/)
SPLIT_FUNCTIONS = {
    "K1": ("composite_forward_kernel",),
    "K2": ("composite_backward_kernel",),
    "K3": ("segment_sums_kernel", "ranges_kernel", "row_sums_kernel"),
    "preprocess forward": ("preprocess_forward_kernel",),
    "preprocess backward": ("preprocess_backward_kernel",),
    "Adam": ("adam_update_kernel",),
    "loss": ("event_loss_forward_kernel", "event_loss_backward_kernel"),
    "binning kernels": ("gaussian_table_kernel", "depth_offsets_kernel",
                        "expand_kernel", "segment_count_kernel",
                        "scan_kernel", "rank_kernel"),
}
# the replay split's groups of the other kernels, by the stage that
# launched them (stage_markers' labels); unlisted labels are "other"
STAGE_GROUPS = {
    "preprocess fwd": "preprocess, other",
    "preprocess bwd": "preprocess, other",
    "feature sums": "feature gradient sums",
    "rasterizer fwd": "rasterizer, other",
    "rasterizer bwd": "rasterizer, other",
    "loss fwd": "loss",
    "loss bwd": "loss",
    "Adam fwd": "Adam",
    "densify stats fwd": "densify stats",
}
SPLIT_ORDER = ("K1", "K2", "K3", "binning kernels", "argsort",
               "preprocess forward", "preprocess backward",
               "preprocess, other", "feature gradient sums",
               "rasterizer, other", "loss", "Adam", "densify stats",
               "other, copies", "other")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def split_group(name: str, stage: str) -> str:
    """The replay split's group of a device kernel ``name`` (as
    :func:`kernel_name` gives it) that the stage ``stage`` launched: the
    port's own kernels by name, the binning's ``argsort`` by its sort
    kernels inside the rasterizer's forward, the rest by stage; outside
    the stages the copies (``Memcpy ...``: the state copied back after the
    step) apart from the other kernels."""
    for group, functions in SPLIT_FUNCTIONS.items():
        if name in functions:
            return group
    if stage == "rasterizer fwd" and "sort" in name.lower():
        return "argsort"
    group = STAGE_GROUPS.get(stage, "other")
    if group == "other" and name.lower().startswith("memcpy"):
        return "other, copies"
    return group


def stage_labels(kernels, marks, marker: str = MARKER):
    """[(name, µs, stage)] of the device ``kernels`` [(name, µs)] in the
    order they ran, each labelled with the last of ``marks`` (the labels of
    the marker kernels, in the order they were launched) before it;
    ``"other"`` before the first marker.  The markers themselves are left
    out.  Raises if the kernels hold another number of markers."""
    seen = sum(name == marker for name, _ in kernels)
    if seen != len(marks):
        raise ValueError(f"{seen} marker kernels for {len(marks)} marks")
    out, stage, k = [], "other", 0
    for name, us in kernels:
        if name == marker:
            stage, k = marks[k], k + 1
        else:
            out.append((name, us, stage))
    return out


def split_totals(labelled) -> dict:
    """{group: [device µs, kernels]} of :func:`stage_labels`' output, in
    ``SPLIT_ORDER``."""
    out = {g: [0.0, 0] for g in SPLIT_ORDER}
    for name, us, stage in labelled:
        row = out[split_group(name, stage)]
        row[0] += us
        row[1] += 1
    return out


class _Mark:
    """An identity on tensors whose backward launches a marker kernel."""

    function = None

    @classmethod
    def apply(cls, label, tensors):
        import torch

        if cls.function is None:
            class Mark(torch.autograd.Function):
                @staticmethod
                def forward(ctx, label, *xs):
                    ctx.label = label
                    return tuple(x.view_as(x) for x in xs)

                @staticmethod
                def backward(ctx, *grads):
                    _marker(ctx.label)
                    return (None, *grads)

            cls.function = Mark
        return cls.function.apply(label, *tensors)


_MARKS: list | None = None  # the labels of the markers captured, in order


def _marker(label: str) -> None:
    """Launch a marker kernel; inside a capture, note its label."""
    import torch

    torch.cuda._sleep(0)
    if _MARKS is not None and torch.cuda.is_current_stream_capturing():
        _MARKS.append(label)


def _marked(obj, label: str):
    """``obj`` (a tensor, or a tuple, list or named tuple of them and other
    values) with its tensors that require a gradient passed through one
    :class:`_Mark` of ``label``."""
    import torch

    items = obj if isinstance(obj, (tuple, list)) else (obj,)
    where = [k for k, x in enumerate(items)
             if isinstance(x, torch.Tensor) and x.requires_grad]
    if not where:
        return obj
    marked = _Mark.apply(label, [items[k] for k in where])
    items = list(items)
    for k, x in zip(where, marked):
        items[k] = x
    if not isinstance(obj, (tuple, list)):
        return items[0]
    if hasattr(obj, "_fields"):
        return type(obj)(*items)
    return type(obj)(items)


def _staged(label: str, fn):
    def staged(*args, **kw):
        _marker(f"{label} fwd")
        # backward: the stage's backward has ended where these inputs'
        # gradients are ready; the features' gradient is then added to the
        # other renders' (autograd's sum, the next kernel on the stream)
        args = tuple(_marked(a, "other") for a in args)
        kw = {k: _marked(a, "feature sums") if k == "features" else a
              for k, a in kw.items()}
        out = fn(*args, **kw)
        out = _marked(out, f"{label} bwd")  # backward: the stage's begins
        _marker("other")
        return out
    return staged


# (module, attribute, stage) that stage_markers wraps
STAGES = (("event3dgs_tpu_torch.ops.render", "preprocess", "preprocess"),
          ("event3dgs_tpu_torch.ops.render", "rasterize_tiled_partials",
           "rasterizer"),
          ("event3dgs_tpu_torch.train.step", "event_total_loss", "loss"),
          ("event3dgs_tpu_torch.train.step", "adam_update_groups", "Adam"),
          ("event3dgs_tpu_torch.train.step", "update_stats", "densify stats"))


class stage_markers:
    """While open, the event step's stages (``STAGES``) launch a marker
    kernel where each begins and ends, forward and backward, and a capture
    notes each marker's label in ``marks``.  For the replay split only: the
    markers' identity nodes may change the order in which autograd adds a
    tensor's gradients, so a step captured with them is not bit-equal to
    the shipping step."""

    def __init__(self, marks: list):
        self.marks = marks
        self.saved = []

    def __enter__(self):
        import importlib

        global _MARKS
        _MARKS = self.marks
        for module, name, label in STAGES:
            mod = importlib.import_module(module)
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, _staged(label, getattr(mod, name)))
        return self.marks

    def __exit__(self, *exc):
        global _MARKS
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        self.saved.clear()
        _MARKS = None
        return False


def replay_kernels(fn) -> list:
    """[(name, µs)] of the device kernels, copies and sets one call of
    ``fn`` ran, in the order they started (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    evs.sort(key=lambda e: e.time_range.start)
    return [(kernel_name(e.name), e.time_range.elapsed_us()) for e in evs]


def replay_split(state, data, icap, dev, what: str) -> dict:
    """One replay of the graphed event step (views 1, 1 → 2) on ``state``,
    captured with :class:`stage_markers`, profiled: device µs and kernels
    by group (:func:`split_totals`), the markers' own µs, and the device ms
    per replay of the same graph (CUDA events over 5 replays of the row,
    the cursor's reset included)."""
    import torch

    from event3dgs_tpu_torch.train.fused import FusedSteps
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    step = GraphTrainStep("event", OptimizationConfig(), EventConfig(),
                          spatial_lr_scale=3.0, rasterizer="tiled",
                          instance_cap=icap)
    marks: list = []
    with stage_markers(marks):
        runner = FusedSteps(step, state, data, 1)
    row = torch.from_numpy(step.row(int(state.step) + 1, (1, 1, 2),
                                    np.zeros(3))[None])
    runner.run(row)
    kernels = replay_kernels(lambda: runner.run(row))
    labelled = stage_labels(kernels, marks)
    totals = split_totals(labelled)

    def replay():  # the table's one row again
        runner.cursor.zero_()
        runner.graph.replay()

    replay_ms = cuda_ms(replay, 5, warmup=1)
    runner.release()
    marker_us = sum(us for name, us in kernels if name == MARKER)
    return {"split": what, "instance_cap": icap,
            "groups": {g: {"us": round(us, 3), "kernels": k}
                       for g, (us, k) in totals.items()},
            "device_us": sum(us for us, _ in totals.values()),
            "kernels": len(labelled), "markers": len(marks),
            "marker_us": marker_us, "replay_ms": replay_ms}




def main() -> int:
    """The replay split at ``bench.py``'s state and at the 2M state, one
    JSON line each, then a table."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("step_split: needs a CUDA card")
    from event3dgs_tpu_torch.ops import kernels

    kernels.build()
    dev = torch.device("cuda")
    out = []
    for what, make in (("100k", lambda: bench_state(dev)),
                       ("2M", lambda: scale_view(dev))):
        state, data, icap = make()
        out.append(replay_split(state, data, icap, dev, what))
        print(json.dumps(out[-1]), flush=True)
        del state, data
        torch.cuda.empty_cache()
    print(card())
    print("group                 " + "".join(
        f"{r['split']:>22s}" for r in out))
    for g in SPLIT_ORDER:
        print(f"{g:22s}" + "".join(
            f"{r['groups'][g]['us']:12.1f} us {r['groups'][g]['kernels']:5d}k"
            for r in out))
    print(f"{'all kernels':22s}" + "".join(
        f"{r['device_us']:12.1f} us {r['kernels']:5d}k" for r in out))
    print(f"{'markers':22s}" + "".join(
        f"{r['marker_us']:12.1f} us {r['markers']:5d}k" for r in out))
    print(f"{'ms per replay':22s}" + "".join(
        f"{r['replay_ms']:15.4f} ms   " for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
