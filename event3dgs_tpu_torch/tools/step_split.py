"""Where one replay of the graphed train step spends its device time.

    python3 -m event3dgs_tpu_torch.tools.step_split [--mode rgb|gray]
    python3 event3dgs_tpu_torch/tools/step_split.py --trees OLD . . OLD

captures the train step of ``--mode`` (event by default; rgb and gray
render the main view alone) (``train/step.GraphTrainStep`` in
``train/fused.FusedSteps``, views 1, 1 → 2) at ``bench.py``'s state (100k
Gaussians, 1080p, 4 cameras) and at ``tools/scale.py``'s 2,097,152-slot
maxcap state, profiles one replay of each (``torch.profiler``) and adds up
the device time of its kernels by group (:func:`split_group`): K1, K2, K3,
the binning's kernels (since its depth order is a radix sort of
``csrc/depth_sort.cu``, its ``argsort`` group reads 0: a library sort
kernel in the rasterizer's forward would land there, as the ``argsort`` of
an older tree does), the preprocess kernels (projection
and SH colours, ``csrc/preprocess.cu``) forward and backward, the
rasterizer's other work, the loss (its two kernels, ``csrc/loss.cu`` in
the event modes, ``csrc/ssim.cu`` in rgb and gray mode),
Adam (its kernel, ``csrc/adam.cu``, and the step counts' increments), the
densify stats, the copies outside the stages and the rest; and within each
group by CUDA function (:func:`function_label`: the kernel's name, and for
PyTorch's templated kernels the functor or kernel function it runs), with
device µs and launches.  One JSON line per state, then the card's name and
power limit, a table of the groups and one of the functions of "other"
and "rasterizer, other".  With ``--trees`` each source tree (a checkout of
this repository) runs in a fresh process, in the order given, with the
tree first on ``sys.path``: the same split of each tree's own step, in
turns.

A graph's replay runs no Python, so the stages are told apart by marker
kernels (``torch.cuda._sleep(0)``) that this tool alone adds while it
captures: :class:`stage_markers` wraps the step's stage functions so that
each marks where it begins and ends, forward and backward (identity
autograd nodes around its inputs and outputs mark the backward), and
notes each marker's label.  The preprocess stage is the step's one
``preprocess_views`` call for its three views (or, in a tree that renders
each view through ``ops/render.preprocess``, each of those calls).  The
markers' own time is printed apart.  A step captured with them is for
timing only: their identity nodes may change the order in which autograd
adds a tensor's gradients.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):  # run as a script: the repository's root,
    # or the source tree that --tree names
    _root = Path(__file__).resolve().parents[2]
    if "--tree" in sys.argv[:-1]:
        _root = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
    sys.path.insert(0, str(_root))

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
    "loss": ("event_loss_forward_kernel", "event_loss_backward_kernel",
             "photometric_loss_forward_kernel",
             "photometric_loss_backward_kernel"),
    "binning kernels": ("gaussian_table_kernel", "radix_histogram_kernel",
                        "radix_pass_kernel", "depth_offsets_kernel",
                        "expand_kernel", "segment_count_kernel",
                        "scan_kernel", "rank_kernel"),
}
# the replay split's groups of the other kernels, by the stage that
# launched them (stage_markers' labels); unlisted labels are "other"
STAGE_GROUPS = {
    "preprocess fwd": "preprocess, other",
    "preprocess bwd": "preprocess, other",
    "rasterizer fwd": "rasterizer, other",
    "rasterizer bwd": "rasterizer, other",
    "loss fwd": "loss",
    "loss bwd": "loss",
    "Adam fwd": "Adam",
    "densify stats fwd": "densify stats",
}
SPLIT_ORDER = ("K1", "K2", "K3", "binning kernels", "argsort",
               "preprocess forward", "preprocess backward",
               "preprocess, other", "rasterizer, other", "loss", "Adam",
               "densify stats", "other, copies", "other")
# the groups whose kernels the tables list by function
BY_FUNCTION = ("other", "rasterizer, other")
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


def function_label(key: str) -> str:
    """A device kernel's function as the split by function names it: its
    name (:func:`kernel_name`) and, for a templated kernel of PyTorch's,
    the functor it applies (the innermost ``...Functor...`` or
    ``..._functor`` named in its template arguments) or else the first
    kernel function named there (``exp_kernel_cuda``): ``name<functor>``."""
    name = kernel_name(key)
    key = key.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void )?[\w:]+?<(.*)>\s*\(", key)
    if not m:
        return name
    args = m.group(1)
    found = (re.findall(r"\w*[Ff]unctor\w*", args)[-1:]
             or re.findall(r"\w+_kernel\w*", args)[:1])
    return f"{name}<{found[0]}>" if found else name


def split_functions(labelled, keys) -> dict:
    """{group: {function: [device µs, launches]}} of :func:`stage_labels`'
    output, the kernels' profiler keys ``keys`` in the same order labelled
    by :func:`function_label`; the functions of a group by time, largest
    first."""
    out: dict = {}
    for (name, us, stage), key in zip(labelled, keys):
        row = out.setdefault(split_group(name, stage), {}).setdefault(
            function_label(key), [0.0, 0])
        row[0] += us
        row[1] += 1
    return {g: dict(sorted(fs.items(), key=lambda kv: -kv[1][0]))
            for g, fs in out.items()}


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
    """``obj`` (a tensor, or a tuple, list or named tuple of them, of such
    and of other values) with its tensors that require a gradient passed
    through one :class:`_Mark` of ``label``."""
    import torch

    found = []

    def collect(x):
        if isinstance(x, torch.Tensor) and x.requires_grad:
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                collect(y)

    collect(obj)
    if not found:
        return obj
    marked = iter(_Mark.apply(label, found))

    def rebuild(x):
        if isinstance(x, torch.Tensor) and x.requires_grad:
            return next(marked)
        if not isinstance(x, (tuple, list)):
            return x
        items = [rebuild(y) for y in x]
        if hasattr(x, "_fields"):
            return type(x)(*items)
        return type(x)(items)

    return rebuild(obj)


def _staged(label: str, fn):
    def staged(*args, **kw):
        _marker(f"{label} fwd")
        # backward: the stage's backward has ended where these inputs'
        # gradients are ready
        args = tuple(_marked(a, "other") for a in args)
        kw = {k: _marked(a, "other") for k, a in kw.items()}
        out = fn(*args, **kw)
        out = _marked(out, f"{label} bwd")  # backward: the stage's begins
        _marker("other")
        return out
    return staged


# (module, attribute, stage) that stage_markers wraps, where the module has
# the attribute: the step's one preprocess call for its views, or in a tree
# whose step renders each view through ops/render.render, the render's; the
# loss of each mode
STAGES = (("event3dgs_tpu_torch.train.step", "preprocess_views", "preprocess"),
          ("event3dgs_tpu_torch.ops.render", "preprocess", "preprocess"),
          ("event3dgs_tpu_torch.ops.render", "rasterize_tiled_partials",
           "rasterizer"),
          ("event3dgs_tpu_torch.train.step", "event_total_loss", "loss"),
          ("event3dgs_tpu_torch.train.step", "rgb_total_loss", "loss"),
          ("event3dgs_tpu_torch.train.step", "gray_total_loss", "loss"),
          ("event3dgs_tpu_torch.train.step", "adam_update_groups", "Adam"),
          ("event3dgs_tpu_torch.train.step", "update_stats", "densify stats"))


class stage_markers:
    """While open, the train step's stages (``STAGES``) launch a marker
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
            if not hasattr(mod, name):
                continue
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


def replay_kernels(fn, keys: list | None = None) -> list:
    """[(name, µs)] of the device kernels, copies and sets one call of
    ``fn`` ran, in the order they started (torch.profiler); their
    profiler keys appended to ``keys`` where given."""
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
    if keys is not None:
        keys += [e.name for e in evs]
    return [(kernel_name(e.name), e.time_range.elapsed_us()) for e in evs]


def replay_split(state, data, icap, dev, what: str,
                 mode: str = "event") -> dict:
    """One replay of the graphed step of ``mode`` (views 1, 1 → 2; rgb and
    gray render view 1 alone) on ``state``,
    captured with :class:`stage_markers`, profiled: device µs and kernels
    by group (:func:`split_totals`), the markers' own µs, and the device ms
    per replay of the same graph (CUDA events over 5 replays of the row,
    the cursor's reset included)."""
    import torch

    from event3dgs_tpu_torch.train.fused import FusedSteps
    from event3dgs_tpu_torch.train.step import GraphTrainStep
    from event3dgs_tpu_torch.utils.config import EventConfig, OptimizationConfig

    step = GraphTrainStep(mode, OptimizationConfig(), EventConfig(),
                          spatial_lr_scale=3.0, rasterizer="tiled",
                          instance_cap=icap)
    marks: list = []
    with stage_markers(marks):
        runner = FusedSteps(step, state, data, 1)
    row = torch.from_numpy(step.row(int(state.step) + 1, (1, 1, 2),
                                    np.zeros(3))[None])
    runner.run(row)
    keys: list = []
    kernels = replay_kernels(lambda: runner.run(row), keys)
    labelled = stage_labels(kernels, marks)
    totals = split_totals(labelled)
    functions = split_functions(
        labelled, [k for k, (name, _) in zip(keys, kernels) if name != MARKER])

    def replay():  # the table's one row again
        runner.cursor.zero_()
        runner.graph.replay()

    replay_ms = cuda_ms(replay, 5, warmup=1)
    runner.release()
    marker_us = sum(us for name, us in kernels if name == MARKER)
    return {"split": what, "mode": mode, "instance_cap": icap,
            "groups": {g: {"us": round(us, 3), "kernels": k}
                       for g, (us, k) in totals.items() if k},
            "functions": {g: {f: {"us": round(us, 3), "launches": k}
                              for f, (us, k) in fs.items()}
                          for g, fs in functions.items()},
            "device_us": sum(us for us, _ in totals.values()),
            "kernels": len(labelled), "markers": len(marks),
            "marker_us": marker_us, "replay_ms": replay_ms}




def split_runs(tree: str | None = None, mode: str = "event") -> list:
    """The replay split of ``mode``'s step at ``bench.py``'s state and at
    the 2M state, one JSON line each as it ends (marked with ``tree`` where
    given)."""
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
        out.append(replay_split(state, data, icap, dev, what, mode))
        if tree is not None:
            out[-1]["tree"] = tree
        print(json.dumps(out[-1]), flush=True)
        del state, data
        torch.cuda.empty_cache()
    return out


def print_tables(runs: list) -> None:
    """The groups of each run, then the functions of ``BY_FUNCTION``'s
    groups, device µs and kernels (launches) each."""
    head = lambda r: (f"{r.get('mode', 'event')} {r['split']} "
                      f"{r.get('tree', '')[-10:]}").strip()
    print(f"{'group':22s}" + "".join(f"{head(r):>22s}" for r in runs))
    cell = lambda d: (f"{d['us']:12.1f} us {d['kernels']:5d}k" if d
                      else f"{'-':>22s}")
    for g in SPLIT_ORDER:
        if any(g in r["groups"] for r in runs):
            print(f"{g:22s}" + "".join(cell(r["groups"].get(g))
                                       for r in runs))
    print(f"{'all kernels':22s}" + "".join(
        f"{r['device_us']:12.1f} us {r['kernels']:5d}k" for r in runs))
    print(f"{'markers':22s}" + "".join(
        f"{r['marker_us']:12.1f} us {r['markers']:5d}k" for r in runs))
    print(f"{'ms per replay':22s}" + "".join(
        f"{r['replay_ms']:15.4f} ms   " for r in runs))
    for g in BY_FUNCTION:
        names = sorted({f for r in runs for f in r["functions"].get(g, {})},
                       key=lambda f: -max(r["functions"].get(g, {}).get(
                           f, {"us": 0.0})["us"] for r in runs))
        print(f"{g + ', by function':62s}"
              + "".join(f"{head(r):>22s}" for r in runs))
        for f in names:
            print(f"  {f[-60:]:60s}" + "".join(
                f"{r['functions'][g][f]['us']:12.1f} us "
                f"{r['functions'][g][f]['launches']:5d}x"
                if f in r["functions"].get(g, {}) else f"{'-':>22s}"
                for r in runs))


def main(argv=None) -> int:
    """The replay split of this tree, or of each of ``--trees`` in turns;
    one JSON line per run, then the tables."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", help="source trees, in turns")
    parser.add_argument("--mode", default="event",
                        choices=("event", "rgb", "gray"),
                        help="the train mode whose step is split")
    parser.add_argument("--tree", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not args.trees:
        runs = split_runs(args.tree, args.mode)
        if args.tree is None:
            print(card())
            print_tables(runs)
        return 0
    runs = []
    for tree in args.trees:
        tree = str(Path(tree).resolve())
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--tree", tree, "--mode", args.mode],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"step_split: {tree} failed", file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                runs.append(json.loads(line))
    print(card())
    print_tables([r for what in ("100k", "2M") for r in runs
                  if r["split"] == what])
    return 0


if __name__ == "__main__":
    sys.exit(main())
