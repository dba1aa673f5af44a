"""The port's benchmark: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``
entry and ``benchmark/workloads/<cell>.json``) names its configuration
(``benchmark/configs/<config>.json``) and its traffic driver
(``benchmark/traffic/<traffic>.py``); the per-layer metrics are readers in
``benchmark/layer_metrics/<metric>.py``.  All are found by name, so a new
cell, configuration, driver or metric is a new file.

A run builds the port's kernels it uses (into the port's ``csrc/build/``
inside the checkout), makes its scene from ``--seed`` on the card, warms
up, measures for ``--seconds`` (``--trace 1``: under ``torch.profiler``,
reporting the per-layer metrics), checks what the window's path produced
against the plain reference, and prints one JSON line last on standard
output; the numbers compared, each beside its limit, are the last lines of
standard error.  It fails without a CUDA card, and if JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build caches at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "event3dgs_tpu")
GIB = float(1 << 30)


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (names compared whole: the port's begins with the
    JAX package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, root: Path = ROOT):
    """(manifest entry, cell file, configuration file) of cell ``name``."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[entry["config"]]["file"])
    wl = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    return entry, wl, cfg


def applies(metric: dict, cell_name: str, reported=None) -> bool:
    """Whether ``metric`` is reported in the cell: listed there, or, with
    no list, everywhere its ``moves`` is reported (``reported``)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def reader_path(name: str, root: Path = ROOT) -> Path:
    """The reader of per-layer metric ``name``: ``layer_metrics/<name>.py``,
    or else the one of its base name, the part before the first dot
    (``device_idle.py`` reads ``device_idle.train`` and any other suffix)."""
    folder = root / "benchmark" / "layer_metrics"
    own = folder / f"{name}.py"
    return own if own.is_file() else folder / f"{name.split('.')[0]}.py"


def load_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` of per-layer metric ``name``."""
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(f"benchmark_layer_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Tracer:
    """Opens and closes the window: with tracing, ``torch.profiler`` over
    CPU and CUDA activities.  ``opened`` and ``closed`` are the host clock
    at the window's bounds (the profiler already running at the first)."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.prof = None
        self.opened = self.closed = None

    def start(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.opened = time.perf_counter()

    def stop(self):
        if self.trace:
            torch.cuda.synchronize()
        self.closed = time.perf_counter()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)


class Harness:
    """What a traffic driver is given: the configuration and the cell's
    parameters, the seed, the device, the window's tracer and the
    checkout's root."""

    def __init__(self, cfg, wl, seed, device, tracer, t_start=T_START,
                 root: Path = ROOT):
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.device, self.tracer, self.t_start = device, tracer, t_start
        self.root = root  # the checkout, where the target cache lives

    def log(self, what: str) -> None:
        """A progress line on standard error, stamped with the seconds
        since the process started."""
        print(f"[bench +{time.perf_counter() - self.t_start:.2f}s] {what}",
              file=sys.stderr, flush=True)


def device_activity(prof):
    """(device intervals [(start_ns, end_ns, name)], host events [(start_ns,
    end_ns, name)]) of a profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if d > 0:
                dev.append((s, s + d, e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    return dev, host


def busy_intervals(dev):
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def gap_label(host, s, e) -> str:
    """What the host was doing over an idle gap of the device: the
    innermost host event over its middle, or else the last host event
    that began before the gap ended (the call that ended it)."""
    mid, over, last = (s + e) / 2, None, None
    for hs, he, name in host:
        if hs > e:
            break
        if not name or name.startswith("ProfilerStep"):
            continue
        if hs <= mid <= he and (over is None or he - hs < over[1] - over[0]):
            over = (hs, he, name)
        last = name
    if over is not None:
        return over[2]
    return f"host between events, then {last}" if last else "no host event"


def trace_context(prof):
    """The traced window's device time by function, busy seconds and the
    breakdown's lists."""
    from benchmark.counts.groups import group_of, kernel_name

    dev, host = device_activity(prof)
    by_function = {}
    for s, e, name in dev:
        k = kernel_name(name)
        t, n = by_function.get(k, (0.0, 0))
        by_function[k] = (t + (e - s) * 1e-9, n + 1)
    merged = busy_intervals(dev)
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:10]
    host.sort()
    breakdown = {
        "device_ops": [[f"{group_of(k)}: {k}", t] for k, (t, _) in
                       sorted(by_function.items(), key=lambda x: -x[1][0])[:10]],
        "idle_gaps": [[gap_label(host, s, e), g * 1e-9] for g, s, e in gaps],
    }
    return by_function, busy, breakdown


class Context:
    """What a per-layer reader reads: device seconds and launches by
    function in the traced window (``by_function``), the busy and window
    seconds, and the traffic driver's ``work``: ``units`` (steps or views
    in the window), ``least_ms`` (the frozen counts' least times and FP32
    operations of a unit, averaged over the window's units), ``launches``
    (a kernel group's launches a unit) and ``counters``."""

    def __init__(self, by_function, busy_s, window_s, work):
        self.by_function, self.busy_s, self.window_s = by_function, busy_s, window_s
        self.work = work

    def group_s(self, group: str) -> float:
        from benchmark.counts.groups import group_of

        return sum(t for k, (t, _) in self.by_function.items() if group_of(k) == group)

    def per_launch_s(self, group: str):
        """Device seconds of one launch of the group's functions, or None
        where the trace saw none."""
        from benchmark.counts.groups import group_of

        t = n = 0
        for k, (s, c) in self.by_function.items():
            if group_of(k) == group:
                t, n = t + s, n + c
        return t / n if n else None

    def device_s(self) -> float:
        return sum(t for t, _ in self.by_function.values())


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, root: Path = ROOT, device=None, t_start: float = T_START) -> dict:
    """One run → the result line's dict and the checks.  ``device`` other
    than a card is for the harness's own tests."""
    bench = manifest(root)
    entry, wl, cfg = cell(bench, args.workload, root)
    if device is None:
        chips = int(entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"needs {chips} CUDA card(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the context, before the peak's reset
        torch.cuda.reset_peak_memory_stats(device)
    on_card = device.type == "cuda"
    tracer = Tracer(bool(args.trace) and on_card)
    h = Harness(cfg, wl, args.seed, device, tracer, t_start, root)
    driver = importlib.import_module(f"benchmark.traffic.{wl['traffic']}").Driver(h)
    driver.setup()
    h.log("set-up done")
    e2e = driver.window(args.seconds)
    h.log(f"window closed: {e2e}")
    e2e["setup_s"] = tracer.opened - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e["train_peak_gib"] = peak / GIB
    traced = None
    if tracer.prof is not None:
        traced = trace_context(tracer.prof)
        tracer.prof = None
        h.log("launches seen: " + ", ".join(
            f"{k} {n}" for k, (_, n) in sorted(traced[0].items()) if n >= 10))
    driver.release()
    gc.collect()
    checks = driver.check()
    h.log("check done")
    gc.collect()
    reported = [m["name"] for m in bench["end_to_end"] if applies(m, entry["name"])]
    if args.trace:
        ctx = Context(*(traced[:2] if traced else ({}, 0.0)),
                      tracer.closed - tracer.opened, driver.work())
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, entry["name"], reported):
                v = load_reader(m["name"], root)(ctx)
                h.log(f"{m['name']} = {v}")
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] in reported}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else str(device),
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    if args.trace:
        dev["busy_s"] = traced[1] if traced else 0.0
        dev["window_s"] = tracer.closed - tracer.opened
    out = {"correct": all(c.ok for c in checks),
           "attempted": int(driver.units),
           "failed": 0, "metrics": metrics, "device": dev}
    if traced:
        out["breakdown"] = traced[2]
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                              "limit": c.limit} for c in checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    try:
        out = run(args)
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
