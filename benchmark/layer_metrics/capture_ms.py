"""Milliseconds of the window call's CUDA graph capture (its two warm-up
steps and the capture), as train_loop reports it to on_metrics
(graph_capture_ms)."""

import math


def read(ctx):
    v = ctx.work["counters"].get("capture_ms")
    return None if v is None or not math.isfinite(v) else float(v)
