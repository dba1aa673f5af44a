"""The whole unit's (a train step's, or a view's) share of the card's FP32 peak, in %:
its FP32 operations by the frozen counts (benchmark/counts), averaged over the
window's units at their own views, over the traced window's time per unit times
33.5 T op/s (67 TFLOP/s, an FMA as one operation)."""

from benchmark.counts.bounds import PEAK_FP32_PER_S


def read(ctx):
    w = ctx.work
    if not w["units"] or ctx.window_s <= 0:
        return None
    seconds = ctx.window_s / w["units"]
    return 100.0 * w["least_ms"]["fp32_ops"] / (seconds * PEAK_FP32_PER_S)
