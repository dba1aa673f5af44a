"""K1's (the compositing forward) share of its roofline, in %: its least time by the
frozen counts, averaged over the window's units (steps or views) at their own views,
over its device time per unit (the mean time of a launch the trace saw, times the
launches a unit makes)."""


def read(ctx):
    one = ctx.per_launch_s("K1")
    if one is None:
        return None
    least = ctx.work["least_ms"]["k1_ms"]
    return 100.0 * least / (1e3 * one * ctx.work["launches"]["K1"])
