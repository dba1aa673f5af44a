"""K2's (the compositing backward) share of its roofline, in %: its least time by the
frozen counts, averaged over the window's steps at their own views, over its device
time per step (the mean time of a launch the trace saw, times the launches a step
makes)."""


def read(ctx):
    one = ctx.per_launch_s("K2")
    if one is None:
        return None
    least = ctx.work["least_ms"]["k2_ms"]
    return 100.0 * least / (1e3 * one * ctx.work["launches"]["K2"])
