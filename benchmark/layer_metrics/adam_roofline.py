"""Adam's (the optimizer's update) share of its roofline, in %: its least time by the
frozen counts at the step's floats (adam_bound), over its device time per step (the
mean time of a launch the trace saw, times the launches a step makes)."""


def read(ctx):
    one = ctx.per_launch_s("Adam")
    if one is None:
        return None
    least = ctx.work["least_ms"]["adam_ms"]
    return 100.0 * least / (1e3 * one * ctx.work["launches"]["Adam"])
