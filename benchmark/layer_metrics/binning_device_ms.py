"""Device time per unit (a train step, or a view) of the binning's kernels (the frozen
step_split group: tables, radix depth order, offsets, expansion, counting sort), in ms."""


def read(ctx):
    units = ctx.work["units"]
    t = ctx.group_s("binning")
    return 1e3 * t / units if units and t > 0 else None
