"""Device time (kernels and copies) per unit (a train step, or a view) in the traced
window, in ms."""


def read(ctx):
    units = ctx.work["units"]
    t = ctx.device_s()
    return 1e3 * t / units if units and t > 0 else None
