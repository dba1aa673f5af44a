"""Device time per train step of the loss kernels (event loss or SSIM loss, forward
and backward), in ms."""


def read(ctx):
    units = ctx.work["units"]
    t = ctx.group_s("loss")
    return 1e3 * t / units if units and t > 0 else None
