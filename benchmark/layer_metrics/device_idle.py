"""Share of the traced window in which no kernel or copy ran on the card
(profiler timeline), in %."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
