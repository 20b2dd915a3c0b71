"""The share of the traced window, in percent, in which no operation ran
on the device."""


def read(ctx):
    d = ctx.digest
    if d is None or d.window_s <= 0 or not len(d.dev_start):
        return None
    return 100.0 * (1.0 - d.busy_s() / d.window_s)
