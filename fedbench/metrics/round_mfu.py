"""The whole round's share of the card's peak, in percent: the model work
of local training (3 forwards' products for every true example each
live client trains, by ``fedbench.flops``) over the seconds those rounds
took, against the peak of the precision the products run in.  A traced
run counts only the window's rounds after the profiler stopped, so the
profiler's own cost on the host is not in it."""


def read(ctx):
    if not ctx.mfu_s or not ctx.peak_flops:
        return None
    return 100.0 * ctx.work_flops / ctx.mfu_s / ctx.peak_flops
