"""CUDA runtime launch calls per lane-round of the traced rounds: the
local-SGD data plane's dispatch, with the controllers' and the
evaluation's."""

from fedbench.harness import profile


def read(ctx):
    d = ctx.digest
    if d is None or not ctx.rounds:
        return None
    launches = sum(1 for n in d.rt_name if n in profile.LAUNCH_CALLS)
    if not launches:
        return None
    return launches / (ctx.rounds * ctx.lanes)
