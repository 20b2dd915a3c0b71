"""Device seconds a round during which a kernel launched inside the
program's ``engine.lanes_round`` spans ran (the gather, the batched local
SGD and the eq.-(4) launch of every lane): the union of those kernels'
intervals, since cuDNN runs some of them side by side."""

import numpy as np

from fedbench.harness import profile


def read(ctx):
    d = ctx.digest
    if d is None or not ctx.rounds or not len(d.spans["engine.lanes_round"]):
        return None
    launched = d.dev_launch >= 0
    if not np.any(launched):
        return None
    inside = launched & profile.within(d.dev_launch,
                                       d.spans["engine.lanes_round"])
    if not np.any(inside):
        return None
    iv = profile.union(d.dev_start[inside], d.dev_dur[inside])
    return float(np.sum(iv[:, 1] - iv[:, 0])) * 1e-9 / ctx.rounds
