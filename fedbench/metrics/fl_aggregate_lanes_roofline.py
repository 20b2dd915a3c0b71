"""The eq.-(4) lane kernel's share of its roofline, in percent: the bytes
every lane's step reads and writes once (``fedbench.flops``) over the
HBM's 3.35 TB/s, against the kernel's device time in the window."""

import numpy as np

from fedbench import flops


def read(ctx):
    d = ctx.digest
    if d is None or not ctx.rounds:
        return None
    hits = np.asarray(["fl_aggregate_kernel" in n for n in d.dev_name],
                      bool)
    if not np.any(hits):
        return None
    seconds = float(np.sum(d.dev_dur[hits])) * 1e-9
    nbytes = ctx.rounds * flops.aggregate_lanes_bytes(ctx.lanes, ctx.k,
                                                      ctx.params)
    return 100.0 * nbytes / flops.HBM_BYTES_PER_S / seconds
