"""Host seconds a round spends in the controllers' ``scan.decide`` spans,
less the seconds the host waits in CUDA synchronising calls inside them
(the drain of the previous round's data plane that the first decide of a
round absorbs, and each loop test's read-back)."""

import numpy as np

from fedbench.harness import profile


def read(ctx):
    d = ctx.digest
    if d is None or not len(d.spans["scan.decide"]) or not ctx.rounds:
        return None
    ranges = d.spans["scan.decide"]
    total = float(np.sum(ranges[:, 1] - ranges[:, 0]))
    waits = np.asarray([n in profile.WAIT_CALLS for n in d.rt_name], bool)
    starts, durs = d.rt_start[waits], d.rt_dur[waits]
    inside = profile.within(starts, ranges)
    return (total - float(np.sum(durs[inside]))) * 1e-9 / ctx.rounds
