"""Seconds a round the data plane's stream waits on the host inside the
program's ``engine.lanes_round`` spans: the span's device time (CUDA
events at its enter and exit, the program tracer's ``device_s``) less
the union of the device intervals of the kernels launched inside it
(``sgd_device_s_per_round``).  Nothing without a device, or from a
program whose tracer keeps no device time."""

from fedbench.metrics import sgd_device_s_per_round


def read(ctx):
    from repro_torch.obs import trace

    totals = getattr(trace, "totals", None)
    if totals is None or not ctx.rounds:
        return None
    row = totals().get("engine.lanes_round")
    if not row or row.get("device_s") is None:
        return None
    busy = sgd_device_s_per_round.read(ctx)
    if busy is None:
        return None
    return row["device_s"] / ctx.rounds - busy
