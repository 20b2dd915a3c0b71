"""Host seconds a round spends in the controllers' ``scan.select`` spans:
each lane's selection rule (the DivFL greedy among them), its epoch keys
and its eq.-(4) coefficients, from the program tracer's totals over the
traced rounds.  A program whose tracer keeps no totals gives nothing."""


def read(ctx):
    from repro_torch.obs import trace

    totals = getattr(trace, "totals", None)
    if totals is None or not ctx.rounds:
        return None
    row = totals().get("scan.select")
    if not row or not row["calls"]:
        return None
    return row["host_s"] / ctx.rounds
