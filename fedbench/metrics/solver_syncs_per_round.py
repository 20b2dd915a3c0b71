"""The solver's read-backs a round: ``solver.loop_tests``, one count per
tolerance test of the SUM loop and of Algorithm 2's outer loop (each
reads its convergence norm back to the host), summed over every span it
was counted under, from the program tracer's totals over the traced
rounds.  A program whose tracer keeps no totals gives nothing."""


def read(ctx):
    from repro_torch.obs import trace

    totals = getattr(trace, "totals", None)
    if totals is None or not ctx.rounds:
        return None
    tests = sum(row["counters"].get("solver.loop_tests", 0)
                for row in totals().values())
    if not tests:
        return None
    return tests / ctx.rounds
