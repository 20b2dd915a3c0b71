"""Per-layer metric readers, one file each, found by the metric's name in
``BENCHMARK.json``: ``read(ctx)`` returns the value, or None where the
run gave it nothing to read (the harness then leaves the metric out).
``ctx`` is ``fedbench.harness.main.Context``."""
