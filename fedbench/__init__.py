"""The benchmark of ``repro_torch``: the paper's controller comparison as
arena grids (``python3 fedbench/run.py --workload <cell> ...``)."""
