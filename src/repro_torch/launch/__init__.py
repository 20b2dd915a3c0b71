"""repro_torch.launch — step builders (``steps``: prefill, decode, the
train step and the FL round step), the greedy serving loop (``serve``),
the LM training driver (``train``), the FL mesh over
``torch.distributed`` (``mesh``) and spawned worlds of ranks on one
machine (``world``)."""
