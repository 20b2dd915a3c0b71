"""repro_torch.launch — step builders (``steps``: prefill, decode, the
train step and the FL round step), the greedy serving loop (``serve``)
and the LM training driver (``train``)."""
