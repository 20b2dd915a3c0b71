"""repro_torch.launch — step builders (``steps``) and the greedy serving
loop (``serve``) for the LM path."""
