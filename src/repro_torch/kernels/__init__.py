"""repro_torch.kernels — the port's hand-written CUDA kernels.

* ``ops`` — the public wrappers (``fl_aggregate``, ``fl_aggregate_leaves``,
  ``fl_aggregate_lanes``, ``fl_delta_reduce``, ``fl_delta_reduce_leaves``,
  ``flash_attention``, ``ssd_chunk``) and the one dispatch rule
  ``use_cuda_kernel``;
* ``fl_aggregate``, ``flash_attention``, ``ssd_scan`` — the bindings of
  ``csrc/fl_aggregate.cu``, ``csrc/flash_attention.cu`` and
  ``csrc/ssd_chunk.cu``, each with its launch counter ``LAUNCHES``;
* ``ref`` — the plain PyTorch versions the kernels are held against;
* ``_build`` — ``nvcc`` at first use, one process per source, and
  ``refuse_grad``, the check every wrapper makes: a kernel reached with
  grad enabled and an input that requires grad raises (the kernels with
  a backward run inside their ``autograd.Function``, where grad is off).

The kernel modules build their CUDA sources lazily, at the first launch,
so importing this package needs neither ``nvcc`` nor a card."""
