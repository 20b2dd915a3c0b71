"""repro_torch.kernels — the port's hand-written CUDA kernels.

* ``ops`` — the public wrappers (``fl_aggregate``, ``fl_delta_reduce``)
  and the one dispatch rule ``use_cuda_kernel``;
* ``fl_aggregate`` — the binding of ``csrc/fl_aggregate.cu`` and its
  launch counter;
* ``ref`` — the plain PyTorch versions the kernels are held against.

The kernel modules build their CUDA sources lazily, at the first launch,
so importing this package needs neither ``nvcc`` nor a card."""
