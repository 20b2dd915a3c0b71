"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same layout as the JAX package (``checkpoint/``, ``core/``, ``data/``,
``fl/``, ``kernels/``, ``models/``, ``optim/``, ``obs/``, ``sim/``) and
the same names, so each module's counterpart is easy to find.  The port imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of ``repro``: what it needs
from the JAX package's numpy-only modules is copied here.

Entry points (``FederatedTrainer``, ``RoundEngine`` and its
``run_scan`` rollout, ``ClientBank``, ``SystemParams``, the scenario
arena ``sim.Arena`` with its ``EvalBank`` and the ``sim.SweepService``,
the LMs of ``launch.steps.build_model`` and ``core.arch_bridge``'s
``system_params_for_arch``; the controllers
``LROAController`` and ``core.baselines``' run on the params' device)
default to ``device="cuda"``; pass ``device="cpu"`` to run the plain
PyTorch path, as the tests do.
"""
