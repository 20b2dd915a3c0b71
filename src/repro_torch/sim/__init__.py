"""repro_torch.sim — the scenario arena: the paper's comparison grid
(``ScenarioGrid``) as one lane-batched rollout (``Arena``) with the
control plane per lane and the data plane batched, evaluated on the
device (``EvalBank``), reported as a ``RolloutReport`` with the Sec. VII
trade-off reducers; shape-adaptive dispatch (``k_mode='auto'``, copies of
the JAX package's dispatch planner and cost model), chunked checkpointed
runs and the ``SweepService`` over them (queued, coalesced submissions,
kill and resume through ``NpzChunkStore``); ``Arena.warmup`` and
``SweepService.warmup`` run a grid's bucket signatures ahead, for the
retrace watchdog (``repro_torch.obs.Watchdog``); the drivers' testbed
(``testbed``: ``BenchConfig``, ``build_testbed``, ``make_trainer``,
``run_controller``)."""

from repro_torch.sim.arena import (CHANNEL_STREAM, Arena, ScenarioGrid,
                                   aot_cache_warmup_supported,
                                   derive_hyperparams, scenario_keys)
from repro_torch.sim.cost_model import CostModel
from repro_torch.sim.dispatch import (DispatchBucket, DispatchPlan,
                                      lane_footprints, plan_dispatch)
from repro_torch.sim.eval import EvalBank
from repro_torch.sim.report import RolloutReport, concat_chunk_metrics
from repro_torch.sim.service import (CHUNK_STORE_SCHEMA_VERSION,
                                     NpzChunkStore, SweepService)
from repro_torch.sim.testbed import (CONTROLLERS, BenchConfig,
                                     build_testbed, make_trainer,
                                     run_controller)
