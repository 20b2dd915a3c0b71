"""repro_torch.core — LROA online client scheduling and resource
allocation (Lyapunov drift-plus-penalty + Algorithm 2), in PyTorch."""

from repro_torch.core.controller import (LROAController, LROAHyperParams,
                                         estimate_hyperparams,
                                         realized_round_time)
from repro_torch.core.policy import decide_lroa
from repro_torch.core.queues import (energy_increment, init_queues,
                                     update_queues)
from repro_torch.core.solver import (ControlDecision, SolverConfig, solve_f,
                                     solve_p, solve_p2, solve_q)
from repro_torch.core.system_model import (SystemParams, compute_energy,
                                           compute_time, comm_energy,
                                           expected_energy,
                                           expected_round_latency,
                                           paper_default_params,
                                           round_energy, round_time,
                                           selection_probability,
                                           upload_time, uplink_rate)
