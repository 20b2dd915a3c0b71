"""repro_torch.core — LROA online client scheduling and resource
allocation (Lyapunov drift-plus-penalty + Algorithm 2), the baselines of
the paper's comparison, and the controller zoo, in PyTorch."""

from repro_torch.core.arch_bridge import (EdgeProfile, cycles_per_sample,
                                          system_params_for_arch,
                                          update_bits)
from repro_torch.core.baselines import (DivFLController,
                                        UniformDynamicController,
                                        UniformStaticController,
                                        facility_location_greedy)
from repro_torch.core.controller import (LROAController, LROAHyperParams,
                                         estimate_hyperparams,
                                         estimate_hyperparams_arrays,
                                         realized_energy,
                                         realized_round_time)
from repro_torch.core.convergence import (BoundConstants, convergence_bound,
                                          max_learning_rate,
                                          sampling_error_term)
from repro_torch.core.policy import (DECIDE_FNS, POLICIES, POLICY_IDS,
                                     SELECT_FNS, SELECTION_MODES,
                                     decide_by_id, decide_lroa,
                                     decide_uni_d, decide_uni_s,
                                     select_by_id, static_frequency)
from repro_torch.core.queues import (drift, energy_increment, init_queues,
                                     lemma1_constant, lyapunov,
                                     update_queues)
from repro_torch.core.solver import (ControlDecision, SolverConfig,
                                     p2_objective, p22_objective, solve_f,
                                     solve_p, solve_p2, solve_q)
from repro_torch.core.system_model import (SystemParams, compute_energy,
                                           compute_time, comm_energy,
                                           download_time, effective_k,
                                           expected_energy,
                                           expected_round_latency,
                                           paper_default_params,
                                           round_energy, round_time,
                                           selection_probability,
                                           upload_time, uplink_rate)
