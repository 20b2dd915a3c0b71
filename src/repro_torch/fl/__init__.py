"""repro_torch.fl — the federated learning substrate: Algorithm 1 loop,
K-client batched local SGD, eq.-(4) aggregation, the seeded channel
process and the lane-batched device channel samplers, the
device-resident client banks (the single bucket, the tier ladder, the
slot pool; int8 storage and cluster routing), and the round engine
with its multi-round rollout (``RoundEngine.run_scan``) and the arena's
lane body."""

from repro_torch.fl.client import (ClientConfig, Task, batched_local_sgd,
                                   flatten_update, local_update)
from repro_torch.fl.client_bank import (BankPool, ClientBank,
                                        TieredClientBank,
                                        estimate_bank_nbytes)
from repro_torch.fl.environment import (CHANNEL_MODE_IDS, CHANNEL_MODES,
                                        ChannelConfig, ChannelProcess,
                                        HeterogeneityConfig,
                                        heterogeneous_params,
                                        markov_stationary,
                                        sample_channel_sequence,
                                        sample_dropout_mask, sample_gains,
                                        sample_gains_markov,
                                        sample_markov_states)
from repro_torch.fl.round_engine import RoundEngine
from repro_torch.fl.server import (ParamRavel, aggregate, aggregate_fused,
                                   aggregate_fused_lanes,
                                   aggregate_hierarchical,
                                   aggregate_stacked, aggregation_weights,
                                   fedavg_reference, sample_clients,
                                   stack_deltas)
from repro_torch.fl.trainer import FederatedTrainer, FLRunResult, RoundRecord
