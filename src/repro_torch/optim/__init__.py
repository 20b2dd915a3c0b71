"""repro_torch.optim — SGD with momentum, AdamW, global-norm clipping and
learning-rate schedules."""

from repro_torch.optim.schedule import (constant, cosine, paper_step_decay,
                                        step_decay)
from repro_torch.optim.sgd import (SGD, AdamW, AdamWState, SGDState,
                                   apply_updates, clip_by_global_norm,
                                   global_norm)
