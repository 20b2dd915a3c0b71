"""repro_torch.optim — heavy-ball SGD, global-norm clipping and
learning-rate schedules."""

from repro_torch.optim.schedule import constant, paper_step_decay, step_decay
from repro_torch.optim.sgd import (SGD, apply_updates, clip_by_global_norm,
                                   global_norm)
