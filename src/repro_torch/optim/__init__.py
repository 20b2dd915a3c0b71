"""repro_torch.optim — heavy-ball SGD and learning-rate schedules."""

from repro_torch.optim.schedule import constant, paper_step_decay, step_decay
from repro_torch.optim.sgd import SGD, apply_updates
