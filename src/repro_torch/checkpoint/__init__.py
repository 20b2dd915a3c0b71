"""repro_torch.checkpoint — npz checkpointing of nested dicts of tensors."""

from repro_torch.checkpoint.checkpoint import (checkpoint_exists,
                                               delete_checkpoint,
                                               latest_step, restore_arrays,
                                               restore_checkpoint,
                                               save_checkpoint)
