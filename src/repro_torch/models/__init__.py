"""repro_torch.models — the FL image-classification tasks (CNN, MLP)."""

from repro_torch.models.cnn import CNNTask, MLPTask
