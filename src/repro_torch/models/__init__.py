"""repro_torch.models — the FL image-classification tasks (CNN, ResNet,
MLP) and the LM serving and training path (``config``, ``layers``,
``flash``, ``attention``, ``ssm``, ``moe``, ``rglru``, ``vlm``,
``transformer``, ``encdec``)."""

from repro_torch.models.cnn import CNNTask, MLPTask, ResNetTask
