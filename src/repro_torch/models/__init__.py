"""The port's models: the LM stack (dense, MoE, SSM, hybrid and audio
families: layers, ``moe``, ``ssm``, model assembly), the ViT
(``vision``) and the import of the reference's parameters
(``convert``)."""
from repro_torch.models.layers import ModelContext

__all__ = ["ModelContext"]
