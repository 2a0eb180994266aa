"""The port's models: the LM stack (dense and MoE families: layers,
``moe``, model assembly), the ViT (``vision``) and the import of the
reference's parameters (``convert``)."""
from repro_torch.models.layers import ModelContext

__all__ = ["ModelContext"]
