"""The port's LM stack (dense family): layers, model assembly and the
import of the reference's parameters."""
from repro_torch.models.layers import ModelContext

__all__ = ["ModelContext"]
