"""Training: the reference's AdamW, the LM train step (``train_step``) and
the loader-fed ViT trainer."""
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update"]
