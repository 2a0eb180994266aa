from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, Stage, LayerSpec,
    get_config, list_configs, register, shape_applicable,
)
