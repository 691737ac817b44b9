from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS, PAPER_MODELS, LM_SHAPES, FrontendConfig, MLAConfig,
    MoEConfig, ModelConfig, SSMConfig, Segment, ShapeSpec, get_config,
    list_archs, shape_by_name,
)
