from rmem_ocu_tpu_torch.config.defaults import (  # noqa: F401
    MODEL_REGISTRY,
    STAGE_REGISTRY,
    ExpConfig,
    ModelConfig,
    get_config,
    get_model_config,
)
