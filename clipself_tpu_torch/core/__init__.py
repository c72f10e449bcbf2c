"""Configuration registry (a jax-free copy of `clipself_tpu.core.config`)."""

from clipself_tpu_torch.core.config import (  # noqa: F401
    CLIPConfig,
    VisionConfig,
    get_model_config,
)
