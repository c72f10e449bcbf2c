"""Model creation: config registry -> initialized port `CLIP` on a device."""

from __future__ import annotations

from typing import Union

import torch

from clipself_tpu_torch.core.config import CLIPConfig, get_model_config
from clipself_tpu_torch.models.clip import CLIP


def create_model(
    name_or_cfg: Union[str, CLIPConfig],
    *,
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    grad_checkpointing: bool = False,
) -> CLIP:
    """Build a CLIP with seeded random weights, in eval mode on ``device``.

    Parameters are float32; ``dtype`` is the compute dtype. The weights are
    drawn on the CPU from ``torch.Generator().manual_seed(seed)`` with the
    JAX package's init distributions (they are not the JAX package's values:
    the two generators differ); load real weights with
    `models.torch_io.load_weights`. ``grad_checkpointing`` recomputes each
    block of the visual tower in the backward pass (the JAX package's
    ``remat``).
    """
    cfg = get_model_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    model = CLIP(cfg, dtype=dtype, grad_checkpointing=grad_checkpointing)
    model.visual.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
