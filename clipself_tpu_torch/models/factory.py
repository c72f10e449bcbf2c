"""Model creation: config registry -> initialized port `CLIP` on a device,
and the model's tokenizer."""

from __future__ import annotations

import functools
from typing import Any, Union

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
    JAX package's init distributions, the visual tower's first, then the
    text tower's (they are not the JAX package's values: the two generators
    differ); load real weights with
    `models.torch_io.load_weights`. ``grad_checkpointing`` recomputes each
    block of the visual tower in the backward pass (the JAX package's
    ``remat``).
    """
    cfg = get_model_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    model = CLIP(cfg, dtype=dtype, grad_checkpointing=grad_checkpointing)
    generator = torch.Generator().manual_seed(seed)
    model.visual.init_weights(generator)
    model.text.init_weights(generator)
    return model.to(device).eval()


def get_tokenizer(name_or_cfg: Any = None):
    """The tokenizer callable of a model (`clipself_tpu/models/factory.py::get_tokenizer`):
    the CLIP BPE `tokenize` at the model's context length. A CoCa config
    declares one token less than it consumes, so it gets one more. HF text
    towers raise (ROADMAP.md queue 1 item 8)."""
    from clipself_tpu_torch import tokenizer as _tok

    if name_or_cfg is None:
        return _tok.tokenize
    cfg = get_model_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    hf_name = cfg.text.hf_tokenizer_name or cfg.text.hf_model_name
    if hf_name:
        return _tok.HFTokenizer(hf_name)
    ctx = cfg.text.context_length + (1 if cfg.multimodal is not None else 0)
    return functools.partial(_tok.tokenize, context_length=ctx)
