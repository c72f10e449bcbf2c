"""The HF text tower in PyTorch, without `transformers`: a port of
`clipself_tpu/models/hf_text.py` (reference `HFTextEncoder`,
`src/open_clip/hf_model.py:83-176`).

A transformers encoder trunk (`models/hf_bert.py` for 'bert', 'roberta',
'xlm-roberta'; `models/hf_t5.py` for 't5', 'mt5', the encoder alone), a
pooler and a projection into the joint space:

  - the config: `models/hf_configs.py::text_config(hf_model_name,
    hf_model_config)`; a hub id raises OSError naming its `config.json`;
  - the padding mask is `ids != pad_token_id` (RoBERTa and XLM-R pad with
    1, BERT and T5 with 0); RoBERTa and XLM-R take positions
    `cumsum(mask) * mask + pad_id` (`hf_text.py:145-149`), BERT `arange`;
  - poolers (`hf_text.py:64-100`): `mean_pooler`, the masked mean with the
    divisor floored at 1e-6; `cls_pooler`, the trunk's pooler output (dense
    + tanh on token 0) where it has one, the BERT family, else token 0;
    `last_pooler`, the last token that is not padding;
  - `proj`: 'linear' (`proj.weight`, no bias) or 'mlp' (`proj.0.weight`,
    the tanh GELU, which is flax `nn.gelu`'s default, `proj.2.weight`; the
    hidden width (W + embed_dim) // 2), both without biases;
  - the trunk computes in float32 whatever the model's dtype (the JAX tower
    builds its Flax trunk at `dtype=jnp.float32`); the projection runs in
    the compute dtype, as the JAX `Dense(dtype=...)` does.

Module names follow the reference OpenCLIP layout: `text.transformer.<the
transformers torch names>`, `text.proj.weight` or `text.proj.{0,2}.weight`,
so a transformers torch trunk state dict loads strictly into
`text.transformer` (`load_hf_trunk_params`). The hub's weights
(`hf_pretrained`) and tokenizer are not in the repository and are never
fetched (`models/factory.py::create_model`, `tokenizer.py::HFTokenizer`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from clipself_tpu_torch.core.config import TextConfig
from clipself_tpu_torch.models.eva_vit import Dense, _lecun_normal
from clipself_tpu_torch.models.hf_bert import BertModel
from clipself_tpu_torch.models.hf_configs import PAD_OFFSET_POSITIONS, text_config
from clipself_tpu_torch.models.hf_t5 import T5EncoderModel

POOLERS = ("mean_pooler", "cls_pooler", "last_pooler")


class HFTextTower(nn.Module):
    """Trunk + pooler + projection (`clipself_tpu/models/hf_text.py::HFTextTower`)."""

    def __init__(self, cfg: TextConfig, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.pooler_type not in POOLERS:
            raise ValueError(f"unknown pooler_type {cfg.pooler_type!r} (takes {', '.join(POOLERS)})")
        self.cfg, self.dtype = cfg, dtype
        self.hf_config = c = text_config(cfg.hf_model_name, cfg.hf_model_config)
        if c.is_encoder_decoder:
            self.transformer = T5EncoderModel(c)
            width = c.d_model
        else:
            self.transformer = BertModel(c)
            width = c.hidden_size
        # bias-free float32 weights computed in the input's dtype, flax
        # `Dense(use_bias=False, dtype=..., param_dtype=float32)`
        if cfg.proj == "linear":
            self.proj = Dense(width, embed_dim, bias=False)
        elif cfg.proj == "mlp":
            hidden = (width + embed_dim) // 2
            self.proj = nn.Sequential(
                Dense(width, hidden, bias=False), nn.GELU(approximate="tanh"), Dense(hidden, embed_dim, bias=False)
            )
        else:
            raise ValueError(f"unknown proj {cfg.proj!r}")

    @property
    def pad_id(self) -> int:
        pad = self.hf_config.pad_token_id
        return 0 if pad is None else pad

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The trunk's transformers init, then flax `Dense`'s lecun-normal
        (truncated) projection. Parameters must lie on the generator's device."""
        self.transformer.init_weights(generator)
        for m in self.proj.modules():
            if isinstance(m, Dense):
                _lecun_normal(m.weight, m.in_features, generator)

    def _trunk(self, input_ids: torch.Tensor):
        """(hidden [B, N, W], pooler output or None, attention mask [B, N])."""
        mask = (input_ids != self.pad_id).long()
        if self.hf_config.is_encoder_decoder:
            hidden, pooled = self.transformer(input_ids, mask)
        else:
            positions = None
            if self.hf_config.model_type in PAD_OFFSET_POSITIONS:
                positions = torch.cumsum(mask, dim=1) * mask + self.pad_id
            hidden, pooled = self.transformer(input_ids, mask, positions)
        return hidden, pooled, mask

    def _pool(self, hidden: torch.Tensor, pooled: Optional[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
        kind = self.cfg.pooler_type
        if kind == "mean_pooler":
            m = mask[..., None].to(hidden.dtype)
            return (hidden * m).sum(1) / torch.clamp(m.sum(1), min=1e-6)
        if kind == "cls_pooler":
            return pooled if pooled is not None else hidden[:, 0]
        last = torch.clamp(mask.sum(1) - 1, min=0)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), last]

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """ids [B, N] -> [B, embed_dim] in the compute dtype (not normalized)."""
        hidden, pooled, mask = self._trunk(text)
        return self.proj(self._pool(hidden, pooled, mask).to(self.dtype))

    def forward_tokens(self, text: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(projected pooled [B, embed_dim], per-token hidden states [B, N, W]
        float32), the CLS slot dropped under `cls_pooler` (`hf_text.py:154-171`):
        CoCa's text path."""
        hidden, pooled, mask = self._trunk(text)
        out = self.proj(self._pool(hidden, pooled, mask).to(self.dtype))
        return out, hidden[:, 1:] if self.cfg.pooler_type == "cls_pooler" else hidden


# transformers' non-persistent buffers, which older checkpoints carry
_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")


def graft_state_dict(module: nn.Module, sd: dict, what: str) -> None:
    """Load ``sd`` (tensors or arrays) into ``module`` in place, strictly:
    a key set or a shape that differs from the module's raises ValueError
    naming the first keys that differ."""
    ours = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in sd.items()}
    if ours != theirs:
        missing, extra = sorted(set(ours) - set(theirs)), sorted(set(theirs) - set(ours))
        shapes = sorted(k for k in set(ours) & set(theirs) if ours[k] != theirs[k])
        raise ValueError(
            f"{what} structure mismatch: missing {missing[:4]}, unexpected {extra[:4]}, shapes differ "
            f"at {shapes[:4]}"
        )
    module.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}, strict=True)


def load_hf_trunk_params(model: nn.Module, hf_state_dict: dict) -> None:
    """Graft a transformers torch trunk state dict (`BertModel`,
    `RobertaModel`, `XLMRobertaModel`, `T5EncoderModel`, `MT5EncoderModel`:
    tensors or arrays) into ``model.text.transformer`` in place; the
    projection keeps its value (`clipself_tpu/models/hf_text.py:174-198`).
    transformers' non-persistent buffers, which older checkpoints carry,
    are dropped; a key set or a shape that differs from the trunk's raises
    ValueError, as the JAX graft's structure check does."""
    sd = {k: v for k, v in hf_state_dict.items() if k not in _BUFFERS}
    graft_state_dict(model.text.transformer, sd, "HF text trunk")
