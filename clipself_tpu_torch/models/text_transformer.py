"""CLIP text transformer in PyTorch (frozen in every shipped recipe).

A port of `clipself_tpu/models/text_transformer.py` (reference text tower,
`src/open_clip/eva_clip/transformer.py:642-742`): token embedding plus a
learned positional embedding, pre-LN residual blocks with a packed q/k/v
projection and a GELU MLP, the causal mask, a final LN, and the embedding of
the EOT token (the argmax of the token ids) projected by `text_projection`.

  - parameters are float32 and cast to the compute dtype at each product,
    as flax `Dense(dtype=...)` does; the residual stream stays in the
    compute dtype;
  - each LayerNorm runs the port's LayerNorm (`eva_vit.LayerNorm`, the
    hand-written kernel on the card): float32 inside, the fast-variance
    association of flax `nn.LayerNorm`, its output cast to the compute
    dtype, as the JAX tower's `.astype` at each call site does;
  - attention is `ops/attention.py::attention_masked`, the plain mirror of
    the JAX tower's XLA attention with the additive causal mask
    `triu(full(-inf), 1)` in float32; the JAX package runs no Pallas kernel
    here;
  - module and parameter names follow the reference state dict
    (`transformer.resblocks.{i}.attn.in_proj_weight`, `mlp.c_fc`, `ls_1.gamma`,
    `ln_final`, `text_projection`, ...), so `models/torch_io.py` loads
    reference checkpoints with `strict=True`;
  - under tensor parallelism (`parallel/tensor_parallel.py`) `TextAttention`
    and `TextMlp` take the group as the OpenCLIP ViT's branches do (CoCa's
    decoder self-attention blocks with them).

The CoCa text tower (`embed_cls`) appends a learned `cls_emb` after the
text, so the positional table has context_length + 1 rows; `forward_coca`
pools it (`clipself_tpu/models/text_transformer.py:129-160`). A config that
names an HF text tower (`hf_model_name`) builds `models/hf_text.py::HFTextTower`
instead (`models/clip.py::CLIP`, `models/coca.py::CoCa`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clipself_tpu_torch.core.config import TextConfig
from clipself_tpu_torch.models.common import LayerScale, gelu
from clipself_tpu_torch.models.eva_vit import Dense, LayerNorm, _lecun_normal
from clipself_tpu_torch.ops.attention import attention_masked
from clipself_tpu_torch.parallel.tensor_parallel import TensorParallel


class TextAttention(nn.Module):
    """Self-attention with the packed q/k/v projection of
    `torch.nn.MultiheadAttention` (`in_proj_weight` [3W, W], `in_proj_bias`).
    ``heads`` and ``width`` are this rank's: all of them, or under tensor
    parallelism (``tp``, `parallel/tensor_parallel.py`) its share of the
    heads, whose q, k and v rows it holds; `out_proj` is then row-parallel."""

    tp: Optional[TensorParallel] = None

    def __init__(self, cfg: TextConfig):
        super().__init__()
        w = cfg.width
        self.width, self.heads = w, cfg.heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * w, w))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * w))
        self.out_proj = Dense(w, w)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        b, n, _ = x.shape
        w = self.width
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        heads = (b, n, self.heads, w // self.heads)
        q, k, v = (t.reshape(heads) for t in qkv.split(w, dim=-1))
        out = attention_masked(q, k, v, (w // self.heads) ** -0.5, mask)
        return self.out_proj(out.reshape(b, n, w))


class TextMlp(nn.Module):
    """The GELU MLP; under tensor parallelism (``tp``) this rank holds a
    slice of the hidden width and `c_proj` is row-parallel."""

    tp: Optional[TensorParallel] = None

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.c_fc = Dense(cfg.width, 4 * cfg.width)
        self.c_proj = Dense(4 * cfg.width, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        return self.c_proj(gelu(self.c_fc(x), self.cfg.quick_gelu))


class TextBlock(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width, cfg.ln_eps)
        self.attn = TextAttention(cfg)
        self.ln_2 = LayerNorm(cfg.width, cfg.ln_eps)
        self.mlp = TextMlp(cfg)
        ls = cfg.ls_init_value
        self.ls_1 = LayerScale(cfg.width, ls) if ls is not None else None
        self.ls_2 = LayerScale(cfg.width, ls) if ls is not None else None

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype: Optional[torch.dtype] = None
    ) -> torch.Tensor:
        """The residual stream keeps x's dtype; each branch computes in
        ``dtype`` (x's by default) from its norm's output cast to it, as the
        JAX block's `ln(x).astype(self.dtype)` does."""
        dt = dtype or x.dtype
        a = self.attn(self.ln_1(x).to(dt), mask)
        x = x + (a if self.ls_1 is None else self.ls_1(a))
        m = self.mlp(self.ln_2(x).to(dt))
        return x + (m if self.ls_2 is None else self.ls_2(m))


class _Transformer(nn.Module):
    """Holds the blocks under the reference name `transformer.resblocks`."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(TextBlock(cfg) for _ in range(cfg.layers))


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.hf_model_name:
            raise ValueError(
                f"HF text tower {cfg.hf_model_name!r}: build it with models/hf_text.py::HFTextTower"
            )
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        # embed_cls (reference `transformer.py:911-915`): one learned CLS
        # token after the text, one more positional row
        self.cls_emb = nn.Parameter(torch.zeros(cfg.width)) if cfg.embed_cls else None
        num_pos = cfg.context_length + (1 if cfg.embed_cls else 0)
        self.positional_embedding = nn.Parameter(torch.zeros(num_pos, cfg.width))
        self.transformer = _Transformer(cfg)
        self.ln_final = LayerNorm(cfg.width, cfg.ln_eps)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, embed_dim))
        n = cfg.context_length
        causal = torch.triu(torch.full((n, n), float("-inf")), diagonal=1)
        self.register_buffer("attn_mask", causal, persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with the JAX tower's distributions: flax
        `nn.Embed`'s normal(1/sqrt(width)) token embedding, normal(0.01)
        positional embedding and CLS token, normal(width^-0.5) projection, lecun-normal
        (truncated) kernels with zero biases, unit LayerNorm scales, the
        LayerScale init value. Parameters must lie on the generator's device."""
        w = self.cfg.width
        self.token_embedding.weight.normal_(0.0, w ** -0.5, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        if self.cls_emb is not None:
            self.cls_emb.normal_(0.0, 0.01, generator=generator)
        for blk in self.transformer.resblocks:
            _lecun_normal(blk.attn.in_proj_weight, w, generator)
            blk.attn.in_proj_bias.zero_()
        for m in self.modules():
            if isinstance(m, Dense):
                _lecun_normal(m.weight, m.in_features, generator)
                m.bias.zero_()
        self.text_projection.normal_(0.0, w ** -0.5, generator=generator)

    def features(self, text: torch.Tensor) -> torch.Tensor:
        """Per-token features [B, n, width] after the final LN, in the compute
        dtype; ``text`` [B, n] token ids."""
        n = text.shape[1]
        x = F.embedding(text.long(), self.token_embedding.weight).to(self.dtype)
        x = x + self.positional_embedding[:n].to(self.dtype)
        mask = self.attn_mask[:n, :n] if self.cfg.attn_mask else None
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        return self.ln_final(x)

    def project(self, feats: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """EOT pooling (the first position of the highest token id, as
        `jnp.argmax` picks) and the projection, in feats' dtype."""
        eot = text.argmax(dim=-1)
        pooled = feats[torch.arange(feats.shape[0], device=feats.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """text [B, n] token ids -> [B, embed_dim] (not normalized)."""
        return self.project(self.features(text), text)

    def forward_coca(self, text: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(pooled [B, embed_dim], tokens [B, n, width]) of ``text`` [B, n],
        the reference embed_cls forward (`transformer.py:985-1016`). The CLS
        token is appended after the text (n + 1 positions); the mask is
        causal, plus on the CLS row the pad columns of `build_cls_mask`
        (`transformer.py:974-981`) replicated literally, with its one-column
        shift: column 0 stays visible and column j >= 1 is masked where
        token j - 1 is the pad id. `ln_final` and the projection run on the
        CLS position alone; the token stream comes back without `ln_final`.
        Without `cls_emb`: `ln_final` over every token, EOT pooling, and
        the normalized stream."""
        c = self.cfg
        if self.cls_emb is None:
            feats = self.features(text)
            return self.project(feats, text), feats
        b, n = text.shape
        seq = n + 1
        x = F.embedding(text.long(), self.token_embedding.weight).to(self.dtype)
        x = torch.cat([x, self.cls_emb.to(self.dtype).expand(b, 1, c.width)], dim=1)
        x = x + self.positional_embedding[:seq].to(self.dtype)
        dev = x.device
        causal = torch.triu(torch.full((seq, seq), float("-inf"), device=dev), diagonal=1)
        vis = torch.where(text != c.pad_id, 0.0, float("-inf"))
        cls_mask = torch.zeros((b, seq, seq), device=dev)
        cls_mask[:, -1] = torch.cat([torch.zeros((b, 1), device=dev), vis], dim=1)
        mask = (causal[None] + cls_mask)[:, None]
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        pooled = self.ln_final(x[:, -1])
        return pooled @ self.text_projection.to(pooled.dtype), x[:, :-1]
