"""The T5 / mT5 encoder in PyTorch, without `transformers`.

The trunk of the JAX package's HF text tower for these model types: the
encoder alone (`clipself_tpu/models/hf_text.py:41-57`, transformers'
`FlaxT5EncoderModule`):

  - `shared` token embedding (the encoder's `embed_tokens` is the same
    module, as in torch `T5EncoderModel`, so both keys are in the state
    dict), no positional embedding, no scaling;
  - pre-norm blocks `encoder.block.{i}.layer.0` (`layer_norm`, then
    `SelfAttention.{q,k,v,o}`, no biases) and `layer.1` (`layer_norm`, then
    `DenseReluDense`: `wi` -> activation -> `wo`, or the gated
    `act(wi_0) * wi_1` -> `wo` of `feed_forward_proj` 'gated-*'; mT5's
    'gated-gelu' is the tanh GELU, `gelu_new`), each residual;
    `encoder.final_layer_norm`;
  - the RMS norm: no mean, no bias, the variance in float32, eps 1e-6, plain
    PyTorch (no Pallas kernel stands behind the JAX one);
  - attention with unscaled logits (FlaxT5 undoes
    `dot_product_attention_weights`' scaling) and a bidirectional
    relative-position bias (32 buckets, max distance 128 by default),
    computed by block 0's `relative_attention_bias` and shared by every
    block, plus the padding bias (`hf_bert.padding_bias`): the plain
    `attention_masked(scale=1.0)` on every device.

The trunk computes in float32 whatever the model's dtype, as the JAX towers'
Flax trunks do. Names are transformers' torch `T5EncoderModel`'s.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
from torch import nn

from clipself_tpu_torch.models.common import device_constant
from clipself_tpu_torch.models.hf_bert import padding_bias
from clipself_tpu_torch.models.hf_configs import activation
from clipself_tpu_torch.ops.attention import attention_masked


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False)


def relative_position_buckets(n: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """[n, n] int64 bucket of key j for query i, bidirectional: the float32
    arithmetic of `FlaxT5Attention._relative_position_bucket`."""
    rel = np.arange(n, dtype=np.int32)[None, :] - np.arange(n, dtype=np.int32)[:, None]
    half = num_buckets // 2
    buckets = (rel > 0).astype(np.int32) * half
    rel = np.abs(rel)
    max_exact = half // 2
    with np.errstate(divide="ignore"):
        large = max_exact + (
            np.log(rel.astype(np.float32) / np.float32(max_exact))
            / np.float32(math.log(max_distance / max_exact)) * np.float32(half - max_exact)
        )
    large = np.minimum(large, np.float32(half - 1))
    return (buckets + np.where(rel < max_exact, rel, large)).astype(np.int64)


class T5LayerNorm(nn.Module):
    """RMS norm: x / sqrt(mean(x^2) + eps) * weight, the mean in float32."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        variance = x.float().pow(2).mean(-1, keepdim=True)
        return self.weight * (x / torch.sqrt(variance + self.eps))


class T5Attention(nn.Module):
    def __init__(self, c: SimpleNamespace, has_relative_attention_bias: bool):
        super().__init__()
        self.heads, self.d_kv = c.num_heads, c.d_kv
        inner = c.num_heads * c.d_kv
        self.q, self.k, self.v = (_linear(c.d_model, inner) for _ in range(3))
        self.o = _linear(inner, c.d_model)
        self.buckets = (c.relative_attention_num_buckets, c.relative_attention_max_distance)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(c.relative_attention_num_buckets, c.num_heads)

    def position_bias(self, n: int, device) -> torch.Tensor:
        """[1, H, n, n] relative-position bias."""
        idx = device_constant(("t5_buckets", n) + self.buckets, relative_position_buckets(n, *self.buckets), device)
        return self.relative_attention_bias(idx).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (f(x).view(b, n, self.heads, self.d_kv) for f in (self.q, self.k, self.v))
        return self.o(attention_masked(q, k, v, 1.0, bias).reshape(b, n, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, c: SimpleNamespace, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(c, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseActDense(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.wi = _linear(c.d_model, c.d_ff)
        self.wo = _linear(c.d_ff, c.d_model)
        self.act = activation(c.dense_act_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.act(self.wi(x)))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.wi_0 = _linear(c.d_model, c.d_ff)
        self.wi_1 = _linear(c.d_model, c.d_ff)
        self.wo = _linear(c.d_ff, c.d_model)
        self.act = activation(c.dense_act_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.act(self.wi_0(x)) * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.DenseReluDense = (T5DenseGatedActDense if c.is_gated_act else T5DenseActDense)(c)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, c: SimpleNamespace, has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(c, has_relative_attention_bias), T5LayerFF(c)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, c: SimpleNamespace, embed_tokens: nn.Embedding):
        super().__init__()
        self.embed_tokens = embed_tokens
        self.block = nn.ModuleList(T5Block(c, i == 0) for i in range(c.num_layers))
        self.final_layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """The encoder of ``c`` (`models/hf_configs.py::text_config` of 't5' or 'mt5')."""

    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.config = c
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        self.encoder = T5Stack(c, self.shared)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """transformers' T5 init (`initializer_factor` f): `shared`
        normal(f); q normal(f (H d_kv^2)^-0.5); k, v, o and the bias table
        normal(f (H d_kv)^-0.5); `wi*` normal(f d_model^-0.5); `wo`
        normal(f d_ff^-0.5); unit norm scales. Parameters must lie on the
        generator's device."""
        c, f = self.config, self.config.initializer_factor
        inner = c.num_heads * c.d_kv
        self.shared.weight.normal_(0.0, f, generator=generator)
        for m in self.modules():
            if isinstance(m, T5Attention):
                m.q.weight.normal_(0.0, f * (inner * c.d_kv) ** -0.5, generator=generator)
                for t in (m.k, m.v, m.o):
                    t.weight.normal_(0.0, f * inner ** -0.5, generator=generator)
                if hasattr(m, "relative_attention_bias"):
                    m.relative_attention_bias.weight.normal_(0.0, f * inner ** -0.5, generator=generator)
            elif isinstance(m, (T5DenseActDense, T5DenseGatedActDense)):
                for name, t in m.named_children():
                    if isinstance(t, nn.Linear):
                        std = f * (c.d_ff if name == "wo" else c.d_model) ** -0.5
                        t.weight.normal_(0.0, std, generator=generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> tuple[torch.Tensor, None]:
        """(last hidden state [B, N, d_model] float32, None: no pooler) of
        ids [B, N] under ``attention_mask`` [B, N]."""
        enc = self.encoder
        x = enc.embed_tokens(input_ids.long())
        blocks = enc.block
        # block 0's relative-position bias plus the padding bias, shared by every block
        bias = blocks[0].layer[0].SelfAttention.position_bias(x.shape[1], x.device) + padding_bias(attention_mask)
        for blk in blocks:
            x = blk(x, bias)
        return enc.final_layer_norm(x), None
