"""The BERT / RoBERTa / XLM-RoBERTa encoder in PyTorch, without `transformers`.

The trunk of the JAX package's HF text tower for these model types
(`clipself_tpu/models/hf_text.py`, transformers' `FlaxBertModule` /
`FlaxRobertaModule`, which XLM-R shares):

  - embeddings: word + token type (all type 0) + position, then a
    LayerNorm; positions are `arange` for BERT, and for RoBERTa and XLM-R
    the tower's `cumsum(pad_mask) * pad_mask + pad_id`
    (`models/hf_text.py::position_ids`);
  - post-LN layers: self-attention (`attention.self.{query,key,value}`),
    `attention.output.{dense,LayerNorm}` on the residual sum, the
    intermediate dense and its activation (`hidden_act`, exact erf GELU by
    default), `output.{dense,LayerNorm}` on the residual sum;
  - the optional pooler: `pooler.dense` and tanh on token 0, built whenever
    the JAX trunk builds it (`FlaxAutoModel.from_config` keeps it, whatever
    the tower's pooler).

Every LayerNorm runs the port's LayerNorm (`eva_vit.LayerNorm`: the
hand-written kernel on the card) at the config's eps. Attention takes
`ops/attention.py::multi_head_attention` with the additive padding bias
(0 where the mask is set, `finfo(float32).min` where it is not, as
`FlaxBertSelfAttention` builds it), so it is `attention_masked` on every
device: the JAX package runs XLA there, no Pallas kernel. A row that is all
padding adds the same bias to every logit and attends uniformly, finite on
both sides. The trunk computes in float32 whatever the model's dtype, as the
JAX towers build their Flax trunks at their default `dtype=jnp.float32`.
Module and parameter names are transformers' torch `BertModel`'s, so its
state dict loads with `strict=True`.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from clipself_tpu_torch.models.eva_vit import Dense, LayerNorm
from clipself_tpu_torch.models.hf_configs import activation
from clipself_tpu_torch.ops.attention import multi_head_attention


def padding_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, N] mask -> the additive float32 bias [B, 1, 1, N] of the HF Flax
    encoders: 0 where the mask is set, `finfo(float32).min` elsewhere."""
    neg = torch.finfo(torch.float32).min
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg).float()


class BertEmbeddings(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
        words = self.word_embeddings(input_ids)
        types = self.token_type_embeddings.weight[0]  # token_type_ids are all 0
        return self.LayerNorm(words + types + self.position_embeddings(position_ids))


class BertSelfAttention(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.heads = c.num_attention_heads
        self.query = Dense(c.hidden_size, c.hidden_size)
        self.key = Dense(c.hidden_size, c.hidden_size)
        self.value = Dense(c.hidden_size, c.hidden_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        q, k, v = (f(x).view(b, n, self.heads, w // self.heads) for f in (self.query, self.key, self.value))
        return multi_head_attention(q, k, v, (w // self.heads) ** -0.5, bias).reshape(b, n, w)


class BertResidualOutput(nn.Module):
    """`dense`, then `LayerNorm` of its sum with the block's input (the
    torch `BertSelfOutput` and `BertOutput`)."""

    def __init__(self, width_in: int, c: SimpleNamespace):
        super().__init__()
        self.dense = Dense(width_in, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.self = BertSelfAttention(c)
        self.output = BertResidualOutput(c.hidden_size, c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.dense = Dense(c.hidden_size, c.intermediate_size)
        self.act = activation(c.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.attention = BertAttention(c)
        self.intermediate = BertIntermediate(c)
        self.output = BertResidualOutput(c.intermediate_size, c)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        h = self.attention(x, bias)
        return self.output(self.intermediate(h), h)


class BertEncoder(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_hidden_layers))


class BertPooler(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.dense = Dense(c.hidden_size, c.hidden_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """The encoder of ``c`` (`models/hf_configs.py::text_config`), with the
    pooler unless ``add_pooling_layer`` is off."""

    def __init__(self, c: SimpleNamespace, add_pooling_layer: bool = True):
        super().__init__()
        self.config = c
        self.embeddings = BertEmbeddings(c)
        self.encoder = BertEncoder(c)
        self.pooler = BertPooler(c) if add_pooling_layer else None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """transformers' init: normal(initializer_range) dense kernels and
        embeddings, zero biases, unit LayerNorm scales. Parameters must lie
        on the generator's device."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, (Dense, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
            if isinstance(m, Dense):
                m.bias.zero_()

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(last hidden state [B, N, W] float32, pooler output [B, W] or
        None) of ids [B, N] under ``attention_mask`` [B, N]; positions
        default to `arange`."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device).expand_as(input_ids)
        x = self.embeddings(input_ids.long(), position_ids.long())
        bias = padding_bias(attention_mask)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x, (self.pooler(x) if self.pooler is not None else None)
