"""transformers' ViT trunk in PyTorch, without `transformers` and without
its pooler: the trunk of the JAX package's trunk adapter for the model type
'vit' (`clipself_tpu/models/trunk_adapter.py`, transformers'
`FlaxViTModule(add_pooling_layer=False)`):

  - `embeddings`: the patch projection (`patch_embeddings.projection`, a
    stride-`patch_size` convolution with a bias, computed as a float32
    matmul over the patches, `ops/patchify.py`), the class token first,
    then the learned `position_embeddings` [1, 1 + N, W];
  - pre-LN layers `encoder.layer.{i}`: `layernorm_before`, self-attention
    (`attention.attention.{query,key,value}`, biased when `qkv_bias`),
    `attention.output.dense` on the residual; `layernorm_after`,
    `intermediate.dense` and its activation (exact erf GELU by default),
    `output.dense` on the residual;
  - the final `layernorm`.

Images arrive as [B, H, W, 3], as everywhere in the port, at the config's
`image_size`: the position embeddings are never resized (the Flax ViT has no
interpolation either), so another size raises. Every LayerNorm runs the
port's LayerNorm (the hand-written kernel on the card) at the config's eps;
the unmasked self-attention takes `ops/attention.py::multi_head_attention`,
the flash kernels on the card. The trunk computes in float32 whatever the
model's dtype, as the JAX adapter's Flax trunk does: on the card its
attention takes the flash kernels' float32 design and its norms the float32
LayerNorm kernels. Names are transformers' torch `ViTModel`'s.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipself_tpu_torch.models.eva_vit import Dense, LayerNorm, _trunc_normal
from clipself_tpu_torch.models.hf_configs import activation
from clipself_tpu_torch.ops.attention import multi_head_attention
from clipself_tpu_torch.ops.patchify import patchify


class ViTPatchEmbeddings(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.num_channels = c.num_channels
        p = c.patch_size
        self.projection = nn.ParameterDict({
            "weight": nn.Parameter(torch.zeros(c.hidden_size, c.num_channels, p, p)),
            "bias": nn.Parameter(torch.zeros(c.hidden_size)),
        })


class ViTEmbeddings(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        n = (c.image_size // c.patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, 1 + n, c.hidden_size))
        self.patch_embeddings = ViTPatchEmbeddings(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] float32 -> [B, 1 + N, W] tokens."""
        if x.shape[-1] != self.patch_embeddings.num_channels:
            raise ValueError(f"images with {x.shape[-1]} channels; the trunk takes "
                             f"{self.patch_embeddings.num_channels}")
        proj = self.patch_embeddings.projection
        t = patchify(x, proj["weight"], proj["bias"], torch.float32).flatten(1, 2)
        if t.shape[1] + 1 != self.position_embeddings.shape[1]:
            raise ValueError(
                f"position_embeddings hold {self.position_embeddings.shape[1] - 1} patches but the "
                f"input gives {t.shape[1]}: the trunk takes its config's image_size (never resized)"
            )
        t = torch.cat([self.cls_token.expand(t.shape[0], -1, -1), t], dim=1)
        return t + self.position_embeddings


class ViTSelfAttention(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.heads = c.num_attention_heads
        self.query, self.key, self.value = (
            Dense(c.hidden_size, c.hidden_size, bias=c.qkv_bias) for _ in range(3)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        q, k, v = (f(x).view(b, n, self.heads, w // self.heads) for f in (self.query, self.key, self.value))
        return multi_head_attention(q, k, v, (w // self.heads) ** -0.5).reshape(b, n, w)


class _DenseOut(nn.Module):
    """`dense` alone (torch `ViTSelfOutput`, `ViTIntermediate` without its
    activation, `ViTOutput`): the residual sums are `ViTLayer`'s."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = Dense(n_in, n_out)


class ViTAttention(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.attention = ViTSelfAttention(c)
        self.output = _DenseOut(c.hidden_size, c.hidden_size)


class ViTLayer(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.attention = ViTAttention(c)
        self.intermediate = _DenseOut(c.hidden_size, c.intermediate_size)
        self.output = _DenseOut(c.intermediate_size, c.hidden_size)
        self.layernorm_before = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.layernorm_after = LayerNorm(c.hidden_size, c.layer_norm_eps)
        self.act = activation(c.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attention
        x = attn.output.dense(attn.attention(self.layernorm_before(x))) + x
        h = self.act(self.intermediate.dense(self.layernorm_after(x)))
        return self.output.dense(h) + x


class ViTEncoder(nn.Module):
    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(c) for _ in range(c.num_hidden_layers))


class ViTModel(nn.Module):
    """The trunk of ``c`` (`models/hf_configs.py::trunk_config` of 'vit')."""

    def __init__(self, c: SimpleNamespace):
        super().__init__()
        self.config = c
        self.embeddings = ViTEmbeddings(c)
        self.encoder = ViTEncoder(c)
        self.layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """transformers' torch ViT init: truncated normal(initializer_range)
        dense and patch kernels, class token and position embeddings, zero
        biases, unit LayerNorm scales. Parameters must lie on the
        generator's device."""
        std = self.config.initializer_range
        e = self.embeddings
        proj = e.patch_embeddings.projection
        for t in (e.cls_token, e.position_embeddings, proj["weight"]):
            _trunc_normal(t, std, generator)
        proj["bias"].zero_()
        for m in self.encoder.modules():
            if isinstance(m, Dense):
                _trunc_normal(m.weight, std, generator)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, x: torch.Tensor, grad_checkpointing: bool = False) -> torch.Tensor:
        """images [B, H, W, C] -> last hidden state [B, 1 + N, W], float32;
        with ``grad_checkpointing`` each layer runs its forward again in the
        backward pass."""
        t = self.embeddings(x.float())
        recompute = grad_checkpointing and torch.is_grad_enabled()
        for layer in self.encoder.layer:
            t = checkpoint(layer, t, use_reentrant=False, preserve_rng_state=False) if recompute else layer(t)
        return self.layernorm(t)
