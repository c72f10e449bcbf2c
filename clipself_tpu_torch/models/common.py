"""Shared tower helpers."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / (||x|| + 1e-12), computed in float32 and cast back to x's dtype."""
    xf = x.float()
    return (xf / (torch.linalg.vector_norm(xf, dim=dim, keepdim=True) + 1e-12)).to(x.dtype)


def gelu(x: torch.Tensor, quick: bool) -> torch.Tensor:
    """The MLP activation of the CLIP towers: QuickGELU x * sigmoid(1.702 x)
    for the OpenAI towers (``quick``), else exact GELU."""
    if quick:
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


class LayerScale(nn.Module):
    """Per-channel learned residual-branch scale (`clipself_tpu/models/common.py::LayerScale`,
    reference `LayerScale`): a float32 ``gamma`` that starts at
    ``init_value``, cast to x's dtype."""

    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


_DEVICE_CONSTANTS: dict = {}


def device_constant(key: tuple, array: np.ndarray, device) -> torch.Tensor:
    """``array`` as a tensor on ``device``, made once a process for each
    ``key`` and device; a normal tensor even when the first caller runs
    under inference_mode (the evaluator), since a later training step may
    save it for its backward."""
    key = key + (str(device),)
    if key not in _DEVICE_CONSTANTS:
        with torch.inference_mode(False):
            _DEVICE_CONSTANTS[key] = torch.from_numpy(array).to(device)
    return _DEVICE_CONSTANTS[key]


class _PoolerAttention(nn.Module):
    """The parameters of `torch.nn.MultiheadAttention` with kdim != embed_dim
    (the reference state dict's `attn.*` of the pooler): separate q / k / v
    projection weights, one packed `in_proj_bias` [3 * d_model], and
    `out_proj`."""

    def __init__(self, d_model: int, context_dim: int):
        super().__init__()
        from clipself_tpu_torch.models.eva_vit import Dense

        self.q_proj_weight = nn.Parameter(torch.zeros(d_model, d_model))
        self.k_proj_weight = nn.Parameter(torch.zeros(d_model, context_dim))
        self.v_proj_weight = nn.Parameter(torch.zeros(d_model, context_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model)


class AttentionalPooler(nn.Module):
    """Learned-query cross-attention pooling of the CoCa vision tower
    (`clipself_tpu/models/common.py::AttentionalPooler`, reference
    `AttentionalPooler`, `src/open_clip/transformer.py:163-186`): ``n_queries``
    learned queries of width ``d_model`` attend over a ``context_dim``-wide
    token sequence. `ln_q` and `ln_k` (eps 1e-5) run the port's LayerNorm
    (the hand-written kernel on the card); the q / k / v projections are
    computed in the compute dtype, each with its third of the packed bias;
    the attention is cross-attention (n_queries keys against the tokens),
    which `ops/attention.py::multi_head_attention` sends to the plain
    `attention_masked`, as the JAX package sends it to XLA."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8, n_queries: int = 256):
        super().__init__()
        from clipself_tpu_torch.models.eva_vit import LayerNorm

        self.d_model, self.context_dim, self.n_head, self.n_queries = d_model, context_dim, n_head, n_queries
        self.query = nn.Parameter(torch.zeros(n_queries, d_model))
        self.ln_q = LayerNorm(d_model, 1e-5)
        self.ln_k = LayerNorm(context_dim, 1e-5)
        self.attn = _PoolerAttention(d_model, context_dim)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX pooler's initial distributions: normal(1) queries,
        lecun-normal (truncated) projections with zero biases."""
        from clipself_tpu_torch.models.eva_vit import _lecun_normal

        a = self.attn
        self.query.normal_(0.0, 1.0, generator=generator)
        _lecun_normal(a.q_proj_weight, self.d_model, generator)
        _lecun_normal(a.k_proj_weight, self.context_dim, generator)
        _lecun_normal(a.v_proj_weight, self.context_dim, generator)
        _lecun_normal(a.out_proj.weight, self.d_model, generator)
        a.in_proj_bias.zero_()
        a.out_proj.bias.zero_()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, N, context_dim] -> [B, n_queries, d_model] in tokens'
        dtype."""
        from clipself_tpu_torch.ops.attention import multi_head_attention

        b, dt, a = tokens.shape[0], tokens.dtype, self.attn
        h, d = self.n_head, self.d_model // self.n_head
        kx = self.ln_k(tokens)
        qx = self.ln_q(self.query).to(dt).expand(b, -1, -1)
        bq, bk, bv = a.in_proj_bias.to(dt).split(self.d_model)
        q = F.linear(qx, a.q_proj_weight.to(dt), bq).reshape(b, self.n_queries, h, d)
        k = F.linear(kx, a.k_proj_weight.to(dt), bk).reshape(b, -1, h, d)
        v = F.linear(kx, a.v_proj_weight.to(dt), bv).reshape(b, -1, h, d)
        out = multi_head_attention(q, k, v, d ** -0.5)
        return a.out_proj(out.reshape(b, self.n_queries, self.d_model))
