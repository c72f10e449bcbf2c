"""Shared tower helpers."""

from __future__ import annotations

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
