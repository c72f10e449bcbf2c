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
