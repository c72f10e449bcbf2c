"""Shared tower helpers."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / (||x|| + 1e-12), computed in float32 and cast back to x's dtype."""
    xf = x.float()
    return (xf / (torch.linalg.vector_norm(xf, dim=dim, keepdim=True) + 1e-12)).to(x.dtype)
