"""Mask pooling over dense token maps (`clipself_tpu/ops/mask_pool.py`)."""

from __future__ import annotations

import torch


def mask_pool(feats: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Mean of feats [B, H, W, C] under binary masks [B, M, H, W] -> [B, M, C]
    in feats' dtype; an all-zero mask gives ~0 (the +1e-12 guard)."""
    b, h, w, c = feats.shape
    m = masks.reshape(b, -1, h * w).float()
    summed = torch.bmm(m, feats.reshape(b, h * w, c).float())
    denom = m.sum(dim=-1, keepdim=True) + 1e-12
    return (summed / denom).to(feats.dtype)
