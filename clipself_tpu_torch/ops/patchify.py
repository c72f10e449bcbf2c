"""Patch embedding as reshape + matmul.

A stride-p VALID convolution with a p x p kernel is a matmul over
non-overlapping patches (`clipself_tpu/ops/patchify.py`). The weight stays in
the torch OIHW layout of the reference checkpoints; a float32 cuDNN
convolution would run in TF32 by default, the matmul keeps full float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def patchify(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], dtype: torch.dtype
) -> torch.Tensor:
    """x [B, H, W, C] channels-last; weight [F, C, p, p] -> [B, H/p, W/p, F]
    in ``dtype``. Trailing pixels that do not fill a patch are dropped."""
    f, cin, p, _ = weight.shape
    b, h, w, _ = x.shape
    gh, gw = h // p, w // p
    x = x[:, : gh * p, : gw * p, :]
    # [B, gh, p, gw, p, C] -> [B, gh, gw, p, p, C]: (kh, kw, cin) order, the
    # same as the OIHW weight permuted to [F, kh, kw, cin]
    xp = x.reshape(b, gh, p, gw, p, cin).permute(0, 1, 3, 2, 4, 5)
    xp = xp.reshape(b, gh, gw, p * p * cin).to(dtype)
    wm = weight.permute(0, 2, 3, 1).reshape(f, p * p * cin).to(dtype)
    return F.linear(xp, wm, None if bias is None else bias.to(dtype))
