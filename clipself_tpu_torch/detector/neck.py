"""ViT feature pyramid + FPN neck, a port of `clipself_tpu/detector/neck.py`.

`SimpleFeaturePyramid` turns the four equal-resolution ViT taps into a
4x / 2x / 1x / 0.5x pyramid; `FPN` is the standard mmdet FPN with norm'd
lateral / output convs and an extra subsampled level.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from clipself_tpu_torch.detector.layers import Conv2d, ConvNorm, DeconvNorm, make_norm, max_pool_2x2
from clipself_tpu_torch.ops.interpolate import resize_nhwc


class SimpleFeaturePyramid(nn.Module):
    """[B, h, w, width] x4 (stride-16 taps) -> strides (4, 8, 16, 32)."""

    def __init__(self, width: int, norm: str = "gn"):
        super().__init__()
        self.up4_a = DeconvNorm(width, width, norm=norm, act=True)
        self.up4_b = DeconvNorm(width, width, norm="none", act=False)
        self.up2 = DeconvNorm(width, width, norm="none", act=False)

    def forward(self, taps: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        if len(taps) != 4:
            raise ValueError(f"expected 4 backbone taps, got {len(taps)}")
        p4 = self.up4_b(self.up4_a(taps[0]))
        p8 = self.up2(taps[1])
        p16 = taps[2]
        p32 = max_pool_2x2(taps[3])
        return [p4, p8, p16, p32]


class FPN(nn.Module):
    """Top-down feature pyramid (mmdet FPN semantics: 1x1 laterals, nearest
    top-down sum, 3x3 output convs, extra levels by stride-2 subsampling)."""

    def __init__(self, in_features: int, num_ins: int = 4, out_channels: int = 256,
                 num_outs: int = 5, norm: str = "gn"):
        super().__init__()
        self.num_ins, self.num_outs = num_ins, num_outs
        for i in range(num_ins):
            setattr(self, f"lateral_{i}", Conv2d(in_features, out_channels, 1, bias=norm == "none"))
            lateral_norm = make_norm(norm, out_channels)
            if lateral_norm is not None:
                setattr(self, f"lateral_norm_{i}", lateral_norm)
            setattr(
                self, f"fpn_conv_{i}",
                ConvNorm(out_channels, out_channels, kernel=3, norm=norm, act=False),
            )

    def forward(self, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        n = len(inputs)
        if n != self.num_ins:
            raise ValueError(f"expected {self.num_ins} pyramid levels, got {n}")
        laterals = []
        for i, x in enumerate(inputs):
            y = getattr(self, f"lateral_{i}")(x)
            lateral_norm = getattr(self, f"lateral_norm_{i}", None)
            if lateral_norm is not None:
                y = lateral_norm(y).to(x.dtype)
            laterals.append(y)
        for i in range(n - 1, 0, -1):
            up = resize_nhwc(laterals[i], laterals[i - 1].shape[1:3], method="nearest")
            laterals[i - 1] = laterals[i - 1] + up
        outs = [getattr(self, f"fpn_conv_{i}")(laterals[i]) for i in range(n)]
        while len(outs) < self.num_outs:
            # a 1x1 max pool with stride 2 is plain subsampling
            outs.append(outs[-1][:, ::2, ::2])
        return outs
