"""Shared conv / norm building blocks for the detector.

A port of `clipself_tpu/detector/layers.py`. Activations are channels-last
[B, H, W, C] at every module boundary, as in the JAX package; a convolution
sees them through a permuted view (NCHW shape, channels-last strides), which
cuDNN reads in place. Parameters are float32 and are cast to the input's
dtype at each convolution, as flax `Conv(dtype=..., param_dtype=float32)`
does; GroupNorm computes in float32 and the caller casts back. Weights are
in PyTorch's layouts (conv OIHW, transposed conv IOHW);
`models/torch_io.py::detector_state_dict_from_jax` converts a flax tree.

The reference uses SyncBN; like the JAX package the port uses GroupNorm:
deterministic and independent of the batch size.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.Module):
    """GroupNorm over channels-last input, computed in float32 (returns
    float32): gcd(32, C) groups, eps 1e-5."""

    def __init__(self, features: int):
        super().__init__()
        self.groups = math.gcd(32, features)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(
            x.float().movedim(-1, 1), self.groups, self.weight, self.bias, eps=1e-5
        )
        return y.movedim(1, -1)


def make_norm(kind: str, features: int) -> Optional[nn.Module]:
    """The norm of kind 'gn' (GroupNorm) or 'none'. The JAX package's 'ln'
    kind, which no preset uses, is not ported."""
    if kind == "gn":
        return GroupNorm(features)
    if kind == "none":
        return None
    raise ValueError(f"unknown or unported norm kind {kind!r}")


class Conv2d(nn.Module):
    """kxk stride-1 convolution (k odd) with 'SAME' padding on channels-last
    input. Built zero-filled; `FViTDetector.init_weights` draws the weights."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, bias: bool = True):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"kernel size {kernel}: only odd sizes pad symmetrically")
        self.kernel = kernel
        self.weight = nn.Parameter(torch.zeros(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.movedim(-1, 1), self.weight.to(x.dtype), bias, padding=self.kernel // 2)
        return y.movedim(1, -1)


class Deconv2x2(nn.Module):
    """2x2 stride-2 transposed convolution on channels-last input (weight
    [in, out, 2, 2], PyTorch's layout): every input cell becomes a 2x2 block."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_features, features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(
            x.movedim(-1, 1), self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2
        )
        return y.movedim(1, -1)


class ConvNorm(nn.Module):
    """kxk conv + optional norm + optional ReLU. The conv has a bias only
    without a norm."""

    def __init__(self, in_features: int, features: int, kernel: int = 3, norm: str = "gn",
                 act: bool = True):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel, bias=norm == "none")
        self.norm = make_norm(norm, features)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x).to(dtype)
        return F.relu(x) if self.act else x


class DeconvNorm(nn.Module):
    """2x2 stride-2 transposed conv (+ optional norm / exact GELU) for the
    ViT feature pyramid."""

    def __init__(self, in_features: int, features: int, norm: str = "none", act: bool = False):
        super().__init__()
        self.deconv = Deconv2x2(in_features, features)
        self.norm = make_norm(norm, features)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = self.deconv(x)
        if self.norm is not None:
            x = self.norm(x).to(dtype)
        return F.gelu(x) if self.act else x


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of [B, H, W, C] (a trailing odd row or column is
    dropped, as flax `max_pool` with 'VALID' padding does)."""
    return F.max_pool2d(x.movedim(-1, 1), 2, 2).movedim(1, -1)
