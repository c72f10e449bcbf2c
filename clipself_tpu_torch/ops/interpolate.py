"""Separable 2-D resizing as two float32 matmuls; nearest resizing of
channels-last maps as an index selection.

`resize_weight_matrix` is a NumPy copy of `clipself_tpu/ops/interpolate.py`
(torch `interpolate(align_corners=False)` sampling, bicubic with A=-0.75);
`tests/test_torch_ops.py` pins the copy equal to the original.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic-convolution weights for the 4 taps around offset t:
    shape t.shape + (4,)."""
    t = np.asarray(t, dtype=np.float64)
    x0 = t + 1.0
    x1 = t
    x2 = 1.0 - t
    x3 = 2.0 - t

    def near(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def far(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return np.stack([far(x0), near(x1), near(x2), far(x3)], axis=-1)


@functools.lru_cache(maxsize=256)
def resize_weight_matrix(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """Row-stochastic [out_size, in_size] interpolation matrix:
    src = (dst + 0.5) * (in/out) - 0.5, with border-clamped taps."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if method == "bicubic":
        i0 = np.floor(src).astype(np.int64)
        t = src - i0
        cw = _cubic_weights(t)
        for k in range(4):
            idx = np.clip(i0 - 1 + k, 0, in_size - 1)
            np.add.at(w, (dst.astype(np.int64), idx), cw[:, k])
    elif method == "bilinear":
        s = np.maximum(src, 0.0)
        i0 = np.minimum(np.floor(s).astype(np.int64), in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        frac = np.clip(s - i0, 0.0, 1.0)
        np.add.at(w, (dst.astype(np.int64), i0), 1.0 - frac)
        np.add.at(w, (dst.astype(np.int64), i1), frac)
    elif method == "nearest":
        idx = np.minimum((dst * scale).astype(np.int64), in_size - 1)
        w[dst.astype(np.int64), idx] = 1.0
    else:
        raise ValueError(f"unknown method: {method}")
    return w.astype(np.float32)


def resize_2d(x: torch.Tensor, out_hw: tuple[int, int], method: str = "bicubic") -> torch.Tensor:
    """Resize the trailing two dims of ``x[..., H, W]`` to ``out_hw``, as two
    float32 matmuls, cast back to x's dtype."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    wh = torch.from_numpy(resize_weight_matrix(h_in, h_out, method)).to(x.device)
    ww = torch.from_numpy(resize_weight_matrix(w_in, w_out, method)).to(x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    y = torch.einsum("pw,...ow->...op", ww, y)
    return y.to(x.dtype)


def resize_nhwc(x: torch.Tensor, out_hw: tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize ``x[B, H, W, C]`` to ``[B, h, w, C]`` (channels-last), the
    counterpart of `clipself_tpu/ops/interpolate.py::resize_nhwc`. 'nearest'
    (source index floor(dst * in / out), as torch and mmdet) selects rows and
    columns, which is what the JAX package's one-hot weight matrices compute."""
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    if method == "nearest":
        rows, cols = (
            torch.from_numpy(resize_weight_matrix(i, o, "nearest").argmax(axis=1)).to(x.device)
            for i, o in ((h_in, h_out), (w_in, w_out))
        )
        return x[:, rows][:, :, cols]
    return resize_2d(x.permute(0, 3, 1, 2), out_hw, method).permute(0, 2, 3, 1)
