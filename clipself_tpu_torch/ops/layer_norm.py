"""Fused row LayerNorm over the last axis, forward and one-pass backward.

Per row, in float32 whatever x's dtype (the fast-variance association of
the JAX tower, `clipself_tpu/models/eva_vit.py:79-84`):

    mu = mean(x), var = max(mean(x^2) - mu^2, 0), rstd = rsqrt(var + eps)
    y  = (x - mu) * (rstd * weight) + bias             in x's dtype

    g  = dy * weight, xhat = (x - mu) * rstd
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat))  in x's dtype
    dweight = sum_rows dy * xhat, dbias = sum_rows dy  float32

The CUDA kernels (`csrc/layer_norm.cu`) replace the Pallas kernels of
`clipself_tpu/ops/layer_norm.py`; `layer_norm_plain` and
`layer_norm_bwd_plain` are the same formulas in plain PyTorch. The kernels
take any width and any row count, and read x through two row strides, so a
view like `t[:, 1:]` or `t[:, 0]` of a [B, N, W] tensor is not copied.

`layer_norm` runs `LayerNormFn`, the counterpart of the JAX `custom_vjp`
(`layer_norm.py:189-213`): the forward keeps (x, mu, rstd, weight), the
backward is the one-pass kernel. Where no input needs a gradient it runs the
forward alone, which writes no statistics.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()      # forward launches, with or without stats
BWD_LAUNCHES = _build.LaunchCounter()  # backward launches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# blocks of the backward kernel per SM: each writes a [2, W] partial sum
_BWD_BLOCKS_PER_SM = 2


def layer_norm_stats_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the row statistics: (y in x's dtype, mu,
    rstd float32 of shape x.shape[:-1]) for x [..., W] and float32 [W]
    weight and bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mu) * (rstd * weight) + bias).to(x.dtype)
    return y, mu[..., 0], rstd[..., 0]


def layer_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """Plain PyTorch version: x [..., W], weight and bias float32 [W]."""
    return layer_norm_stats_plain(x, weight, bias, eps)[0]


def layer_norm_bwd_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    mu: torch.Tensor,
    rstd: torch.Tensor,
    weight: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dweight, dbias float32 [W]) from the forward's
    float32 row statistics ``mu`` and ``rstd`` of shape x.shape[:-1]."""
    xf, dyf = x.float(), dy.float()
    mu, rstd = mu[..., None], rstd[..., None]
    xhat = (xf - mu) * rstd
    g = dyf * weight
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (g - m1 - xhat * m2)).to(x.dtype)
    rows = tuple(range(x.dim() - 1))
    return dx, (dyf * xhat).sum(dim=rows), dyf.sum(dim=rows)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _rows(x: torch.Tensor, what: str) -> tuple[int, int, int, int]:
    """(rows, n_inner, stride_outer, stride_inner) of x [..., W] for the
    kernels: row r starts at (r // n_inner) * stride_outer + (r % n_inner) *
    stride_inner elements. Takes contiguous tensors of any rank and 2-D or
    3-D views whose last axis has unit stride."""
    w = x.shape[-1]
    if x.is_contiguous():
        rows = x.numel() // w
        return rows, rows, 0, w
    if x.stride(-1) != 1 or x.dim() not in (2, 3):
        raise ValueError(
            f"{what}: x must be contiguous, or a 2-D or 3-D view with unit stride "
            f"on the last axis; got shape {tuple(x.shape)} strides {x.stride()}"
        )
    if x.dim() == 2:
        return x.shape[0], x.shape[0], 0, x.stride(0)
    return x.shape[0] * x.shape[1], x.shape[1], x.stride(0), x.stride(1)


def _check_cuda_inputs(x: torch.Tensor, vectors: dict, what: str) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} (takes float32, bfloat16)")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{what}: x must be a non-empty [..., W], got {tuple(x.shape)}")
    w = x.shape[-1]
    for name, t in vectors.items():
        if t.shape != (w,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 [{w}]")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")


def layer_norm_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    return_stats: bool = False,
):
    """LayerNorm of x [..., W] as a contiguous tensor of x's dtype; with
    ``return_stats`` also the float32 row mean and rstd of shape
    x.shape[:-1], which the backward takes."""
    _check_device(x, "layer_norm")
    if x.device.type == "cpu":
        out = layer_norm_stats_plain(x, weight, bias, eps)
        return out if return_stats else out[0]
    _check_cuda_inputs(x, {"weight": weight, "bias": bias}, "layer_norm")
    rows, n_inner, stride_outer, stride_inner = _rows(x, "layer_norm")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mu = rstd = None
    if return_stats:
        mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.clipself_layer_norm_fwd(
            _DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), None if mu is None else mu.data_ptr(),
            None if rstd is None else rstd.data_ptr(),
            rows, n_inner, stride_outer, stride_inner, x.shape[-1], float(eps),
            _build.stream_handle(x),
        )
    _build.check(err, "layer_norm launch")
    LAUNCHES.add()
    return (y, mu, rstd) if return_stats else y


def layer_norm_bwd(
    x: torch.Tensor,
    dy: torch.Tensor,
    mu: torch.Tensor,
    rstd: torch.Tensor,
    weight: torch.Tensor,
    need_dx: bool = True,
    need_dwb: bool = True,
):
    """(dx, dweight, dbias) of `layer_norm_fwd` from the output gradient
    ``dy`` (contiguous, x's shape and dtype) and the forward's statistics;
    dx is contiguous in x's dtype, dweight and dbias float32 [W]. An output
    that is not needed (``need_dx``, ``need_dwb`` for the pair) is None and is
    not computed on the card."""
    _check_device(x, "layer_norm_bwd")
    if not (need_dx or need_dwb):
        return None, None, None
    if x.device.type == "cpu":
        dx, dw, db = layer_norm_bwd_plain(x, dy, mu, rstd, weight)
        return (dx if need_dx else None,) + ((dw, db) if need_dwb else (None, None))
    what = "layer_norm_bwd"
    _check_cuda_inputs(x, {"weight": weight}, what)
    rows, n_inner, stride_outer, stride_inner = _rows(x, what)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"{what}: dy must be a contiguous {tuple(x.shape)} {x.dtype} on {x.device}")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if (
            t.shape != x.shape[:-1] or t.dtype != torch.float32
            or t.device != x.device or not t.is_contiguous()
        ):
            raise ValueError(f"{what}: {name} must be a contiguous float32 {tuple(x.shape[:-1])}")
    w = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device) if need_dx else None
    dw = db = partial = None
    max_blocks = _BWD_BLOCKS_PER_SM * torch.cuda.get_device_properties(x.device).multi_processor_count
    if need_dwb:
        dw = torch.empty(w, dtype=torch.float32, device=x.device)
        db = torch.empty_like(dw)
        # per-block partial sums, added up by the kernel's second stage
        partial = torch.empty((2, max_blocks, w), dtype=torch.float32, device=x.device)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.clipself_layer_norm_bwd(
            _DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), None if dx is None else dx.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if dw is None else dw.data_ptr(), None if db is None else db.data_ptr(),
            rows, n_inner, stride_outer, stride_inner, w, max_blocks,
            _build.stream_handle(x),
        )
    _build.check(err, "layer_norm_bwd launch")
    BWD_LAUNCHES.add()
    return dx, dw, db


class LayerNormFn(torch.autograd.Function):
    """Fused LayerNorm with the one-pass backward: the forward keeps (x, mu,
    rstd, weight), the backward runs `layer_norm_bwd` for the gradients that
    are needed."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps, return_stats=True)
        ctx.save_for_backward(x, mu, rstd, weight)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, weight = ctx.saved_tensors
        need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
        dx, dw, db = layer_norm_bwd(
            x, dy.contiguous(), mu, rstd, weight, need_dx=need_dx, need_dwb=need_dw or need_db
        )
        return dx, dw if need_dw else None, db if need_db else None, None


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm of x [..., W] over the last axis in x's dtype,
    differentiable through `LayerNormFn`."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return LayerNormFn.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps)
