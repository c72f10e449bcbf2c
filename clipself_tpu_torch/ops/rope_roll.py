"""Rolled 2-D RoPE on the flat [B, N, W] projection layout, forward and
backward.

    y = x * cos + roll(x, -1) * sin_a + roll(x, +1) * sin_b

along the last axis, per head of width D = head_dim, with the tables given
as [N, D] (RoPE is head-independent; `models/rope.py` builds them). The CUDA
kernel (`csrc/rope_roll.cu`) replaces the Pallas kernel of
`clipself_tpu/ops/rope_roll.py`; `rolled_rope_plain` is the same function in
plain PyTorch. Both compute in float32 and round once to x's dtype.

`rolled_rope` runs `RolledRopeFn`, the counterpart of the JAX `custom_vjp`
(`rope_roll.py:124-149`). With y_i = c_i x_i + a_i x_{i+1} + b_i x_{i-1},

    dx = dy * c + roll(dy, -1) * roll(b, -1) + roll(dy, +1) * roll(a, +1),

the forward composition with a_bwd = roll(sin_a, +1) and b_bwd =
roll(sin_b, -1) in swapped slots, so the backward runs the same kernel.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises. The tables must carry the parity folding of
`models/rope.py::_split_sin_np` (sin_a zero on odd lanes, sin_b zero on even
lanes): the kernel reads only the nonzero entry of each lane pair. The
backward tables keep that parity in their slots (roll(sin_b, -1) is zero on
odd lanes, roll(sin_a, +1) on even lanes), so the kernel runs the backward
unchanged.
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()      # forward launches
BWD_LAUNCHES = _build.LaunchCounter()  # backward launches (the same kernel)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rolled_rope_plain(
    x: torch.Tensor, cos: torch.Tensor, sin_a: torch.Tensor, sin_b: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: x [B, N, W], tables [N, D] with W % D == 0."""
    b, n, w = x.shape
    d = cos.shape[-1]
    xf = x.float().reshape(b, n, w // d, d)
    c, sa, sb = (t.float()[:, None, :] for t in (cos, sin_a, sin_b))
    # the +-1 rolls never leave a head: the wrapped lanes meet zero entries
    y = xf * c + torch.roll(xf, -1, dims=-1) * sa + torch.roll(xf, 1, dims=-1) * sb
    return y.reshape(b, n, w).to(x.dtype)


def _apply(x, cos, sin_a, sin_b, counter: _build.LaunchCounter) -> torch.Tensor:
    if x.device.type == "cpu":
        return rolled_rope_plain(x, cos, sin_a, sin_b)
    if x.device.type != "cuda":
        raise ValueError(f"rolled_rope: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rolled_rope: dtype {x.dtype} (takes float32, bfloat16)")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"rolled_rope: x must be a contiguous [B, N, W], got {tuple(x.shape)}")
    b, n, w = x.shape
    d = cos.shape[-1]
    for name, t in (("cos", cos), ("sin_a", sin_a), ("sin_b", sin_b)):
        if t.shape != (n, d) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"rolled_rope: {name} must be a contiguous float32 [{n}, {d}]")
        if t.device != x.device:
            raise ValueError(f"rolled_rope: {name} on {t.device}, x on {x.device}")
    if d % 2 or w % d:
        raise ValueError(f"rolled_rope: head_dim {d} must be even and divide width {w}")
    y = torch.empty_like(x)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.clipself_rope_roll(
            _DTYPES[x.dtype], x.data_ptr(), cos.data_ptr(), sin_a.data_ptr(),
            sin_b.data_ptr(), y.data_ptr(), b, n, w, d, _build.stream_handle(x),
        )
    _build.check(err, "rope_roll launch")
    counter.add()
    return y


def rolled_rope_fwd(
    x: torch.Tensor, cos: torch.Tensor, sin_a: torch.Tensor, sin_b: torch.Tensor
) -> torch.Tensor:
    """RoPE of x [B, N, W] with float32 tables [N, D]; returns a new tensor."""
    return _apply(x, cos, sin_a, sin_b, LAUNCHES)


def rolled_rope_bwd(
    dy: torch.Tensor, cos: torch.Tensor, a_bwd: torch.Tensor, b_bwd: torch.Tensor
) -> torch.Tensor:
    """dx of `rolled_rope_fwd` from dy [B, N, W] and the backward tables."""
    return _apply(dy.contiguous(), cos, b_bwd, a_bwd, BWD_LAUNCHES)


class RolledRopeFn(torch.autograd.Function):
    """Rolled RoPE whose backward is the same kernel on the rolled tables."""

    @staticmethod
    def forward(ctx, x, cos, sin_a, sin_b, a_bwd, b_bwd):
        ctx.save_for_backward(cos, a_bwd, b_bwd)
        return rolled_rope_fwd(x, cos, sin_a, sin_b)

    @staticmethod
    def backward(ctx, dy):
        cos, a_bwd, b_bwd = ctx.saved_tensors
        return rolled_rope_bwd(dy, cos, a_bwd, b_bwd), None, None, None, None, None


def rolled_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin_a: torch.Tensor,
    sin_b: torch.Tensor,
    a_bwd: torch.Tensor,
    b_bwd: torch.Tensor,
) -> torch.Tensor:
    """RoPE of x [B, N, W], differentiable through `RolledRopeFn`; the
    backward tables are `models/rope.py::rope_tables_bwd`."""
    return RolledRopeFn.apply(x, cos, sin_a, sin_b, a_bwd, b_bwd)
