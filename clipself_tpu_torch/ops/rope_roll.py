"""Rolled 2-D RoPE on the flat [B, N, W] projection layout, forward and
backward.

    y = x * cos + roll(x, -1) * sin_a + roll(x, +1) * sin_b

along the last axis, per head of width D = head_dim, with the tables given
as [N, D] (RoPE is head-independent; `models/rope.py` builds them). The CUDA
kernel (`csrc/rope_roll.cu`) replaces the Pallas kernel of
`clipself_tpu/ops/rope_roll.py`; `rolled_rope_plain` is the same function in
plain PyTorch. Both compute in float32 and round once to x's dtype.

`rolled_rope` and `rolled_rope_qk` run `RolledRopeFn`, the counterpart of the
JAX `custom_vjp` (`rope_roll.py:124-149`). With
y_i = c_i x_i + a_i x_{i+1} + b_i x_{i-1},

    dx = dy * c + roll(dy, -1) * roll(b, -1) + roll(dy, +1) * roll(a, +1),

the forward composition with a_bwd = roll(sin_a, +1) and b_bwd =
roll(sin_b, -1) in swapped slots, so the backward runs the same kernel.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises. The tables must carry the parity folding of
`models/rope.py::_split_sin_np` (sin_a zero on odd lanes, sin_b zero on even
lanes): the kernel reads only the nonzero entry of each lane pair, from one
packed [N, D / 2, 4] table {cos[2i], cos[2i+1], sin_a[2i], sin_b[2i+1]}
(`pack_tables`). The backward tables keep that parity in their slots
(roll(sin_b, -1) is zero on odd lanes, roll(sin_a, +1) on even lanes), so the
kernel runs the backward unchanged, on `pack_tables(cos, b_bwd, a_bwd)`.

One launch rotates one tensor or two of the same shape: `rolled_rope_qk`
rotates q and k of an attention block together, `rolled_rope` one tensor;
both are `RolledRopeFn` on the packed tables (the backward one launch on the
gradients), which a caller packs once (`models/rope.py::rope_tables_packed`).
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()      # forward launches, of one tensor or two
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


def pack_tables(cos: torch.Tensor, sin_a: torch.Tensor, sin_b: torch.Tensor) -> torch.Tensor:
    """The three [N, D] tables as the kernel reads them: float32 [N, D / 2, 4]
    with {cos[2i], cos[2i+1], sin_a[2i], sin_b[2i+1]} for pair i. sin_a's odd
    and sin_b's even lanes (zeros by the parity folding) are not stored."""
    parts = (cos[:, 0::2], cos[:, 1::2], sin_a[:, 0::2], sin_b[:, 1::2])
    return torch.stack(parts, dim=-1).float().contiguous()


def unpack_tables(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cos, sin_a, sin_b), each [N, D], of a packed table: `pack_tables`
    undone, with the zeros of the parity folding back in their lanes."""
    zero = torch.zeros_like(packed[..., 0])
    cos = torch.stack((packed[..., 0], packed[..., 1]), dim=-1).flatten(1)
    sin_a = torch.stack((packed[..., 2], zero), dim=-1).flatten(1)
    sin_b = torch.stack((zero, packed[..., 3]), dim=-1).flatten(1)
    return cos, sin_a, sin_b


def kernel_design(dtype: torch.dtype, head_dim: int) -> str:
    """What a thread of the kernel moves at once for this type and head_dim:
    'row-tiled, 16-byte spans' or, where head_dim's bytes do not split into
    such spans, 'row-tiled, pair spans' (the C entry point picks alike)."""
    full = 128 // torch.finfo(dtype).bits
    return f"row-tiled, {'16-byte' if head_dim % full == 0 else 'pair'} spans"


def rolled_rope_packed(
    xs: tuple[torch.Tensor, ...], packed: torch.Tensor, backward: bool = False
) -> tuple[torch.Tensor, ...]:
    """RoPE of one or two tensors [B, N, W] of one shape and type with the
    packed float32 table [N, D / 2, 4], in one launch; returns new tensors.
    ``backward`` only picks the launch counter: the backward is this function
    on the gradients with the packed backward tables."""
    x = xs[0]
    if x.device.type == "cpu":
        tables = unpack_tables(packed)
        return tuple(rolled_rope_plain(t, *tables) for t in xs)
    if x.device.type != "cuda":
        raise ValueError(f"rolled_rope: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rolled_rope: dtype {x.dtype} (takes float32, bfloat16)")
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"rolled_rope: one or two tensors a launch, got {len(xs)}")
    for t in xs:
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"rolled_rope: x must be a contiguous [B, N, W], got {tuple(t.shape)}")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("rolled_rope: the tensors of one launch must agree in shape, type and device")
    b, n, w = x.shape
    if packed.dim() != 3 or packed.shape[0] != n or packed.shape[2] != 4:
        raise ValueError(f"rolled_rope: the packed table must be [{n}, D / 2, 4], got {tuple(packed.shape)}")
    if packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("rolled_rope: the packed table must be contiguous float32")
    if packed.device != x.device:
        raise ValueError(f"rolled_rope: table on {packed.device}, x on {x.device}")
    d = 2 * packed.shape[1]
    if d == 0 or w % d:
        raise ValueError(f"rolled_rope: head_dim {d} must divide width {w}")
    ys = tuple(torch.empty_like(t) for t in xs)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.clipself_rope_roll(
            _DTYPES[x.dtype], len(xs), xs[0].data_ptr(), xs[-1].data_ptr(), packed.data_ptr(),
            ys[0].data_ptr(), ys[-1].data_ptr(), b, n, w, d, _build.stream_handle(x),
        )
    _build.check(err, "rope_roll launch")
    (BWD_LAUNCHES if backward else LAUNCHES).add()
    return ys


def rolled_rope_bwd(
    dys: tuple[torch.Tensor, ...], packed_bwd: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """The inputs' gradients from the outputs' gradients (made contiguous:
    the flash backward may hand over views) and
    `pack_tables(cos, b_bwd, a_bwd)`, in one launch."""
    return rolled_rope_packed(tuple(dy.contiguous() for dy in dys), packed_bwd, backward=True)


class RolledRopeFn(torch.autograd.Function):
    """Rolled RoPE of one tensor or two in one launch; the backward is the
    same launch on the gradients with the packed backward table."""

    @staticmethod
    def forward(ctx, packed, packed_bwd, *xs):
        ctx.save_for_backward(packed_bwd)
        return rolled_rope_packed(xs, packed)

    @staticmethod
    def backward(ctx, *dys):
        (packed_bwd,) = ctx.saved_tensors
        return (None, None, *rolled_rope_bwd(dys, packed_bwd))


def rolled_rope(x: torch.Tensor, packed: torch.Tensor, packed_bwd: torch.Tensor) -> torch.Tensor:
    """RoPE of x [B, N, W], differentiable through `RolledRopeFn`; the tables
    as for `rolled_rope_qk`."""
    return RolledRopeFn.apply(packed, packed_bwd, x)[0]


def rolled_rope_qk(
    q: torch.Tensor, k: torch.Tensor, packed: torch.Tensor, packed_bwd: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE of q and k, both [B, N, W], differentiable through
    `RolledRopeFn`; ``packed`` is `pack_tables(cos, sin_a, sin_b)` and
    ``packed_bwd`` `pack_tables(cos, b_bwd, a_bwd)` (the rolled tables in
    swapped slots), as `models/rope.py::rope_tables_packed` builds them."""
    return RolledRopeFn.apply(packed, packed_bwd, q, k)
