"""Multi-head self-attention over [B, N, H, D] tensors, forward and backward.

`flash_attention` is the towers' entry point. Where a gradient is wanted it
runs `FlashAttentionFn`, the counterpart of the JAX package's
`_flash_fused_vjp` (`clipself_tpu/ops/attention.py:275-326`): the forward
keeps O and a row log-sum-exp `lse` [B, H, N] f32, the backward is the
flash backward (a dK / dV pass and a dQ pass, each summing in a fixed
order). Under `torch.no_grad` (the teacher, the evaluator)
it runs the forward alone and writes no LSE.

On CUDA tensors both directions are hand-written kernels:
`flash_attention_fwd` runs `csrc/flash_attention.cu` (replaces the Pallas
flash forward that `_bundled_fwd` reaches) and `flash_attention_bwd` runs
`csrc/flash_attention_bwd.cu` (replaces `clipself_tpu/ops/flash_bwd.py`).
Both mask the ragged tail in the kernel (no padding to a block multiple, no
segment row) and read q, k and v through their strides, so the per-head
views of a [B, N, H * D] projection need no copy. Each file holds three
designs and its C entry point picks one from dtype and head_dim alone
(`kernel_design` reports which): bfloat16 at head_dim 64-128 (64: every
attention call of the EVA02 towers; 80: ViT-H-14; 88: ViT-g-14 and
EVA01-g-14; 104: ViT-bigG-14; 112: EVA02-CLIP-bigE-14 and ViT-e-14) runs
`wgmma` products on swizzled tiles of one or two 64-column panels fed by a
`cp.async` ring with the softmax, P and dS in registers
(`csrc/hopper_mma.cuh` holds the shared pieces); bfloat16 below head_dim 64
(the tiny test towers) runs WMMA tiles; float32 (the HF trunks and every
parity path) runs "tf32x3": every product on the tensor cores as three TF32
products of a split x = hi + lo of each operand (lo_a hi_b + hi_a lo_b +
hi_a hi_b, lo_a lo_b dropped), which keeps float32 accuracy where one TF32
product keeps three digits, at three tensor-core products a float32 one:
the scores (products over the head_dim) on `wgmma` against tiles stored
split in shared memory (in the backward up to tile width 96; past it on
`mma.sync`), the value products on `mma.sync` from registers. Its bound on
the card is those products at the TF32 rate. Every
design takes any head_dim that is a multiple of 8 up to 128: tiles are the
head_dim rounded up to 16 columns, the columns past the head_dim loaded as
zeros and never stored.

On CPU tensors they run the plain versions below: `attention_plain` (the
f32-softmax semantics of `_xla_attention`), `attention_lse_plain`, and
`attention_bwd_plain`, which recomputes P = exp(S * scale - lse) and forms
dS = P * (dP - di) * scale with di = rowsum(dO * O), the formulas of
`flash_bwd.py:97-125`, so the CPU tests exercise the kernel's arithmetic and
not autograd's. A CUDA tensor launches the kernel or raises.

`attention_masked` takes an additive mask and runs in plain PyTorch on
every device: the text tower's causal attention and the OpenCLIP ViT's
mask-attention pooling, which the JAX package runs through XLA and not
through a Pallas kernel. `multi_head_attention` picks between the two as
the JAX dispatch does: a mask, or keys of another length than the queries
(cross-attention: the CoCa pooler and decoder), go to `attention_masked`;
unmasked self-attention goes to the flash kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()      # forward kernel launches
BWD_LAUNCHES = _build.LaunchCounter()  # backward kernel launches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 [B, H, N, N] scaled logits of [B, N, H, D] q and k."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def attention_masked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v on q [B, Nq, H, D] and k, v [B, Nk,
    H, D], on any device: f32 logits and softmax, probabilities cast to the
    input dtype before the value product; ``mask`` is an additive float32
    mask broadcast against the [B, H, Nq, Nk] logits. The JAX package's
    XLA attention (`clipself_tpu/ops/attention.py::_xla_attention`), which
    the text tower runs with its causal mask and the CoCa pooler and
    decoder without one (cross-attention); no Pallas kernel stands behind
    it."""
    logits = _logits(q, k, scale)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """The flash kernel's plain version: `attention_masked` without a mask."""
    return attention_masked(q, k, v, scale)


def attention_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """`attention_plain` and the natural-log row log-sum-exp of the scaled
    logits, lse [B, H, N] float32."""
    logits = _logits(q, k, scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's dtype from the forward's O and lse, as the
    flash backward computes them: products accumulate in f32, P and dS are
    rounded to the input dtype before their products."""
    dt = q.dtype
    p = torch.exp(_logits(q, k, scale) - lse[..., None])         # [B, H, Nq, Nk]
    di = (do.float() * o.float()).sum(-1).permute(0, 2, 1)       # [B, H, Nq]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - di[..., None]) * scale).to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str) -> None:
    """What the CUDA kernels take: float32 or bfloat16 [B, N, H, D] views,
    D a multiple of 8 up to 128, unit stride on D, 16-byte aligned rows."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} (takes float32, bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"{what}: expected [B, N, H, D], got {tuple(q.shape)}")
    d = q.shape[-1]
    if d % 8 or d > 128:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 8 up to 128")
    align = 16 // q.element_size()  # elements per 16-byte vector load
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{what}: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"q is {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} needs unit stride on head_dim and 16-byte "
                f"aligned rows, got strides {t.stride()}"
            )


_DESIGNS = {1: "wmma", 2: "wgmma", 3: "tf32x3"}


def kernel_design(dtype: torch.dtype, head_dim: int, backward: bool = False) -> str:
    """Which hand-written kernel the C entry point runs for this dtype and
    head_dim, as the library itself reports it: "wgmma" (bfloat16 at
    head_dim 64-128), "wmma" (bfloat16 below 64) or "tf32x3" (float32 at
    every head_dim: the three-product TF32 split, its scores on `wgmma` up
    to tile width 96 in the backward and at every width in the forward, the
    rest on `mma.sync`). The shape fixes it; no argument chooses."""
    lib = _build.LIBRARY.get()
    fn = lib.clipself_flash_bwd_design if backward else lib.clipself_flash_fwd_design
    code = fn(_DTYPES.get(dtype, -1), int(head_dim))
    if code not in _DESIGNS:
        raise ValueError(f"no flash-attention kernel for {dtype} at head_dim {head_dim}")
    return _DESIGNS[code]


def _strides(*ts: torch.Tensor) -> list[int]:
    return [s for t in ts for s in t.stride()[:3]]


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    return_lse: bool = False,
):
    """softmax(q k^T * scale) v on [B, N, H, D] as a contiguous [B, N, H, D]
    tensor; with ``return_lse``, also the row log-sum-exp [B, H, N] f32."""
    _build.refuse_dtensor("flash_attention", q, k, v)
    _check_device(q, "flash_attention")
    if q.device.type == "cpu":
        if return_lse:
            return attention_lse_plain(q, k, v, scale)
        return attention_plain(q, k, v, scale)
    _check_qkv(q, k, v, "flash_attention")
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if return_lse else None
    lib = _build.LIBRARY.get()
    with torch.cuda.device(q.device):
        err = lib.clipself_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, n, h, d, *_strides(q, k, v), float(scale), _build.stream_handle(q),
        )
    _build.check(err, "flash_attention launch")
    LAUNCHES.add()
    return (out, lse) if return_lse else out


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), contiguous [B, N, H, D] in q's dtype, from the forward's
    output ``o`` and ``lse`` and the output gradient ``do``. On a CUDA tensor
    the kernel's every sum runs in a fixed order (dQ over the key tiles in
    ascending order, as the TPU kernel's kv grid), so the result repeats bit
    for bit from call to call."""
    _build.refuse_dtensor("flash_attention_bwd", q, k, v, o, lse, do)
    _check_device(q, "flash_attention_bwd")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, scale)
    _check_qkv(q, k, v, "flash_attention_bwd")
    b, n, h, d = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a contiguous {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous float32 [{b}, {h}, {n}]")
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    di = torch.empty((b, h, n), dtype=torch.float32, device=q.device)  # rowsum(dO * O)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(q.device):
        err = lib.clipself_flash_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            di.data_ptr(),
            b, n, h, d, *_strides(q, k, v), float(scale), _build.stream_handle(q),
        )
    _build.check(err, "flash_attention_bwd launch")
    BWD_LAUNCHES.add()
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the flash backward: the forward keeps (q, k,
    v, O, lse), the backward runs `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, N, H, D]; returns a contiguous
    [B, N, H, D] tensor, differentiable through `FlashAttentionFn`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The towers' attention entry point over q [B, Nq, H, D] and k, v
    [B, Nk, H, D] (`clipself_tpu/ops/attention.py:460-502`): unmasked
    self-attention (Nk == Nq) takes the flash kernel (`flash_attention`);
    an additive ``mask``, or cross-attention (Nk != Nq), takes
    `attention_masked` on every device, as the JAX package takes XLA's
    attention there (f32 logits, the `xla_attn_half_logits` knob off): its
    flash path derives the ragged tail from q's length alone."""
    if mask is not None or k.shape[1] != q.shape[1]:
        return attention_masked(q, k, v, scale, mask)
    return flash_attention(q, k, v, scale)
