"""Multi-head self-attention over [B, N, H, D] tensors (kernel 2).

`flash_attention` runs the hand-written CUDA forward (`csrc/flash_attention.cu`)
that replaces the Pallas flash kernel the JAX package reaches through
`clipself_tpu/ops/attention.py::_bundled_fwd`. It masks the ragged tail in the
kernel (no padding to a block multiple, no segment row) and reads q, k and v
through their strides, so the per-head views of a [B, N, H * D] projection
need no copy. `attention_plain` is the same function in plain PyTorch, with
the f32-softmax semantics of `clipself_tpu/ops/attention.py::_xla_attention`.

Dispatch: tensors on the CPU take the plain version; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, N, H, D]: f32 logits and softmax,
    probabilities cast to the input dtype before the value product."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, N, H, D]; returns a contiguous
    [B, N, H, D] tensor."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} (takes float32, bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: expected [B, N, H, D], got {tuple(q.shape)}")
    b, n, h, d = q.shape
    if d % 16 or d > 128:
        raise ValueError(f"flash_attention: head_dim {d} must be a multiple of 16 up to 128")
    align = 16 // q.element_size()  # elements per 16-byte vector load
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"q is {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} needs unit stride on head_dim and 16-byte "
                f"aligned rows, got strides {t.stride()}"
            )
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(q.device):
        err = lib.clipself_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), _build.stream_handle(q),
        )
    _build.check(err, "flash_attention launch")
    LAUNCHES.add()
    return out


# the JAX package's name for the towers' attention entry point
multi_head_attention = flash_attention
