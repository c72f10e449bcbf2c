"""Ring attention: sequence-parallel exact attention over an `sp` group (a
port of `clipself_tpu/ops/ring_attention.py`).

Each rank of the group holds a shard of the sequence of q, k and v; the k
and v shards rotate around the ring (`parallel/mesh.py::ppermute`) while an
online softmax accumulates exact attention, so a rank holds one shard of
keys and values at a time. As in JAX the chunk math is plain products (XLA
einsums there, no Pallas kernel): here `torch` products on float32 logits
with TF32 off, and autograd differentiates the ring, its exchanges
included. No kernel of the port stands behind it; a ring over the flash
kernel and its LSE would be another design.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from clipself_tpu_torch.parallel.mesh import ppermute


@contextlib.contextmanager
def _full_f32():
    """float32 products in full float32, not TF32 (the JAX einsums'
    ``preferred_element_type=float32``); the setting is restored after.
    The backward's products follow the caller's setting (off by default)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _chunk(q, k, v, scale, m, num, den):
    """Online-softmax accumulation of one KV chunk.

    q: [B, Q, H, D]; k/v: [B, C, H, D]; m/den: [B, H, Q]; num: [B, Q, H, D],
    the last three float32. q and k are cast to float32 before their
    product: a product in q's dtype would round the logits to it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)  # rescale factor for the running sums
    p = torch.exp(s - m_new[..., None])
    num = num * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    den = den * alpha + p.sum(-1)
    return m_new, num, den


def sequence_shard(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of the sequence of a global [B, N, H, D] ``x``:
    rank i of S in ``group`` holds [i N/S, (i + 1) N/S) (JAX's
    ``P(None, axis, None, None)``)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[1]
    if n % size:
        raise ValueError(f"a sequence of {n} must divide over {size} ranks")
    per = n // size
    return x[:, rank * per:(rank + 1) * per]


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, group=None
) -> torch.Tensor:
    """Exact multi-head attention with the sequence sharded over ``group``.

    Args:
      q, k, v: this rank's shard [B, N/S, H, D] of the sequence
        (`sequence_shard`), S the group's size.
      scale: softmax scale (usually D**-0.5).

    Returns this rank's shard of softmax(q k^T * scale) v over the whole
    sequence, in q's dtype, numerically equal to full attention (up to float
    association). Every rank of the group calls it. Differentiable: each
    rank's backward returns the gradients of its own shards, k's and v's
    summed over the ranks whose queries saw them; the ranks' k and v must
    agree on ``requires_grad`` (the shards of one tensor do), or the
    exchanges' backwards do not pair up. K and V rotate as one tensor: S - 1
    exchanges, the last chunk outside the loop, so no rotation goes
    unconsumed."""
    size = dist.get_world_size(group)
    b, n, h, _ = q.shape
    m = torch.full((b, h, n), float("-inf"), device=q.device)
    num = torch.zeros(q.shape, device=q.device)
    den = torch.zeros((b, h, n), device=q.device)
    kv = torch.stack((k, v))
    with _full_f32():
        for _ in range(size - 1):
            m, num, den = _chunk(q, kv[0], kv[1], scale, m, num, den)
            kv = ppermute(kv, group)
        m, num, den = _chunk(q, kv[0], kv[1], scale, m, num, den)
    return (num / den.transpose(1, 2)[..., None]).to(q.dtype)
