"""2-D axial rotary position embeddings for the EVA vision tower.

The table functions are NumPy copies of `clipself_tpu/models/rope.py`
(`rope_tables_np`, `_split_sin_np`, `rope_tables_padded_np`,
`rope_tables_flat_np`); `tests/test_torch_rope.py` pins them equal to the
originals. `apply_rope_gathered` rotates the tokens that patch dropout kept,
each by its grid position, in plain PyTorch (the JAX package's
`apply_rope_gathered` is plain XLA too). `apply_rope_flat_qk` rotates the flat [B, N, H * head_dim] q and
k projections of an attention block in one launch of the rolled-RoPE kernel
(`ops/rope_roll.py`), `apply_rope_flat` one such tensor. The tables are
[N, head_dim] float32 (identity rows for the CLS prefix, and no pad tail,
since the port never pads the sequence), packed once per grid and device as
the kernel reads them (`rope_tables_packed`); the backward runs the same
kernel on the rolled tables of `rope_tables_bwd` (the `a_bwd`/`b_bwd` of
`clipself_tpu/models/rope.py:216-217`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from clipself_tpu_torch.ops.rope_roll import pack_tables, rolled_rope, rolled_rope_qk


@functools.lru_cache(maxsize=64)
def rope_tables_np(
    grid_h: int,
    grid_w: int,
    rope_dim: int,
    pt_seq_len: int = 16,
    theta: float = 10000.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Build (cos, sin) tables of shape [grid_h * grid_w, 2 * rope_dim].

    ``rope_dim`` is half the head dim (each spatial axis rotates half).
    """
    freqs = 1.0 / (
        theta ** (np.arange(0, rope_dim, 2)[: rope_dim // 2].astype(np.float64) / rope_dim)
    )

    def axis_freqs(size: int) -> np.ndarray:
        t = np.arange(size, dtype=np.float64) / size * pt_seq_len
        f = np.outer(t, freqs)
        return np.repeat(f, 2, axis=-1)

    fh = axis_freqs(grid_h)
    fw = axis_freqs(grid_w)
    full = np.concatenate(
        [
            np.broadcast_to(fh[:, None, :], (grid_h, grid_w, rope_dim)),
            np.broadcast_to(fw[None, :, :], (grid_h, grid_w, rope_dim)),
        ],
        axis=-1,
    ).reshape(grid_h * grid_w, 2 * rope_dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def _split_sin_np(sin: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fold the pairwise-rotation signs and lane parity into two sin tables:
    ``x*cos + rotate_half(x)*sin == x*cos + roll(x,-1)*sin_a + roll(x,+1)*sin_b``
    with sin_a = -sin on even lanes (0 on odd) and sin_b = +sin on odd lanes
    (0 on even)."""
    parity = np.arange(sin.shape[-1]) % 2
    sin_a = np.where(parity == 0, -sin, 0.0).astype(sin.dtype)
    sin_b = np.where(parity == 1, sin, 0.0).astype(sin.dtype)
    return sin_a, sin_b


@functools.lru_cache(maxsize=64)
def rope_tables_padded_np(
    grid_h: int,
    grid_w: int,
    rope_dim: int,
    n_prefix: int,
    n_total: int,
    pt_seq_len: int = 16,
    theta: float = 10000.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full-sequence (cos, sin_a, sin_b) tables of shape [n_total, 2*rope_dim]
    with identity rows (cos=1, sin=0) outside [n_prefix, n_prefix + H*W)."""
    cos_p, sin_p = rope_tables_np(grid_h, grid_w, rope_dim, pt_seq_len, theta)
    d = 2 * rope_dim
    n_patch = grid_h * grid_w
    if n_prefix + n_patch > n_total:
        raise ValueError(f"rope table: {n_prefix}+{n_patch} patches > {n_total} tokens")
    cos = np.ones((n_total, d), np.float32)
    sin = np.zeros((n_total, d), np.float32)
    cos[n_prefix : n_prefix + n_patch] = cos_p
    sin[n_prefix : n_prefix + n_patch] = sin_p
    sin_a, sin_b = _split_sin_np(sin)
    return cos, sin_a, sin_b


@functools.lru_cache(maxsize=64)
def rope_tables_flat_np(
    grid_h: int,
    grid_w: int,
    head_dim: int,
    n_heads: int,
    n_prefix: int,
    n_total: int,
    pt_seq_len: int = 16,
    theta: float = 10000.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded rolled tables tiled across heads: shape [n_total, n_heads*head_dim]."""
    cos, sin_a, sin_b = rope_tables_padded_np(
        grid_h, grid_w, head_dim // 2, n_prefix, n_total, pt_seq_len, theta
    )
    tile = lambda t: np.tile(t, (1, n_heads))  # noqa: E731
    return tile(cos), tile(sin_a), tile(sin_b)


@functools.lru_cache(maxsize=16)
def rope_tables(
    grid_h: int,
    grid_w: int,
    head_dim: int,
    n_prefix: int,
    pt_seq_len: int,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cos, sin_a, sin_b) float32 [n_prefix + grid_h*grid_w, head_dim] on
    ``device``, built once per grid and device. Callers must not write to
    them."""
    n_total = n_prefix + grid_h * grid_w
    tables = rope_tables_padded_np(grid_h, grid_w, head_dim // 2, n_prefix, n_total, pt_seq_len)
    return _cached_tensors(tables, device)


def _cached_tensors(arrays, device: torch.device) -> tuple[torch.Tensor, ...]:
    # normal tensors even when the first caller runs under inference_mode
    # (the evaluator): a later training step saves them for its backward
    with torch.inference_mode(False):
        return tuple(torch.tensor(a, device=device) for a in arrays)


@functools.lru_cache(maxsize=16)
def rope_tables_bwd(
    grid_h: int,
    grid_w: int,
    head_dim: int,
    n_prefix: int,
    pt_seq_len: int,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a_bwd, b_bwd) = (roll(sin_a, +1), roll(sin_b, -1)) along the head
    axis, float32 [N, head_dim] on ``device``: the backward tables of
    `rope_tables`. Callers must not write to them."""
    n_total = n_prefix + grid_h * grid_w
    _, sin_a, sin_b = rope_tables_padded_np(
        grid_h, grid_w, head_dim // 2, n_prefix, n_total, pt_seq_len
    )
    return _cached_tensors((np.roll(sin_a, 1, axis=-1), np.roll(sin_b, -1, axis=-1)), device)


@functools.lru_cache(maxsize=16)
def rope_tables_packed(
    grid_h: int,
    grid_w: int,
    head_dim: int,
    n_prefix: int,
    pt_seq_len: int,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, backward) tables packed for the kernel, each float32
    [N, head_dim / 2, 4] on ``device``: `pack_tables(cos, sin_a, sin_b)` and,
    for the backward, `pack_tables(cos, b_bwd, a_bwd)`: the rolled tables in
    swapped slots, which keeps the parity folding (b_bwd is zero on odd
    lanes, a_bwd on even lanes). Callers must not write to them."""
    key = (grid_h, grid_w, head_dim, n_prefix, pt_seq_len, device)
    cos, sin_a, sin_b = rope_tables(*key)
    a_bwd, b_bwd = rope_tables_bwd(*key)
    with torch.inference_mode(False):
        return pack_tables(cos, sin_a, sin_b), pack_tables(cos, b_bwd, a_bwd)


def apply_rope_flat(
    x: torch.Tensor,
    grid_h: int,
    grid_w: int,
    head_dim: int,
    n_prefix: int = 1,
    pt_seq_len: int = 16,
) -> torch.Tensor:
    """Rotate a [CLS; patches] sequence in flat layout ``x[B, N, H*head_dim]``
    (N = n_prefix + grid_h*grid_w); the prefix tokens are not rotated."""
    key = (grid_h, grid_w, head_dim, n_prefix, pt_seq_len, x.device)
    return rolled_rope(x, *rope_tables_packed(*key))


def apply_rope_flat_qk(
    q: torch.Tensor,
    k: torch.Tensor,
    grid_h: int,
    grid_w: int,
    head_dim: int,
    n_prefix: int = 1,
    pt_seq_len: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`apply_rope_flat` of q and of k, both [B, N, H*head_dim], in one
    launch of the kernel (forward and backward)."""
    key = (grid_h, grid_w, head_dim, n_prefix, pt_seq_len, q.device)
    return rolled_rope_qk(q, k, *rope_tables_packed(*key))


def apply_rope_gathered(
    x: torch.Tensor, keep_idx: torch.Tensor, grid_h: int, grid_w: int, pt_seq_len: int = 16
) -> torch.Tensor:
    """Rotate a patch-dropout-reduced token set ``x[B, K, H, D]`` whose
    original grid positions are ``keep_idx[B, K]``
    (`clipself_tpu/models/rope.py::apply_rope_gathered`): the rolled form
    x * cos + roll(x, -1) * sin_a + roll(x, 1) * sin_b, the tables gathered
    at the kept positions, in x's dtype."""
    d = x.shape[-1]
    cos_np, sin_np = rope_tables_np(grid_h, grid_w, d // 2, pt_seq_len)
    sin_a_np, sin_b_np = _split_sin_np(sin_np)
    idx = keep_idx.to(x.device)
    cos, sin_a, sin_b = (
        torch.as_tensor(t, device=x.device).to(x.dtype)[idx][:, :, None, :]
        for t in (cos_np, sin_a_np, sin_b_np)
    )
    return x * cos + torch.roll(x, -1, dims=-1) * sin_a + torch.roll(x, 1, dims=-1) * sin_b
