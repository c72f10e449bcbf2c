"""GPipe pipeline parallelism over a group of stages (a port of
`clipself_tpu/parallel/pipeline.py`).

JAX stacks the blocks' parameters into one tree with a leading block axis,
shards it over the `pp` mesh axis and runs the schedule on every device at
once under `shard_map`. Here each rank of a process group (the `pp` group,
its ranks in rank order; the world by default) is one stage and holds only
its own blocks: `stack_block_params` stacks a state dict's blocks,
`stage_params` cuts the rank's [L/S, ...] rows from the stack (JAX's
reshape to [S, L/S, ...] sharded over `pp`), and `pipeline_apply` streams
the microbatches through the stages with `ppermute` hops.

Schedule: plain GPipe fill-drain, as in JAX. T = M + S - 1 ticks for M
microbatches over S stages; at tick t, stage s processes microbatch t - s
when it is in [0, M). The bubble fraction is (S - 1) / T.

The exchanges pair up in the forward and in the backward on every rank
(`parallel/mesh.py::ppermute`). Every rank exchanges at every tick but the
first, the wrap-around from stage S - 1 to stage 0 included (the first
tick's exchange would carry zeros on every rank: it is dropped on every
rank alike). Stage 0 picks its microbatch over what it received, and every
stage files its output, through `torch.where`, as JAX's `jnp.where`, so each
received tensor reaches the loss on every rank, with a zero gradient where
it is unused, and each exchange's backward runs on every rank. Under grad
mode a tensor sent that needs no gradient (a frozen stage's, a bubble's) is
sent as a leaf that does, so that every rank's exchange has a backward.
On a bubble tick a stage skips its blocks and passes its input on (JAX
computes them and throws the result away): the exchanges stay as they are,
and what is passed on reaches only other bubble ticks. The last stage's
outputs are summed over the group (`all_sum`, JAX's `psum`), so every rank
returns the whole output, and the gradient of a loss that every rank
computes from it reaches the last stage once.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from clipself_tpu_torch.parallel.mesh import all_sum, ppermute

Params = dict[str, torch.Tensor]


def _depth(params: Params) -> int:
    """The leading (block) axis shared by every tensor of ``params``."""
    depths = {t.shape[0] for t in params.values()}
    if len(depths) != 1:
        raise ValueError(f"the tensors' leading axes differ: {sorted(depths)}")
    return depths.pop()


def stack_block_params(params: Params, prefix: str = "blocks.") -> tuple[Params, int]:
    """Stack the per-block tensors ``{prefix}{i}.{name}`` of a state dict
    (blocks of one structure) into ``{name: [L, ...]}``, the blocks in the
    numeric order of i, as the JAX sort; returns the stack and L. The other
    keys of ``params`` are left out."""
    blocks: dict[int, Params] = {}
    for key, t in params.items():
        if not key.startswith(prefix):
            continue
        index, _, name = key[len(prefix):].partition(".")
        if not index.isdigit() or not name:
            raise ValueError(f"{key!r} is not '{prefix}<index>.<name>'")
        blocks.setdefault(int(index), {})[name] = t
    if not blocks:
        raise ValueError(f"no '{prefix}*' tensors in params")
    order = sorted(blocks)
    names = blocks[order[0]].keys()
    for i in order:
        if blocks[i].keys() != names:
            raise ValueError(f"block {prefix}{i} does not have the tensors of block {prefix}{order[0]}")
    return {name: torch.stack([blocks[i][name] for i in order]) for name in names}, len(order)


def unstack_block_params(stacked: Params, prefix: str = "blocks.") -> Params:
    """Inverse of `stack_block_params`: ``{prefix}{i}.{name}`` for i = 0 .. L-1."""
    return {f"{prefix}{i}.{name}": t[i] for i in range(_depth(stacked)) for name, t in stacked.items()}


def stage_params(stacked: Params, group=None) -> Params:
    """This rank's stage of ``stacked`` ({name: [L, ...]}): blocks
    [s L/S, (s + 1) L/S), s its rank in ``group`` of S ranks (views)."""
    size, s = dist.get_world_size(group), dist.get_rank(group)
    depth = _depth(stacked)
    if depth % size:
        raise ValueError(f"{depth} blocks must divide into {size} stages")
    per = depth // size
    return {name: t[s * per:(s + 1) * per] for name, t in stacked.items()}


def _sent(y: torch.Tensor, grad: bool) -> torch.Tensor:
    return y.detach().requires_grad_() if grad and not y.requires_grad else y


def pipeline_apply(
    stage_params: Params,
    apply_block: Callable[[Params, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    num_microbatches: int,
    group=None,
) -> torch.Tensor:
    """Run ``x`` through every stage's blocks, pipelined over ``group``.

    Args:
      stage_params: this rank's blocks, ``{name: [L/S, ...]}``
        (`stage_params`); stage s of the S ranks of ``group`` owns blocks
        [s L/S, (s + 1) L/S).
      apply_block: (one block's ``{name: tensor}``, x) -> x.
      x: [B, ...] activations, the same on every rank (stage 0 alone reads
        them); B must divide by ``num_microbatches``.
      num_microbatches: GPipe microbatch count M.

    Returns x after all L blocks on every rank, equal (up to float
    association) to applying the blocks in turn. Every rank of the group
    calls it, and for a gradient every rank runs its backward through the
    output. The gradient of ``x`` is stage 0's on its rank and zero on the
    others, as stage 0 alone reads ``x``."""
    size, s = dist.get_world_size(group), dist.get_rank(group)
    b, m = x.shape[0], num_microbatches
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    xs = x.reshape((m, b // m) + x.shape[1:])
    blocks = [{name: t[j] for name, t in stage_params.items()} for j in range(_depth(stage_params))]

    def run_stage(h):
        for blk in blocks:
            h = apply_block(blk, h)
        return h

    grad = torch.is_grad_enabled()
    flag = {c: torch.tensor(c, device=x.device) for c in (False, True)}
    zeros = xs.new_zeros(xs.shape[1:])
    ys, y = [zeros] * m, zeros
    for t in range(m + size - 1):
        recv = zeros if t == 0 else ppermute(_sent(y, grad), group)
        mb = t - s
        idx = min(max(mb, 0), m - 1)
        x_in = torch.where(flag[s == 0], xs[idx], recv)
        valid = 0 <= mb < m
        y = run_stage(x_in) if valid else x_in
        # the last stage files its finished microbatches; the others add zeros
        ys[idx] = torch.where(flag[valid and s == size - 1], y, ys[idx])
    return all_sum(torch.stack(ys), group).reshape(x.shape)
