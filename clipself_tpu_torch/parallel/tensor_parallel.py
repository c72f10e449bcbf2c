"""Megatron tensor parallelism over the mesh's `model` axis (the port of
`clipself_tpu/parallel/mesh.py::_TP_RULES`, `_tp_spec` and `tp_shardings`).

The JAX package gives XLA a layout per leaf and lets its SPMD partitioner
insert the collectives. Here each rank holds its slice of a sharded leaf as
an ordinary parameter, and the blocks call the collectives themselves, in
autograd functions (Megatron's f / g operators).

One rule table (`RULES`) over the port's parameter names mirrors
`_TP_RULES`. As `_tp_spec` does, it touches only the branches of a block:
the `attn` and `mlp` modules under `blocks.{i}` or `resblocks.{i}` whose
class takes a group (a `tp` attribute: the EVA blocks, the OpenCLIP ViT's
`CLIPBlock` and the CLIP text tower's `TextBlock`, which CoCa's text tower
and decoder reuse). That covers the EVA and OpenCLIP image towers, the text
tower of every model and CoCa's decoder self-attention blocks, as the JAX
rules do over the whole tree. Every other tower stays whole on every rank,
as JAX replicates it: CoCa's `cross_attn.{i}`, the attentional pooler, the
ModifiedResNet, ConvNeXt, Swin and the timm ViT (their blocks' classes take
no group), the HF trunks and HF text towers.

  - `q_proj` / `k_proj` / `v_proj`, `q_bias`, `v_bias` and `inner_attn_ln`
    are column-parallel: a rank computes its heads. The packed projections,
    the EVA `qkv` and the OpenCLIP `in_proj_weight` / `in_proj_bias` [3W, W],
    are split by heads within each of q, k and v (`Split(0, 3)`). JAX
    instead shards `in_proj`'s packed output dimension and lets XLA reshard
    across the q / k / v boundaries: the result is the same, only the layout
    differs;
  - `proj` / `out_proj` are row-parallel: the partial products are summed
    over the group and the bias is added once, after the sum;
  - `w1` / `w2` / `fc1` / `c_fc` with their biases and `ffn_ln` are
    column-parallel, `w3` / `fc2` / `c_proj` row-parallel.

A branch whose heads (attention) or hidden width (MLP) does not divide by
the group's size stays replicated, as `_tp_spec` leaves a leaf whose
sharded dimension does not divide (`clipself_tpu/parallel/mesh.py:224-229`).
Two layouts differ from JAX's on purpose:

  - JAX shards `in_proj` whenever 3W divides by the group's size, and
    `out_proj` whenever W does; the port shards an attention branch when its
    heads divide, and keeps it whole otherwise;
  - the EVA rel-pos tables (a block's `relative_position_bias_table` and the
    shared `rel_pos_bias.relative_position_bias_table`, [rows, heads]) are
    split by heads with their attention; JAX has no rule for them and
    replicates them.

A sub-LN LayerNorm over a sharded width needs the statistics of the whole
row (XLA reduces them across the `model` axis): the row is all-gathered
across the group, normalised whole by the port's LayerNorm kernel with the
gathered weight and bias, and the rank keeps its slice; the backward is the
autograd transpose (an all-reduce of the row's gradient, then the slice).
Every collective is the identity on a group of one, so at `--tp-size 1`
every branch takes its group and the model launches what the unsharded one
launches. Where nothing of a model matches at a size above 1, the plan is
empty, every leaf is replicated and a warning says so, as `tp_shardings`
logs one.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

log = logging.getLogger("clipself_tpu_torch")


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _gather_last(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    group (the input of a column-parallel region feeds every rank)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp.group), None


class _Reduce(torch.autograd.Function):
    """Sum over the group forward (a row-parallel product's partial sums);
    identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along the last axis; the backward sums the gathered
    gradient over the group and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_last(x, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.local(_all_reduce(g, ctx.tp.group)), None


@dataclass(eq=False)
class TensorParallel:
    """A rank's place in its `model` group: the collectives the sharded
    blocks call, each the identity when the group has one rank."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Enter.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Gather.apply(x, self)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last axis."""
        n = x.shape[-1] // self.size
        return x[..., self.rank * n:(self.rank + 1) * n]


@dataclass(frozen=True)
class Split:
    """How a leaf is sharded: along ``dim``, seen as ``groups`` equal parts
    (3 for the fused qkv rows: q, k, v each split by heads)."""

    dim: int
    groups: int = 1


def shard_tensor(t: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the full leaf ``t``."""
    parts = t.unflatten(split.dim, (split.groups, size, -1))
    return parts.select(split.dim + 1, rank).flatten(split.dim, split.dim + 1).contiguous()


def unshard_tensor(parts: list[torch.Tensor], split: Split) -> torch.Tensor:
    """The full leaf from every rank's slice, in rank order (the inverse of
    `shard_tensor`)."""
    stacked = torch.stack([p.unflatten(split.dim, (split.groups, -1)) for p in parts], split.dim + 1)
    return stacked.flatten(split.dim, split.dim + 2)


# (the name below a block, from its branch on; how that leaf is split when
# its branch is), in the order of `_TP_RULES`
RULES = (
    (r"attn\.(q_proj|k_proj|v_proj)\.weight", Split(0)),
    (r"attn\.(qkv\.weight|in_proj_weight|in_proj_bias)", Split(0, 3)),
    (r"attn\.(q_bias|v_bias)", Split(0)),
    (r"attn\.inner_attn_ln\.(weight|bias)", Split(0)),
    (r"attn\.relative_position_bias_table", Split(1)),  # the port's own layout
    (r"attn\.(proj|out_proj)\.weight", Split(1)),
    (r"mlp\.(w1|w2|fc1|c_fc)\.(weight|bias)", Split(0)),
    (r"mlp\.ffn_ln\.(weight|bias)", Split(0)),
    (r"mlp\.(w3|fc2|c_proj)\.weight", Split(1)),
)
_BRANCH = re.compile(r"(?:^|\.)(?:res)?blocks\.\d+\.(attn|mlp)$")
# a tower's rel-pos table shared by its blocks (split with their heads)
SHARED_TABLE = "rel_pos_bias.relative_position_bias_table"


def leaf_split(name: str) -> Optional[Split]:
    """The Split of a leaf named ``name`` below its block (``attn.qkv.weight``,
    ``mlp.c_fc.bias``, ...), None where no rule matches (the leaf stays
    whole: a row-parallel bias, a LayerScale, a norm outside the branch)."""
    for pattern, split in RULES:
        if re.fullmatch(pattern, name):
            return split
    return None


def branches(model: nn.Module, size: int) -> list[tuple[str, nn.Module, dict[str, Split]]]:
    """(name, module, {parameter name: Split}) of each branch of ``model``
    that splits over a group of ``size``: an `attn` or `mlp` module of a
    block (`blocks.{i}` / `resblocks.{i}`) whose class takes a group, whose
    heads (attention) or hidden width (MLP, the split dimension of its
    leaves) divide by ``size``."""
    out = []
    for name, m in model.named_modules():
        found = _BRANCH.search(name)
        if found is None or not hasattr(type(m), "tp"):
            continue
        kind = found.group(1)
        leaves = {}
        for leaf, p in m.named_parameters():
            split = leaf_split(f"{kind}.{leaf}")
            if split is not None:
                leaves[f"{name}.{leaf}"] = (split, p.shape[split.dim] // split.groups)
        units = [m.heads] if kind == "attn" else [n for _, n in leaves.values()]
        if leaves and all(u % size == 0 for u in units):
            out.append((name, m, {k: s for k, (s, _) in leaves.items()}))
    return out


def _plan(model: nn.Module, split: list) -> dict[str, Split]:
    """The leaves of the branches ``split`` and the shared rel-pos tables of
    the towers whose attention they split."""
    plan = {}
    for _, _, leaves in split:
        plan.update(leaves)
    attn = [name for name, _, _ in split if name.endswith(".attn")]
    for name, _ in model.named_parameters():
        if name.endswith(SHARED_TABLE) and any(a.startswith(name[: -len(SHARED_TABLE)]) for a in attn):
            plan[name] = Split(1)
    return plan


def tp_plan(model: nn.Module, size: int) -> dict[str, Split]:
    """{parameter name: Split} of the leaves of ``model`` that a group of
    ``size`` shards (empty when ``size`` is 1: nothing is split)."""
    return {} if size == 1 else _plan(model, branches(model, size))


def shard_tensor_parallel(model: nn.Module, tp: TensorParallel) -> dict[str, Split]:
    """Apply the tensor-parallel plan to ``model`` in place: each sharded
    leaf becomes this rank's slice (a new parameter with the same
    ``requires_grad``); each branch that splits gets ``tp``, an attention
    branch this rank's heads and width, and its row-parallel projection and
    sub-LN norms get ``tp`` too. Returns the plan. At group size 1 every
    branch gets ``tp`` and no leaf changes; above 1, a model of which no
    leaf matches is left whole, with a warning."""
    split = branches(model, tp.size)
    plan = {} if tp.size == 1 else _plan(model, split)
    if tp.size > 1 and not plan:
        log.warning(
            "tensor parallelism: no parameter matched the tensor-parallel rules: the 'model' "
            "axis replicates everything (check block naming and divisibility by %d)", tp.size,
        )
    for name, s in plan.items():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(
            shard_tensor(p.detach(), s, tp.rank, tp.size), requires_grad=p.requires_grad,
        ))
    for name, branch, leaves in split:
        branch.tp = tp
        if name.endswith(".attn"):
            branch.heads, branch.width = branch.heads // tp.size, branch.width // tp.size
        for child_name, child in branch.named_children():
            s = leaves.get(f"{name}.{child_name}.weight")
            # a row-parallel projection, or a norm over the sharded width
            if s is not None and (s.dim == 1 or child.weight.dim() == 1):
                child.tp = tp
    return plan
