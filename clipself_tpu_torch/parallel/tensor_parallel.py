"""Megatron tensor parallelism for the EVA towers over the mesh's `model`
axis (the port of `clipself_tpu/parallel/mesh.py::_TP_RULES` /
`tp_shardings`).

The JAX package gives XLA a layout per leaf and lets its SPMD partitioner
insert the collectives. Here each rank holds its slice of a sharded leaf as
an ordinary parameter, and the blocks call the collectives themselves, in
autograd functions (Megatron's f / g operators):

  - `q_proj` / `k_proj` / `v_proj` (or the fused `qkv`, split by heads in
    each of q, k and v), `q_bias`, `v_bias`, a rel-pos table's head columns
    and `inner_attn_ln` are column-parallel: a rank computes its heads;
  - `proj` is row-parallel: the partial products are summed over the group
    and its bias is added once, after the sum;
  - `w1` / `w2` (or `fc1`) with their biases and `ffn_ln` are
    column-parallel, `w3` (or `fc2`) row-parallel.

A branch whose heads (attention) or hidden width (MLP) does not divide by
the group's size stays replicated, as `_tp_spec` leaves such a leaf
(`clipself_tpu/parallel/mesh.py:224-229`). A sub-LN LayerNorm over a sharded
width needs the statistics of the whole row (XLA reduces them across the
`model` axis): the row is all-gathered across the group, normalised whole by
the port's LayerNorm kernel with the gathered weight and bias, and the rank
keeps its slice; the backward is the autograd transpose (an all-reduce of
the row's gradient, then the slice). Every collective is the identity on a
group of one, so at `--tp-size 1` the plan launches what the unsharded tower
launches. Only the EVA towers are sharded; the others wait for ROADMAP.md
queue 1, item 9.2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

# where the rules for the other towers are queued
ROADMAP_ITEM = "ROADMAP.md queue 1, item 9.2"


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


def is_eva_tower(cfg) -> bool:
    """Whether the tensor-parallel plan covers the image tower of ``cfg``
    (a CLIP config; CoCa and the HF, timm, ResNet and plain ViT towers are
    not covered)."""
    v = cfg.vision
    return bool(v.eva_model_name) and not (v.hf_trunk_name or v.timm_model_name or cfg.multimodal)


def check_tower(cfg, tp_size: int) -> None:
    if tp_size > 1 and not is_eva_tower(cfg):
        raise ValueError(
            f"--tp-size {tp_size}: tensor parallelism covers the EVA image towers; the rules "
            f"for the tower of {cfg.name} wait in {ROADMAP_ITEM}"
        )


def eva_plan(cfg, size: int, prefix: str = "visual.") -> dict[str, Split]:
    """{parameter name: Split} of an EVA tower's sharded leaves at group size
    ``size`` (empty when ``size`` is 1: nothing is split)."""
    v = cfg.vision
    if size == 1:
        return {}
    plan = {}
    hidden = int(v.width * v.mlp_ratio)
    attn_split = v.num_heads % size == 0
    if attn_split and v.use_shared_rel_pos_bias:
        plan[f"{prefix}rel_pos_bias.relative_position_bias_table"] = Split(1)
    for i in range(v.layers):
        a, m = f"{prefix}blocks.{i}.attn.", f"{prefix}blocks.{i}.mlp."
        if attn_split:
            if v.subln:
                plan.update({f"{a}{p}_proj.weight": Split(0) for p in "qkv"})
                plan.update({f"{a}inner_attn_ln.{p}": Split(0) for p in ("weight", "bias")})
            else:
                plan[f"{a}qkv.weight"] = Split(0, 3)
            if v.qkv_bias:
                plan.update({f"{a}q_bias": Split(0), f"{a}v_bias": Split(0)})
            if v.use_rel_pos_bias:
                plan[f"{a}relative_position_bias_table"] = Split(1)
            plan[f"{a}proj.weight"] = Split(1)
        if hidden % size == 0:
            ups = ("w1", "w2") if v.naiveswiglu else ("fc1",)
            for up in ups:
                plan.update({f"{m}{up}.weight": Split(0), f"{m}{up}.bias": Split(0)})
            if v.subln:
                plan.update({f"{m}ffn_ln.{p}": Split(0) for p in ("weight", "bias")})
            plan[f"{m}{'w3' if v.naiveswiglu else 'fc2'}.weight"] = Split(1)
    return plan


def shard_eva_tower(model: nn.Module, cfg, tp: TensorParallel) -> dict[str, Split]:
    """Apply the tensor-parallel plan to ``model``'s EVA image tower in
    place: each sharded leaf becomes this rank's slice (a new parameter with
    the same ``requires_grad``), and the attention, MLP, row-parallel
    projections and sub-LN norms of the sharded branches get ``tp``. Returns
    the plan. At group size 1 every branch gets ``tp`` and no leaf changes."""
    check_tower(cfg, tp.size)
    v = cfg.vision
    plan = eva_plan(cfg, tp.size)
    for name, split in plan.items():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(
            shard_tensor(p.detach(), split, tp.rank, tp.size), requires_grad=p.requires_grad,
        ))
    hidden = int(v.width * v.mlp_ratio)
    for blk in model.visual.blocks:
        if v.num_heads % tp.size == 0:
            attn = blk.attn
            attn.tp, attn.heads, attn.width = tp, v.num_heads // tp.size, v.width // tp.size
            attn.proj.tp = tp
            if attn.inner_attn_ln is not None:
                attn.inner_attn_ln.tp = tp
        if hidden % tp.size == 0:
            mlp = blk.mlp
            mlp.tp = tp
            (mlp.w3 if v.naiveswiglu else mlp.fc2).tp = tp
            if mlp.ffn_ln is not None:
                mlp.ffn_ln.tp = tp
    return plan
