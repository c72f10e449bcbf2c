"""Process groups and the dp / fsdp / tp mesh (a port of
`clipself_tpu/parallel/mesh.py`).

JAX drives every device of a host from one process and lays its mesh over
them. PyTorch runs one process a GPU (`torchrun`), so here the mesh is a
grid of ranks of shape (data, fsdp, model), laid out in rank order as the
JAX mesh lays out its devices:

  - the batch is split over the data-like axes (data x fsdp): rank (d, f, t)
    holds rows [i b / n, (i + 1) b / n) of the global batch, i = d fsdp + f,
    n = data fsdp; the ranks of one `model` group hold the same rows;
  - FSDP2's `fully_shard` over the (data, fsdp) sub-mesh replicates the
    parameters over `data` and shards them over `fsdp` (HSDP): each EVA or
    OpenCLIP ViT block is one unit, the text tower one, the root the rest;
    its gradient reduction averages over the data-like ranks, which is
    DDP's all-reduce where `fsdp` is 1. `DistributedDataParallel` is not used: its wrapper
    needs the forward through itself (the losses call the tower's encode
    methods) and renames the parameters (`module.`), which the lock groups
    and decay masks read;
  - Megatron tensor parallelism over `model` (`tensor_parallel.py`).

`full_state_dict` / `load_full_state_dict` move between this layout and the
single-process one (the checkpoint's format), whatever the mesh.

`ppermute` (the ring exchange of JAX's ``ppermute``, differentiable) and
`all_sum` (JAX's ``psum`` of a replicated value) carry the pipeline over a
`pp` group (`pipeline.py`) and ring attention over an `sp` group
(`ops/ring_attention.py`); those groups are the caller's `dist.new_group`s.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from clipself_tpu_torch.parallel.tensor_parallel import (
    Split,
    TensorParallel,
    shard_tensor,
    shard_tensor_parallel,
    unshard_tensor,
)

AXES = ("data", "fsdp", "model")

# (world size, rank, local rank) variables of each launcher: torchrun, SLURM
# and OpenMPI (reference `src/training/distributed.py:24-60`)
_LAUNCHERS = (
    ("WORLD_SIZE", "RANK", "LOCAL_RANK"),
    ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
)

# the encode methods that the losses and the evaluator call on the root: each
# gathers the root's parameters as its forward would
_ROOT_METHODS = (
    "encode_image", "encode_dense", "encode_pseudo_boxes", "encode_masks",
    "encode_rois_and_masks",
)
# the text tower's methods that CoCa's forward calls in place of its forward
_TEXT_METHODS = ("forward_coca", "forward_tokens")


@dataclass(frozen=True)
class Launch:
    """This process's place in the launched group and the device it runs on."""

    world: int
    rank: int
    local_rank: int
    device: torch.device


def launcher_env(env=None) -> Optional[tuple[int, int, int]]:
    """(world size, rank, local rank) from torchrun's variables, or SLURM's
    or OpenMPI's where they count more than one task; None without a
    launcher."""
    env = os.environ if env is None else env
    for world, rank, local in _LAUNCHERS:
        n = env.get(world)
        if n and (world == "WORLD_SIZE" or int(n) > 1):
            return int(n), int(env.get(rank, 0)), int(env.get(local, 0))
    return None


def init_distributed(device: torch.device) -> Optional[Launch]:
    """Join the launched process group (nccl for CUDA, gloo for the CPU),
    on ``cuda:LOCAL_RANK`` for a CUDA ``device``; None, and nothing done,
    without a launcher. A group that is already up (a test that started it)
    must agree with the launcher's world and rank. A failed initialisation
    raises: a rank that went on alone would train apart from its peers."""
    env = launcher_env()
    if env is None:
        return None
    world, rank, local = env
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, rank):
            raise RuntimeError(
                f"the process group (world {dist.get_world_size()}, rank {dist.get_rank()}) "
                f"disagrees with the launcher (world {world}, rank {rank})"
            )
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if not os.environ.get(k)]
        if missing:
            raise RuntimeError(f"a launch of {world} processes needs {' and '.join(missing)} set")
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    return Launch(world, rank, local, device)


def mesh_shape(n_devices: int, fsdp_size: int = 1, tp_size: int = 1) -> tuple[int, int, int]:
    """(data, fsdp, model) over ``n_devices`` ranks, with the JAX trainer's
    error (`clipself_tpu/train/main.py:354-357`)."""
    if n_devices % (fsdp_size * tp_size):
        raise ValueError(
            f"--fsdp-size {fsdp_size} x --tp-size {tp_size} must divide device count {n_devices}"
        )
    return n_devices // (fsdp_size * tp_size), fsdp_size, tp_size


def check_batch(batch_size: int, n_batch_shards: int) -> None:
    """The JAX trainer's batch check (`clipself_tpu/train/main.py:368-370`)."""
    if batch_size % n_batch_shards:
        raise ValueError(
            f"global batch {batch_size} must divide over {n_batch_shards} batch shards"
        )


@dataclass(eq=False)
class Mesh:
    """This rank's view of the (data, fsdp, model) grid of ranks: its
    coordinates, the `DeviceMesh` that FSDP2 shards over, and three groups:
    ``batch_group`` (the data x fsdp ranks of its `model` index: the ranks
    whose rows make up the global batch), ``tp`` (its `model` group) and
    ``shard_group`` (the fsdp x model ranks of its `data` index: one whole
    copy of the sharded state). ``plan`` is the tensor-parallel plan of the
    model sharded on it (`shard_model`)."""

    shape: tuple[int, int, int]
    coords: tuple[int, int, int]
    device: torch.device
    device_mesh: object
    batch_group: dist.ProcessGroup
    shard_group: dist.ProcessGroup
    tp: TensorParallel
    plan: dict[str, Split] = field(default_factory=dict)

    @property
    def n_batch_shards(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def batch_index(self) -> int:
        return self.coords[0] * self.shape[1] + self.coords[1]


def create_mesh(shape: tuple[int, int, int], device: torch.device) -> Mesh:
    """The mesh of ``shape`` (data, fsdp, model) over the whole process group
    (every rank calls it, in the same order)."""
    from torch.distributed.device_mesh import init_device_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} ranks, the group has {world}")
    d, f, t = shape
    ranks = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(ranks == rank)[0])

    def my_group(lists):
        mine = None
        for members in lists:  # every rank creates every group
            g = dist.new_group([int(r) for r in members])
            if rank in members:
                mine = g
        return mine

    batch_group = my_group(ranks.transpose(2, 0, 1).reshape(t, d * f))
    model_group = my_group(ranks.reshape(d * f, t))
    shard_group = my_group(ranks.reshape(d, f * t))
    device_mesh = init_device_mesh(device.type, shape, mesh_dim_names=AXES)
    return Mesh(
        shape=tuple(shape), coords=coords, device=device, device_mesh=device_mesh,
        batch_group=batch_group, shard_group=shard_group,
        tp=TensorParallel(model_group, coords[2], t),
    )


def num_batch_shards(mesh: Optional[Mesh]) -> int:
    """How many ways the batch is split (1 without a mesh)."""
    return 1 if mesh is None else mesh.n_batch_shards


def batch_rows(mesh: Optional[Mesh], batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size``: its data-like
    shard, or all of them where the batch does not divide (an uneven eval
    tail, as `put_batch_array` replicates it, `clipself_tpu/parallel/mesh.py:132-141`)."""
    n = num_batch_shards(mesh)
    if n == 1 or batch_size % n:
        return slice(None)
    per = batch_size // n
    return slice(mesh.batch_index * per, (mesh.batch_index + 1) * per)


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This rank's rows of every array of a global batch."""
    rows = batch_rows(mesh, len(next(iter(batch.values()))))
    return batch if rows == slice(None) else {k: v[rows] for k, v in batch.items()}


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor, no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (no gradient); ``x`` itself without one."""
    return x if group is None else reduce_sum(x, group)


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` goes to rank (i + shift) mod S of ``group`` and rank i
    receives rank (i - shift)'s, S the group's size (no gradient). Every rank
    of the group calls it with tensors of one shape and dtype; the send and
    the receive are one batch, so no rank waits on the other's order. A
    gloo group carries host memory only: a CUDA ``x`` is staged through the
    host there (a copy each way) and the received tensor comes back to
    ``x``'s device. NCCL takes CUDA tensors as they are."""
    ranks = dist.get_process_group_ranks(dist.group.WORLD if group is None else group)
    size, rank = len(ranks), dist.get_rank(group)
    if size == 1:
        return x
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.detach().contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, ranks[(rank + shift) % size], group),
        dist.P2POp(dist.irecv, recv, ranks[(rank - shift) % size], group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return ring_shift(grad, ctx.group, -1), None


def ppermute(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``ppermute`` with perm ``[(i, (i + 1) % S)]`` over ``group``,
    differentiable: the forward sends to rank i + 1 and receives from rank
    i - 1 (`ring_shift`), the backward sends the gradient the other way.
    Autograd runs a backward only for a tensor that reaches the loss, so the
    exchange pairs up in the backward only where every rank's received
    tensor reaches its loss and every rank's ``x`` requires grad alike:
    the callers (`parallel/pipeline.py`, `ops/ring_attention.py`) see to
    that. Staged through the host over gloo, as `ring_shift` is."""
    return _Ppermute.apply(x, group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable as JAX's ``psum`` of a
    value every rank then uses alike: the backward passes each rank's
    gradient through as it is. Every rank computes the same loss from the
    same sum, so the loss's gradient reaches each rank's ``x`` once; a
    backward that summed again would count it S times."""
    return _AllSum.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the first axis, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def shard_model(model: nn.Module, mesh: Mesh) -> None:
    """Lay ``model`` out on ``mesh`` in place: the tensor-parallel plan over
    `model` (`tensor_parallel.py`: the EVA and OpenCLIP ViT blocks, the CLIP
    text tower's and CoCa's decoder self-attention blocks; every other
    tower replicated), then FSDP2 over the (data, fsdp) sub-mesh, one unit
    an EVA or OpenCLIP ViT block, one the text tower, the root the rest,
    with the encode methods (and the text tower's CoCa methods) registered
    as forwards. Scalar parameters
    (`logit_scale`, always frozen) are left to every rank whole:
    `fully_shard` takes none. Set ``requires_grad`` before: FSDP2 reduces
    the gradients of the trainable parameters only."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    from clipself_tpu_torch.models.eva_vit import EvaViT
    from clipself_tpu_torch.models.open_clip_vit import OpenCLIPViT

    mesh.plan = shard_tensor_parallel(model, mesh.tp)
    sub = mesh.device_mesh["data", "fsdp"]
    scalars = {p for p in model.parameters() if p.dim() == 0} or None
    if isinstance(getattr(model, "visual", None), (EvaViT, OpenCLIPViT)):
        for blk in model.visual.blocks:
            fully_shard(blk, mesh=sub, ignored_params=scalars)
            register_fsdp_forward_method(blk, "forward_without_attn")
    if isinstance(getattr(model, "text", None), nn.Module):
        fully_shard(model.text, mesh=sub, ignored_params=scalars)
        for name in _TEXT_METHODS:
            if hasattr(model.text, name):
                register_fsdp_forward_method(model.text, name)
    # the root too gives its gathered parameters back after each forward: a
    # frozen teacher or an evaluator's model runs no backward that would
    fully_shard(model, mesh=sub, reshard_after_forward=True, ignored_params=scalars)
    for name in _ROOT_METHODS:
        if hasattr(model, name):
            register_fsdp_forward_method(model, name)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The rank's own values of ``t``: a DTensor's local shard (a view), a
    plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def full_leaf(name: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole single-process leaf ``name`` from this rank's ``t`` (every
    rank of the group calls it, in the same order)."""
    if is_dtensor(t):
        t = t.full_tensor()
    split = mesh.plan.get(name)
    if split is not None:
        parts = [torch.empty_like(t) for _ in range(mesh.tp.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=mesh.tp.group)
        t = unshard_tensor(parts, split)
    return t.detach()


def local_leaf(name: str, full: torch.Tensor, like: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share of the single-process leaf ``full``, laid out as
    ``like`` (its tensor-parallel slice, then a DTensor of ``like``'s
    placements). No communication: every rank holds ``full``."""
    from torch.distributed.tensor import distribute_tensor

    split = mesh.plan.get(name)
    t = full if split is None else shard_tensor(full, split, mesh.tp.rank, mesh.tp.size)
    t = t.to(device=like.device, dtype=like.dtype)
    if is_dtensor(like):
        return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)
    return t


def full_state_dict(model: nn.Module, mesh: Mesh) -> dict[str, torch.Tensor]:
    """``model``'s single-process state dict, on the CPU, on every rank."""
    return {
        name: full_leaf(name, t, mesh).to("cpu", copy=True)
        for name, t in model.state_dict(keep_vars=True).items()
    }


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: dict[str, torch.Tensor], mesh: Mesh) -> None:
    """Load a single-process state dict into ``model`` laid out on ``mesh``
    (every key, strictly)."""
    own = model.state_dict(keep_vars=True)
    if own.keys() != state.keys():
        missing, extra = own.keys() - state.keys(), state.keys() - own.keys()
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, unexpected {sorted(extra)}")
    for name, t in own.items():
        local_tensor(t).copy_(local_tensor(local_leaf(name, state[name], t, mesh)))


def full_optimizer_state(optimizer, mesh: Mesh) -> dict:
    """The single-process state dict of a `train/optim.py::Optimizer` built
    on ``mesh``: every parameter-shaped tensor whole, on the CPU."""
    state = optimizer.state_dict()
    names = optimizer.state_names

    def whole(name, v):
        return full_leaf(name, v, mesh).to("cpu", copy=True) if torch.is_tensor(v) and v.dim() else v

    state["state"] = {
        i: {k: whole(names[i], v) for k, v in s.items()} for i, s in state["state"].items()
    }
    if "accumulated" in state:
        state["accumulated"] = [whole(n, a) for n, a in zip(optimizer.names, state["accumulated"])]
    return state


def local_optimizer_state(optimizer, state: dict, mesh: Mesh) -> dict:
    """A single-process optimizer state dict laid out as ``optimizer``'s
    parameters on ``mesh`` (the inverse of `full_optimizer_state`)."""
    state = dict(state)
    names, params = optimizer.state_names, optimizer.state_params

    def share(i, v):
        return local_leaf(names[i], v, params[i], mesh) if torch.is_tensor(v) and v.dim() else v

    state["state"] = {
        int(i): {k: share(int(i), v) for k, v in s.items()} for i, s in state["state"].items()
    }
    if "accumulated" in state:
        state["accumulated"] = [
            local_leaf(n, a, like, mesh)
            for n, a, like in zip(optimizer.names, state["accumulated"], optimizer.accumulated)
        ]
    return state
