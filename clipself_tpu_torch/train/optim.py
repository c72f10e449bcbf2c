"""Optimizer and LR schedules (a port of `clipself_tpu/train/optim.py`).

Reference semantics reproduced:
  - AdamW with two parameter groups: no weight decay for 1-D parameters and
    names holding bn/ln_/norm/bias/logit_scale (`src/training/main.py:198-213`);
  - image-tower locking with the last N blocks unlocked
    (`eva_vit_model.py:500-516`), or for the ModifiedResNet the last N of
    its five groups (`modified_resnet.py:255-278`), with the BatchNorm
    statistics optionally frozen; logit_scale is always frozen;
  - warmup + {cosine, const, const-cooldown} per-step schedules
    (`src/training/scheduler.py:13-53`), evaluated at the update count
    before the update (0 for the first), as optax's `scale_by_learning_rate`
    counts.

Freezing is `requires_grad=False` on the frozen parameters: autograd then
computes no gradient for them, the counterpart of the stop-gradient the JAX
step applies at its freeze mask (`clipself_tpu/train/step.py:85-91`).
Parameter names are the port's reference layout (`visual.blocks.{i}....`,
`visual.transformer.resblocks.{i}....`).
Gradient accumulation (``accum_steps`` > 1) is `optax.MultiSteps` around
the optimizer, as `build_optimizer(accum_steps=)` of the JAX package wraps it.

On a mesh (`parallel/mesh.py`) the optimizer is built after `shard_model`,
whose wrappers keep the parameter names, so the lock groups and decay masks
read the same names. Each rank updates its shards: AdamW on FSDP2's
DTensors, the accumulation on their local shards; clipping takes the norm
over every shard of one copy of the state, a leaf that the tensor-parallel
plan leaves whole counted once in its `model` group.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from clipself_tpu_torch.parallel.mesh import Mesh, is_dtensor, local_tensor

# ---------------------------------------------------------------------------
# schedules (per-step closures, matching the reference formulas)


def warmup_cosine(base_lr: float, warmup: int, total_steps: int) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1.0) / max(warmup, 1)
        e = step - warmup
        es = max(total_steps - warmup, 1)
        return 0.5 * (1.0 + math.cos(math.pi * e / es)) * base_lr

    return lr


def warmup_const(base_lr: float, warmup: int, total_steps: int) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1.0) / max(warmup, 1)
        return base_lr

    return lr


def warmup_const_cooldown(
    base_lr: float,
    warmup: int,
    total_steps: int,
    cooldown_steps: int,
    cooldown_power: float = 1.0,
    cooldown_end_lr: float = 0.0,
) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1.0) / max(warmup, 1)
        start = total_steps - cooldown_steps
        if step < start:
            return base_lr
        decay = (1.0 - (step - start) / max(cooldown_steps, 1)) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr

    return lr


def make_schedule(
    name: str, base_lr: float, warmup: int, total_steps: int, **kw
) -> Callable[[int], float]:
    if name == "cosine":
        return warmup_cosine(base_lr, warmup, total_steps)
    if name == "const":
        return warmup_const(base_lr, warmup, total_steps)
    if name == "const-cooldown":
        return warmup_const_cooldown(base_lr, warmup, total_steps, **kw)
    raise ValueError(f"unknown scheduler: {name}")


# ---------------------------------------------------------------------------
# parameter labeling

# a block of the EVA towers (`visual.blocks.{i}`) or of the OpenCLIP ViT
# (`visual.transformer.resblocks.{i}`)
_BLOCK = re.compile(r"visual\.(?:blocks|transformer\.resblocks)\.(\d+)\.")
# a ModifiedResNet stage (`visual.layer{s}.{i}`, lock group s + 1) and its stem
_RESNET_STAGE = re.compile(r"visual\.layer(\d+)\.")
_RESNET_STEM = re.compile(r"visual\.(?:conv[123]|bn[123])\.")


def trainable_labels(
    names: Iterable[str],
    unlocked_groups: int,
    num_layers: int,
    lock_image: bool = True,
    freeze_bn_stats: bool = False,
) -> dict[str, str]:
    """Label each parameter name 'train' or 'freeze'
    (`clipself_tpu/train/optim.py:106-166`). logit_scale and the text tower
    are always frozen; with ``freeze_bn_stats`` so are the BatchNorm
    statistics (`running_mean`, `running_var`: parameters here, as in the
    JAX param tree), whatever the lock. Under ``lock_image`` only the last
    ``unlocked_groups`` groups of the visual tower train: in the EVA towers
    and the OpenCLIP ViT the last blocks, the stem, the CLS and positional
    embeddings, the final norm and the head (`proj`) staying frozen; in the
    ModifiedResNet the groups [stem, layer1, ..., layer4], group g frozen
    while g <= 5 - ``unlocked_groups``, and the attention pool never. A
    timm tower or the transformers trunk adapter (`visual.trunk.*`,
    `visual.head.*`) has no group the JAX rules name, so under the lock all
    of it freezes, and without it all of it trains, as in the JAX package."""
    names = list(names)
    first_trainable = num_layers - unlocked_groups
    freeze_at = 5 - unlocked_groups  # the ResNet's group rule
    is_resnet = "visual.bn1.weight" in names
    labels = {}
    for name in names:
        if name == "logit_scale" or name.startswith("text."):
            labels[name] = "freeze"
        elif freeze_bn_stats and name.endswith((".running_mean", ".running_var")):
            labels[name] = "freeze"
        elif not lock_image:
            labels[name] = "train"
        elif is_resnet:
            m = _RESNET_STAGE.match(name)
            group = int(m.group(1)) + 1 if m else 1 if _RESNET_STEM.match(name) else None
            # the attention pool is in no group: it always trains
            labels[name] = "freeze" if group is not None and group <= freeze_at else "train"
        else:
            m = _BLOCK.match(name)
            labels[name] = "train" if m and int(m.group(1)) >= first_trainable else "freeze"
    return labels


# a Swin block's relative-position table: `rel_pos_table` in the JAX tree
_SWIN_TABLE = re.compile(r"visual\.trunk\.layers\.\d+\.blocks\.\d+\.attn\.relative_position_bias_table$")


def no_decay_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """True where weight decay applies. Reference exclude rule: ndim < 2 or
    the name holds bn/ln_/norm/bias/logit_scale (`main.py:200-204`), read on
    the JAX package's leaf names (`clipself_tpu/train/optim.py::no_decay_mask`):
    they are the torch names but for a Swin block's table, whose JAX name
    `rel_pos_table` holds none of them, so it decays there and here."""
    excluded = ("bn", "ln_", "norm", "bias", "logit_scale")

    def decays(name: str, p: torch.Tensor) -> bool:
        if p.ndim < 2:
            return False
        return bool(_SWIN_TABLE.match(name)) or not any(s in name.lower() for s in excluded)

    return {name: decays(name, p) for name, p in named_params}


def set_trainable(
    model: nn.Module,
    unlocked_groups: int,
    num_layers: int,
    lock_image: bool = True,
    freeze_bn_stats: bool = False,
) -> None:
    """Set ``requires_grad`` on every parameter of ``model`` by
    `trainable_labels` (on a mesh, before `parallel/mesh.py::shard_model`:
    FSDP2 reduces the gradients of the trainable parameters)."""
    named = list(model.named_parameters())
    labels = trainable_labels(
        (n for n, _ in named), unlocked_groups, num_layers, lock_image, freeze_bn_stats
    )
    for name, p in named:
        p.requires_grad_(labels[name] == "train")


# ---------------------------------------------------------------------------
# the optimizer


def clip_by_global_norm(params: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place so that their global norm is
    at most ``max_norm`` (optax `clip_by_global_norm`); returns that norm
    before clipping. No host sync."""
    grads = [p.grad for p in params]
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


class Optimizer:
    """AdamW over the trainable parameters of a model in a decay and a
    no-decay group, with optional global-norm clipping of the trainable
    gradients and the learning rate taken from the schedule at each update.

    With ``accum_steps`` = k > 1 it is `optax.MultiSteps(every_k_schedule=k)`:
    each micro-step folds its gradients into their running mean (Welford's
    update, in the parameters' dtype), and every k-th micro-step applies
    AdamW (clipping included) to that mean and clears it; the other
    micro-steps leave the parameters and the AdamW state as they are. The
    schedule counts the applied updates, the inner optimizer's count."""

    def __init__(
        self,
        model: nn.Module,
        schedule: Callable[[int], float],
        *,
        wd: float = 0.1,
        beta1: float = 0.9,
        beta2: float = 0.999,
        eps: float = 1e-8,
        grad_clip_norm: Optional[float] = None,
        unlocked_groups: int = 0,
        num_layers: int = 12,
        lock_image: bool = True,
        accum_steps: int = 1,
        freeze_bn_stats: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        if accum_steps < 1:
            raise ValueError(f"accum_steps {accum_steps}: must be at least 1")
        set_trainable(model, unlocked_groups, num_layers, lock_image, freeze_bn_stats)
        named = list(model.named_parameters())
        decay = no_decay_mask(named)
        trainable = [(n, p) for n, p in named if p.requires_grad]
        groups = [
            {"params": [p for n, p in trainable if decay[n]], "weight_decay": wd},
            {"params": [p for n, p in trainable if not decay[n]], "weight_decay": 0.0},
        ]
        self.params = [p for _, p in trainable]
        self.names = [n for n, _ in trainable]
        # the names in the index order of AdamW's state dict
        order = [(n, p) for n, p in trainable if decay[n]] + [(n, p) for n, p in trainable if not decay[n]]
        self.state_names, self.state_params = [n for n, _ in order], [p for _, p in order]
        self.mesh = mesh
        if mesh is not None:
            whole = [n for n, p in trainable if not is_dtensor(p)]
            if whole:
                raise ValueError(
                    f"trainable parameters outside FSDP2 on a mesh: {whole} (their gradients "
                    "would not be reduced)"
                )
            # a leaf the tensor-parallel plan leaves whole has the same gradient on
            # every rank of a `model` group: its norm counts on the first alone
            self._norm_weights = [
                1.0 if n in mesh.plan or mesh.tp.rank == 0 else 0.0 for n in self.names
            ]
        # gradients stay allocated and are zeroed, never None: a trainable
        # parameter outside the loss's graph (the last block's q/k
        # projections, which the dense value path skips) still gets its
        # weight decay, as optax applies it to a zero gradient; AdamW skips
        # a parameter whose .grad is None
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.accum_steps = accum_steps
        # MultiSteps' acc_grads: the running mean of the micro-steps' gradients
        self.accumulated = [torch.zeros_like(p) for p in self.params] if accum_steps > 1 else None
        self.lr = float(schedule(0))  # the learning rate of the last applied update
        self.opt = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=self.lr, betas=(beta1, beta2), eps=eps
        )

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the trainable gradients (over every shard on a
        mesh). No host sync."""
        if self.mesh is None:
            return global_norm([p.grad for p in self.params])
        norms = torch.stack([torch.linalg.vector_norm(local_tensor(p.grad).float()) for p in self.params])
        weights = torch.tensor(self._norm_weights, device=norms.device)
        sq = (norms * norms * weights).sum()
        dist.all_reduce(sq, group=self.mesh.shard_group)
        return sq.sqrt()

    def _clip(self) -> None:
        if self.mesh is None:
            clip_by_global_norm(self.params, self.grad_clip_norm)
            return
        scale = torch.clamp(self.grad_clip_norm / self.grad_norm(), max=1.0)
        for p in self.params:
            local_tensor(p.grad).mul_(scale)

    def step(self, count: int) -> None:
        """Take micro-step number ``count`` (0-based) on the gradients in
        ``.grad`` and clear them. Without accumulation every micro-step is
        update number ``count``; with it, micro-step ``count`` is folded into
        the running mean, and the last of each k applies update number
        ``count // k``."""
        if self.accumulated is not None:
            grads = [local_tensor(p.grad) for p in self.params]
            accumulated = [local_tensor(a) for a in self.accumulated]
            mini = count % self.accum_steps
            # optax MultiSteps (use_grad_mean): acc + (g - acc) / (mini + 1)
            delta = torch._foreach_sub(grads, accumulated)
            torch._foreach_div_(delta, float(mini + 1))
            torch._foreach_add_(accumulated, delta)
            if mini < self.accum_steps - 1:
                torch._foreach_zero_(grads)
                return
            torch._foreach_copy_(grads, accumulated)
            torch._foreach_zero_(accumulated)
            count //= self.accum_steps
        if self.grad_clip_norm is not None:
            self._clip()
        self.lr = float(self.schedule(count))
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=False)

    def state_dict(self) -> dict:
        """AdamW's state dict, with the accumulated gradients under
        "accumulated" when accumulating."""
        state = self.opt.state_dict()
        if self.accumulated is not None:
            state = {**state, "accumulated": [a.clone() for a in self.accumulated]}
        return state

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        accumulated = state.pop("accumulated", None)
        if (accumulated is None) != (self.accumulated is None):
            raise ValueError(
                "the checkpoint's optimizer state and this run disagree on gradient "
                f"accumulation (this run: accum_steps {self.accum_steps})"
            )
        self.opt.load_state_dict(state)
        if accumulated is not None:
            with torch.no_grad():
                for dst, src in zip(self.accumulated, accumulated):
                    local_tensor(dst).copy_(local_tensor(src))


# the JAX package's name: AdamW with the reference decay mask and image-tower
# locking; sets ``requires_grad`` on every parameter of the model
build_optimizer = Optimizer
