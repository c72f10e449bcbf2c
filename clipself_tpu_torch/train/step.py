"""The train step (a port of `clipself_tpu/train/step.py` on one device).

The reference's per-step region (`src/training/train.py:80-122`: teacher
encode, student dense encode, RoI-align, loss, AdamW, logit clamp) runs
eagerly: loss and backward, the optimizer's micro-step (an update, or with
gradient accumulation a fold into the running mean until every k-th), then
logit_scale clamped to [0, ln 100] on every micro-step, as the JAX step
clamps. ``state.step`` counts micro-steps. Frozen parameters carry
``requires_grad=False`` (`train/optim.py`), so autograd computes no gradient
for them.

On a mesh (`parallel/mesh.py`) each rank runs the step on its rows of the
global batch with the model laid out by `shard_model`. Its loss is its share
of the global loss, and it backpropagates that share times the number of
batch shards: FSDP2 averages the gradients over those ranks, so the update
follows the gradient of the global loss (the JAX step's gradient of the
loss over the sharded batch). The metrics are summed over the batch shards,
so they are the global ones; the clamp runs on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.parallel.mesh import Mesh, num_batch_shards, reduce_sum
from clipself_tpu_torch.train.optim import Optimizer

MAX_LOGIT_SCALE = math.log(100.0)  # reference clamp (train.py:117-119)


@dataclass
class TrainState:
    model: CLIP
    optimizer: Optimizer
    step: int = 0


def make_train_step(
    loss_fn: Callable, teacher: Optional[CLIP], *, log_grad_norm: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, dict], dict]:
    """Build ``step_fn(state, batch) -> metrics`` for
    ``loss_fn(model, teacher, batch, step) -> (loss, metrics)``, where
    ``step`` is the micro-step's index (``state.step`` before it; the
    RegionCLIP loss draws its class-sampling noise from it, as the JAX step
    folds it into the loss's key). The metrics are device tensors; reading
    one waits for the step. ``log_grad_norm`` adds the global norm of the
    micro-step's trainable gradients before clipping (off by default: the
    reference computes it only to clip). With ``mesh``, ``batch`` holds this
    rank's rows and ``loss_fn`` takes the mesh's batch group."""
    scale = num_batch_shards(mesh)

    def step_fn(state: TrainState, batch: dict) -> dict:
        loss, metrics = loss_fn(state.model, teacher, batch, state.step)
        (loss if scale == 1 else loss * scale).backward()
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        if mesh is not None:
            keys = sorted(metrics)
            total = reduce_sum(torch.stack([metrics[k].float() for k in keys]), mesh.batch_group)
            metrics = dict(zip(keys, total.unbind()))
        if log_grad_norm:
            metrics["grad_norm"] = state.optimizer.grad_norm()
        state.optimizer.step(state.step)
        with torch.no_grad():
            state.model.logit_scale.clamp_(0.0, MAX_LOGIT_SCALE)
        state.step += 1
        return metrics

    return step_fn
