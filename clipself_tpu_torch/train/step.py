"""The distillation train step (a port of `clipself_tpu/train/step.py` on
one device).

The reference's per-step region (`src/training/train.py:80-122`: teacher
encode, student dense encode, RoI-align, loss, AdamW, logit clamp) runs
eagerly: loss and backward, the optimizer step, then logit_scale clamped to
[0, ln 100]. Frozen parameters carry ``requires_grad=False``
(`train/optim.py`), so autograd computes no gradient for them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.train.optim import Optimizer, global_norm

MAX_LOGIT_SCALE = math.log(100.0)  # reference clamp (train.py:117-119)


@dataclass
class TrainState:
    model: CLIP
    optimizer: Optimizer
    step: int = 0


def make_train_step(
    loss_fn: Callable, teacher: CLIP, *, log_grad_norm: bool = False
) -> Callable[[TrainState, dict], dict]:
    """Build ``step_fn(state, batch) -> metrics`` for
    ``loss_fn(model, teacher, batch) -> (loss, metrics)``. The metrics are
    device tensors; reading one waits for the step. ``log_grad_norm`` adds
    the global norm of the trainable gradients before clipping (off by
    default: the reference computes it only to clip)."""

    def step_fn(state: TrainState, batch: dict) -> dict:
        loss, metrics = loss_fn(state.model, teacher, batch)
        loss.backward()
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        if log_grad_norm:
            metrics["grad_norm"] = global_norm([p.grad for p in state.optimizer.params])
        state.optimizer.step(state.step)
        with torch.no_grad():
            state.model.logit_scale.clamp_(0.0, MAX_LOGIT_SCALE)
        state.step += 1
        return metrics

    return step_fn
