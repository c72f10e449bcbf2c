"""Checkpoints with the reference's save semantics (a port of
`clipself_tpu/train/checkpoint.py`, with `torch.save` in place of Orbax).

  - the saved model weights are the alpha-ensemble of the student and the
    ORIGINAL teacher weights when alpha < 1 (`src/training/main.py:280-298`);
  - the student weights, optimizer state and step are saved for resume;
  - one directory per epoch, `<ckpt_dir>/<epoch>/checkpoint.pt`, written to
    a temporary file and renamed, so a cut-off save never leaves a file that
    resume would load.

`export_torch` writes the ensembled weights as a reference-layout
checkpoint: the port's state dict already has the reference keys.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch

from clipself_tpu_torch.train.ensemble import student_teacher_ensemble
from clipself_tpu_torch.train.step import TrainState

_FILE = "checkpoint.pt"


def _atomic_save(obj, path: str) -> None:
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _cpu_state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def save_checkpoint(
    ckpt_dir: str,
    state: TrainState,
    teacher_params: Optional[dict[str, torch.Tensor]],
    epoch: int,
    alpha: float = 1.0,
) -> dict[str, torch.Tensor]:
    """Save {ensembled params, student params, optimizer state, step} at
    ``epoch``; returns the ensembled params (what eval and export consume)."""
    student = _cpu_state(state.model)
    if alpha < 1.0 and teacher_params is not None:
        teacher = {k: v.to("cpu") for k, v in teacher_params.items()}
        target = student_teacher_ensemble(student, teacher, alpha)
    else:
        target = student
    payload = {
        "params": target,
        "student_params": student,
        "opt_state": state.optimizer.state_dict(),
        "step": state.step,
    }
    _atomic_save(payload, os.path.join(ckpt_dir, str(epoch), _FILE))
    return target


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """Newest saved epoch under a checkpoint dir (None when there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [
        int(name)
        for name in os.listdir(ckpt_dir)
        if name.isdigit() and os.path.isfile(os.path.join(ckpt_dir, name, _FILE))
    ]
    return max(epochs, default=None)


def _load(ckpt_dir: str, epoch: Optional[int], device) -> tuple[dict, int]:
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(epoch), _FILE)
    return torch.load(path, map_location=device, weights_only=True), epoch


def restore_checkpoint(
    ckpt_dir: str, state: TrainState, epoch: Optional[int] = None
) -> tuple[TrainState, int]:
    """Load the student params, optimizer state and step of ``epoch`` (the
    newest by default) into ``state``; returns (state, epoch), or (state, 0)
    when the directory holds no checkpoint."""
    if latest_epoch(ckpt_dir) is None and epoch is None:
        return state, 0
    device = next(state.model.parameters()).device
    payload, epoch = _load(ckpt_dir, epoch, device)
    state.model.load_state_dict(payload["student_params"], strict=True)
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return state, epoch


def load_params(ckpt_dir: str, epoch: Optional[int] = None) -> dict[str, torch.Tensor]:
    """The (ensembled) params of a checkpoint, on the CPU."""
    return _load(ckpt_dir, epoch, "cpu")[0]["params"]


def export_torch(path: str, params: dict[str, torch.Tensor], epoch: int = 0, name: str = "") -> None:
    """Write ``params`` as a reference-layout checkpoint
    ({"state_dict", "epoch", "name"}), loadable by `models.torch_io.load_weights`."""
    sd = {k: v.detach().to("cpu") for k, v in params.items()}
    _atomic_save({"state_dict": sd, "epoch": epoch, "name": name}, path)
