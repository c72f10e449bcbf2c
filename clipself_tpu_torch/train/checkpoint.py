"""Checkpoints with the reference's save semantics (a port of
`clipself_tpu/train/checkpoint.py`, with `torch.save` in place of Orbax).

  - the saved model weights are the alpha-ensemble of the student and the
    ORIGINAL teacher weights when alpha < 1 (`src/training/main.py:280-298`);
  - the student weights, optimizer state and step are saved for resume;
  - one directory per epoch, `<ckpt_dir>/<epoch>/checkpoint.pt`, written to
    a temporary file and renamed, so a cut-off save never leaves a file that
    resume would load; ``keep=N`` then removes all but the newest N epochs,
    as Orbax's ``max_to_keep`` does.

`export_torch` writes the ensembled weights as a reference-layout
checkpoint: the port's state dict already has the reference keys.

On a mesh (`parallel/mesh.py`) every rank gathers the whole model and
optimizer state from the shards, rank 0 alone writes it in the
single-process format, and a resume gives each rank its shards again: a
checkpoint of any mesh resumes under any other mesh or in one process.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from clipself_tpu_torch.parallel.mesh import (
    Mesh,
    full_optimizer_state,
    full_state_dict,
    load_full_state_dict,
    local_optimizer_state,
)
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
    keep: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> dict[str, torch.Tensor]:
    """Save {ensembled params, student params, optimizer state, step} at
    ``epoch``, then, with ``keep``, remove the epochs older than the newest
    ``keep`` (None or 0 keeps every one, as ``max_to_keep`` does); returns
    the ensembled params (what eval and export consume). With ``mesh`` every
    rank calls it and gets the params; rank 0 writes."""
    student = _cpu_state(state.model) if mesh is None else full_state_dict(state.model, mesh)
    if alpha < 1.0 and teacher_params is not None:
        teacher = {k: v.to("cpu") for k, v in teacher_params.items()}
        target = student_teacher_ensemble(student, teacher, alpha)
    else:
        target = student
    opt_state = (
        state.optimizer.state_dict() if mesh is None else full_optimizer_state(state.optimizer, mesh)
    )
    payload = {"params": target, "student_params": student, "opt_state": opt_state, "step": state.step}
    if mesh is None or dist.get_rank() == 0:
        _atomic_save(payload, os.path.join(ckpt_dir, str(epoch), _FILE))
        if keep:
            for old in saved_epochs(ckpt_dir)[:-keep]:
                shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    if mesh is not None:
        dist.barrier()  # the file is whole before any rank reads it
    return target


def saved_epochs(ckpt_dir: str) -> list[int]:
    """The saved epochs under a checkpoint dir, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(name)
        for name in os.listdir(ckpt_dir)
        if name.isdigit() and os.path.isfile(os.path.join(ckpt_dir, name, _FILE))
    )


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """Newest saved epoch under a checkpoint dir (None when there is none)."""
    return (saved_epochs(ckpt_dir) or [None])[-1]


def _load(ckpt_dir: str, epoch: Optional[int], device) -> tuple[dict, int]:
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(epoch), _FILE)
    return torch.load(path, map_location=device, weights_only=True), epoch


def restore_checkpoint(
    ckpt_dir: str, state: TrainState, epoch: Optional[int] = None, mesh: Optional[Mesh] = None,
) -> tuple[TrainState, int]:
    """Load the student params, optimizer state and step of ``epoch`` (the
    newest by default) into ``state``; returns (state, epoch), or (state, 0)
    when the directory holds no checkpoint. With ``mesh`` each rank reads
    the file and keeps its shards."""
    if latest_epoch(ckpt_dir) is None and epoch is None:
        return state, 0
    if mesh is None:
        payload, epoch = _load(ckpt_dir, epoch, next(state.model.parameters()).device)
        state.model.load_state_dict(payload["student_params"], strict=True)
        state.optimizer.load_state_dict(payload["opt_state"])
    else:
        payload, epoch = _load(ckpt_dir, epoch, "cpu")
        load_full_state_dict(state.model, payload["student_params"], mesh)
        state.optimizer.load_state_dict(local_optimizer_state(state.optimizer, payload["opt_state"], mesh))
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
