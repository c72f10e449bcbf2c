"""Student-teacher weight ensembling on save (a port of
`clipself_tpu/train/ensemble.py`; reference `train.py:53-59`)."""

from __future__ import annotations

import torch


def student_teacher_ensemble(
    student: dict[str, torch.Tensor], teacher: dict[str, torch.Tensor], alpha: float
) -> dict[str, torch.Tensor]:
    """alpha * s + (1 - alpha) * t per tensor of two state dicts."""
    return {k: alpha * s + (1.0 - alpha) * teacher[k] for k, s in student.items()}
