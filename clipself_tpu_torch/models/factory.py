"""Model creation: config registry -> initialized port `CLIP`, or `CoCa`
for a config with a multimodal decoder, on a device (optionally over a
pretrained checkpoint or catalog tag), with its preprocessing pair, and the
model's tokenizer."""

from __future__ import annotations

import functools
import logging
from typing import Any, Optional, Union

import torch

from clipself_tpu_torch.core.config import CLIPConfig, get_model_config
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.coca import CoCa


def model_class(cfg: CLIPConfig) -> type:
    """`CoCa` for a config with a multimodal decoder, else `CLIP`
    (`clipself_tpu/models/factory.py:77-81`, reference `factory.py:215-230`)."""
    return CoCa if cfg.multimodal is not None else CLIP


def create_model(
    name_or_cfg: Union[str, CLIPConfig],
    *,
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    grad_checkpointing: bool = False,
    pretrained: Optional[str] = None,
    hf_pretrained: bool = False,
) -> Union[CLIP, CoCa]:
    """Build a CLIP (a CoCa for a multimodal config) with seeded random
    weights, in eval mode on ``device``.

    Parameters are float32; ``dtype`` is the compute dtype. The weights are
    drawn on the CPU from ``torch.Generator().manual_seed(seed)`` with the
    JAX package's init distributions, the visual tower's first, then the
    text tower's, then a CoCa's decoder (they are not the JAX package's
    values: the two generators differ); load real weights with
    `models.torch_io.load_weights`. ``grad_checkpointing`` recomputes each
    block of the visual tower in the backward pass (the JAX package's
    ``remat``). ``pretrained``, a checkpoint path or a catalog tag of the
    model (`models/pretrained.py::resolve_pretrained`), is imported over
    the initial weights non-strictly (`models/torch_io.py::load_pretrained`),
    as `clipself_tpu/models/factory.py:100-108` routes it. A timm tower
    whose config sets `timm_model_pretrained` (`--pretrained-image`) without
    ``pretrained`` logs a warning: nothing is fetched
    (`clipself_tpu/models/factory.py:112-120`). An HF text tower logs the
    JAX package's warning that it is randomly initialized; its hub weights
    (``hf_pretrained``, `clipself_tpu/models/factory.py:121-133`) are not in
    the repository and are never fetched: ``hf_pretrained=True`` raises
    (load a transformers torch trunk with
    `models/hf_text.py::load_hf_trunk_params`).
    """
    cfg = get_model_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    if hf_pretrained and cfg.text.hf_model_name:
        raise OSError(
            f"hf_pretrained: the hub weights of the HF text tower {cfg.text.hf_model_name!r} are not in "
            "the repository and nothing is fetched; load a transformers torch trunk state dict with "
            "models/hf_text.py::load_hf_trunk_params"
        )
    model = model_class(cfg)(cfg, dtype=dtype, grad_checkpointing=grad_checkpointing)
    model.init_weights(torch.Generator().manual_seed(seed))
    if pretrained:
        from clipself_tpu_torch.models.pretrained import resolve_pretrained
        from clipself_tpu_torch.models.torch_io import load_pretrained

        # an existing path (a file, or a directory that `load_pretrained` refuses) as it is
        load_pretrained(model, resolve_pretrained(cfg.name, pretrained))
    if cfg.vision.timm_model_name and cfg.vision.timm_model_pretrained and not pretrained:
        # the reference's --pretrained-image pulls the trunk's timm hub
        # weights; only an explicit checkpoint can be honoured here
        logging.getLogger("clipself_tpu_torch").warning(
            "timm_model_pretrained is set but no weights source is reachable "
            "offline; pass --pretrained <checkpoint> to load trunk weights"
        )
    if cfg.text.hf_model_name:
        logging.getLogger("clipself_tpu_torch").warning(
            "HF text tower %r is randomly initialized; its hub weights are not in the repository "
            "(load a transformers torch trunk with models/hf_text.py::load_hf_trunk_params)",
            cfg.text.hf_model_name,
        )
    return model.to(device).eval()


def create_model_and_transforms(
    name_or_cfg: Union[str, CLIPConfig],
    *,
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.bfloat16,
    pretrained: Optional[str] = None,
    det_image_size: int = 1024,
    dataset_type: str = "grid_distill",
    **kwargs,
):
    """The model and its (det, crop) preprocessing pair
    (`clipself_tpu/models/factory.py::create_model_and_transforms`,
    reference `src/open_clip/factory.py:267-350`): each transform takes an
    RGB uint8 [H, W, 3] image to a normalized float32 [S, S, 3] array
    (`data/transforms.py`: ResizeLongest + pad to ``det_image_size``, and
    ResizeLongest-max + centre pad to the tower's size). For the distill and
    RegionCLIP dataset types both the train and the val preprocess are the
    pair; otherwise the train preprocess is the crop transform alone.
    Returns (model, preprocess_train, preprocess_val)."""
    from clipself_tpu_torch.data.transforms import crop_transform, det_transform

    model = create_model(name_or_cfg, device=device, dtype=dtype, pretrained=pretrained, **kwargs)
    pre_crop = functools.partial(crop_transform, crop_size=model.cfg.vision.image_size)
    pair = [functools.partial(det_transform, det_size=det_image_size), pre_crop]
    if dataset_type in ("grid_distill", "proposals_distill", "region_clip",
                        "clipself", "clipself_proposals"):
        return model, pair, pair
    return model, pre_crop, pair


def get_tokenizer(name_or_cfg: Any = None):
    """The tokenizer callable of a model (`clipself_tpu/models/factory.py::get_tokenizer`):
    the CLIP BPE `tokenize` at the model's context length. A CoCa config
    declares one token less than it consumes, so it gets one more. A model
    with an HF text tower gets `tokenizer.py::HFTokenizer`, which raises:
    the hub's vocabulary is not in the repository."""
    from clipself_tpu_torch import tokenizer as _tok

    if name_or_cfg is None:
        return _tok.tokenize
    cfg = get_model_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
    hf_name = cfg.text.hf_tokenizer_name or cfg.text.hf_model_name
    if hf_name:
        return _tok.HFTokenizer(hf_name)
    ctx = cfg.text.context_length + (1 if cfg.multimodal is not None else 0)
    return functools.partial(_tok.tokenize, context_length=ctx)
