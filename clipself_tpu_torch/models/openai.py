"""OpenAI CLIP checkpoints: `torch.jit` archives and plain state dicts.

A port of `clipself_tpu/models/openai.py` (reference `src/open_clip/openai.py:23-144`
and `build_model_from_openai_state_dict`, `src/open_clip/model.py:417-474`):
a checkpoint is reduced to a float32 NumPy state dict, the architecture is
inferred from its tensor shapes, the text-tower keys are moved under `text.`
(the reference `CustomCLIP` layout), and the weights import into a port
`CLIP` through `models/torch_io.py::import_state_dict`. The inference covers
the ResNet releases too, which build `models/modified_resnet.py`.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from clipself_tpu_torch.core.config import CLIPConfig, TextConfig, VisionConfig


def load_openai_state_dict(path: str) -> dict[str, np.ndarray]:
    """A `torch.jit` archive (or a plain checkpoint, a `state_dict` container
    unwrapped) as float32 NumPy arrays."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def config_from_openai_state_dict(sd: dict[str, np.ndarray]) -> CLIPConfig:
    """Infer the architecture from tensor shapes (reference
    `build_model_from_openai_state_dict`, `src/open_clip/model.py:417-448`)."""
    # ResNets also have visual.conv1: the projection matrix tells a ViT
    # (reference `model.py:421`)
    is_vit = "visual.proj" in sd
    embed_dim = sd["text_projection"].shape[1]
    if is_vit:
        width = sd["visual.conv1.weight"].shape[0]
        patch = sd["visual.conv1.weight"].shape[-1]
        layers = len(
            {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}
        )
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        vision = VisionConfig(
            image_size=grid * patch, layers=layers, width=width,
            head_width=64, patch_size=patch, mlp_ratio=4.0, ln_eps=1e-5,
            quick_gelu=True,  # all OpenAI releases use QuickGELU
        )
    else:
        counts = [
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
            for b in (1, 2, 3, 4)
        ]
        # the stem width (64 for RN50), off the stage-1 bottleneck's first
        # conv (reference `model.py:435`)
        width = sd["visual.layer1.0.conv1.weight"].shape[0]
        spatial = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision = VisionConfig(
            image_size=spatial * 32, layers=len(counts), width=width,
            head_width=64, patch_size=32,
            resnet_layers=tuple(counts), ln_eps=1e-5, quick_gelu=True,
        )
    text = TextConfig(
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        width=sd["ln_final.weight"].shape[0],
        heads=sd["ln_final.weight"].shape[0] // 64,
        layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
        ln_eps=1e-5, quick_gelu=True,
    )
    return CLIPConfig(embed_dim=embed_dim, vision=vision, text=text, name="openai")


def remap_openai_keys(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """OpenAI layout -> reference `CustomCLIP` layout: the text tower under
    `text.`; the visual keys and `logit_scale` already match; the archive's
    integer attributes are dropped."""
    out = {}
    for k, v in sd.items():
        if k in ("input_resolution", "context_length", "vocab_size"):
            continue
        if k.startswith("visual.") or k == "logit_scale":
            out[k] = v
        else:
            out[f"text.{k}"] = v
    return out


def load_openai_model(
    path: str,
    *,
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
):
    """A port `CLIP` built from an OpenAI checkpoint's shapes, its weights
    imported non-strictly (a tensor the file lacks keeps its seeded initial
    value), in eval mode on ``device``."""
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.models.torch_io import import_state_dict

    sd = load_openai_state_dict(path)
    cfg = config_from_openai_state_dict(sd)
    model = create_model(cfg, device=device, dtype=dtype, seed=seed)
    import_state_dict(model, remap_openai_keys(sd), source=path)
    return model
