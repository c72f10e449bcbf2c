"""Weights in the reference PyTorch state-dict layout.

`state_dict_from_jax` turns the JAX package's param tree (nested dicts of
NumPy arrays) into the state dict of the reference `CustomCLIP` or `CoCa`:
the visual tower, the text tower, a CoCa's decoder and `logit_scale`, with
the key maps of the EVA, OpenCLIP ViT (the CoCa pooler's included),
ModifiedResNet, ConvNeXt, Swin and timm-ViT branches of
`clipself_tpu/models/torch_io.py::_vision_key_map` and of `_text_key_map`
and `_decoder_key_map` copied here (the result is pinned equal to that
module's `export_state_dict`; a timm tower's map is chosen from the
config). The HF towers' subtrees (`text/trunk`, `text/proj`,
`visual/trunk`, `visual/head` of the transformers trunk adapter), which
the JAX `export_state_dict` does not map, take the port's own map: the
transformers torch names under `text.transformer.` and `visual.trunk.`,
`kernel` a transposed weight (the patch projection's an OIHW one), `scale`
and `embedding` a `weight`. `load_weights` loads such a dict, or a reference `.pt`
checkpoint, into the whole model with `strict=True`; text-tower keys
stored without the `text.` prefix (the open_clip hub layout) are taken too.
`detector_state_dict_from_jax` does the same for the flax tree of the F-ViT
detector heads, whose port keeps the tree's own names, and
`detector_state_dict_to_jax` is its inverse. `load_pretrained` is the
trainer's `--pretrained`: the JAX package's non-strict import
(`load_pretrained`, `import_state_dict`), a missing key keeping its value
and the pos-embed grid resized (`resize_pos_embed_np`, a pinned copy).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Optional, Union

import numpy as np
import torch
from torch import nn

from clipself_tpu_torch.core.config import CLIPConfig
from clipself_tpu_torch.ops.interpolate import resize_weight_matrix

log = logging.getLogger("clipself_tpu_torch")


def _eva_vision_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `visual` of an EVA tower to
    (torch_key, transform); transform is 'linear' (transpose 2-D),
    'conv' (HWIO -> OIHW) or None (verbatim)."""
    k = list(flax_key)
    if k == ["patch_embed", "kernel"]:
        return "visual.patch_embed.proj.weight", "conv"
    if k == ["patch_embed", "bias"]:
        return "visual.patch_embed.proj.bias", None
    if k == ["cls_token"]:
        return "visual.cls_token", None
    if k == ["pos_embed"]:
        return "visual.pos_embed", None
    if k == ["rel_pos_bias", "relative_position_bias_table"]:
        return "visual.rel_pos_bias.relative_position_bias_table", None
    if k == ["norm", "scale"]:
        return "visual.norm.weight", None
    if k == ["norm", "bias"]:
        return "visual.norm.bias", None
    if k == ["head", "kernel"]:
        return "visual.head.weight", "linear"
    if k == ["head", "bias"]:
        return "visual.head.bias", None
    m = re.match(r"blocks_(\d+)", k[0])
    if m:
        base = f"visual.blocks.{m.group(1)}"
        rest = k[1:]
        ln = {"scale": "weight", "bias": "bias"}
        if rest[0] in ("norm1", "norm2"):
            return f"{base}.{rest[0]}.{ln[rest[1]]}", None
        if rest[0] == "attn":
            sub = rest[1]
            if sub in ("q_proj", "k_proj", "v_proj"):
                if rest[2] == "kernel":
                    return f"{base}.attn.{sub}.weight", "linear"
                # torch stores q/v biases as standalone parameters
                return f"{base}.attn.{sub[0]}_bias", None
            if sub == "qkv":
                return f"{base}.attn.qkv.weight", "linear"
            if sub in ("q_bias", "v_bias"):
                return f"{base}.attn.{sub}", None
            if sub == "inner_attn_ln":
                return f"{base}.attn.inner_attn_ln.{ln[rest[2]]}", None
            if sub == "rel_pos_bias":
                return f"{base}.attn.relative_position_bias_table", None
            if sub == "proj":
                t = "linear" if rest[2] == "kernel" else None
                return f"{base}.attn.proj.{'weight' if t else 'bias'}", t
        if rest[0] == "mlp":
            sub = rest[1]
            if sub == "ffn_ln":
                return f"{base}.mlp.ffn_ln.{ln[rest[2]]}", None
            t = "linear" if rest[2] == "kernel" else None
            return f"{base}.mlp.{sub}.{'weight' if t else 'bias'}", t
        if rest[0] in ("gamma_1", "gamma_2"):
            return f"{base}.{rest[0]}", None
    raise KeyError(f"unmapped EVA vision param: {flax_key}")


# the third of a torch-packed q / k / v projection that a flax Dense fills
_QKV = {"q_proj": 0, "k_proj": 1, "v_proj": 2}


def _vit_vision_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `visual` of a plain OpenCLIP ViT tower
    (`visual.transformer.resblocks` layout) to (torch_key, transform), as
    `_eva_vision_key_map` does."""
    k = list(flax_key)
    ln = {"scale": "weight", "bias": "bias"}
    if k == ["conv1", "kernel"]:
        return "visual.conv1.weight", "conv"
    if k in (["class_embedding"], ["positional_embedding"], ["proj"]):
        return f"visual.{k[0]}", None
    if len(k) == 2 and k[0] in ("ln_pre", "ln_post"):
        return f"visual.{k[0]}.{ln[k[1]]}", None
    m = re.match(r"resblocks_(\d+)", k[0])
    if m:
        base = f"visual.transformer.resblocks.{m.group(1)}"
        rest = k[1:]
        if rest[0] in ("ls_1", "ls_2"):
            return f"{base}.{rest[0]}.gamma", None
        if rest[0] in ("ln_1", "ln_2"):
            return f"{base}.{rest[0]}.{ln[rest[1]]}", None
        if rest[0] == "in_proj":
            if rest[1] == "kernel":
                return f"{base}.attn.in_proj_weight", "linear"
            return f"{base}.attn.in_proj_bias", None
        if rest[0] == "out_proj":
            t = "linear" if rest[1] == "kernel" else None
            return f"{base}.attn.out_proj.{'weight' if t else 'bias'}", t
        if rest[0] in ("c_fc", "c_proj"):
            t = "linear" if rest[1] == "kernel" else None
            return f"{base}.mlp.{rest[0]}.{'weight' if t else 'bias'}", t
    if k[0] == "attn_pool":
        # the CoCa pooler: torch MultiheadAttention with kdim != embed_dim
        # (separate q / k / v weights, one packed bias)
        rest, base = k[1:], "visual.attn_pool"
        if rest == ["query"]:
            return f"{base}.query", None
        if rest[0] in ("ln_q", "ln_k"):
            return f"{base}.{rest[0]}.{ln[rest[1]]}", None
        if rest[0] in _QKV:
            if rest[1] == "kernel":
                return f"{base}.attn.{rest[0]}_weight", "linear"
            return f"{base}.attn.in_proj_bias", ("slice", _QKV[rest[0]])
        if rest[0] == "out_proj":
            t = "linear" if rest[1] == "kernel" else None
            return f"{base}.attn.out_proj.{'weight' if t else 'bias'}", t
    raise KeyError(f"unmapped OpenCLIP ViT vision param: {flax_key}")


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _resnet_vision_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `visual` of a ModifiedResNet tower
    (`visual.layer{s}.{i}` layout) to (torch_key, transform), as
    `_eva_vision_key_map` does. The stem's `conv1` is the plain ViT map's
    key. BatchNorm's mean and var are the reference's running statistics;
    a bottleneck's downsample is the reference's Sequential(avgpool '-1',
    conv '0', bn '1')."""
    k = list(flax_key)
    if re.fullmatch(r"conv[23]", k[0]) and k[1:] == ["kernel"]:
        return f"visual.{k[0]}.weight", "conv"
    if re.fullmatch(r"bn[123]", k[0]):
        return f"visual.{k[0]}.{_BN[k[1]]}", None
    m = re.fullmatch(r"layer(\d+)_(\d+)", k[0])
    if m:
        base = f"visual.layer{m.group(1)}.{m.group(2)}"
        rest = k[1:]
        if re.fullmatch(r"conv[123]", rest[0]) and rest[1] == "kernel":
            return f"{base}.{rest[0]}.weight", "conv"
        if re.fullmatch(r"bn[123]", rest[0]):
            return f"{base}.{rest[0]}.{_BN[rest[1]]}", None
        if rest == ["downsample_conv", "kernel"]:
            return f"{base}.downsample.0.weight", "conv"
        if rest[0] == "downsample_bn":
            return f"{base}.downsample.1.{_BN[rest[1]]}", None
    if k[0] == "attnpool":
        rest = k[1:]
        if rest == ["positional_embedding"]:
            return "visual.attnpool.positional_embedding", None
        if rest[0] in ("q_proj", "k_proj", "v_proj", "c_proj"):
            t = "linear" if rest[1] == "kernel" else None
            return f"visual.attnpool.{rest[0]}.{'weight' if t else 'bias'}", t
    raise KeyError(f"unmapped ModifiedResNet vision param: {flax_key}")


_LN = {"scale": "weight", "bias": "bias"}


def _dense(base: str, leaf: str) -> tuple[str, Any]:
    """A flax Dense leaf (`kernel` or `bias`) of the torch module ``base``."""
    t = "linear" if leaf == "kernel" else None
    return f"{base}.{'weight' if t else 'bias'}", t


def _timm_head_key_map(k: list) -> tuple[str, Any]:
    """The projection of a timm tower: `proj` -> `visual.head.proj`, the MLP
    head's `proj_fc1` / `proj_fc2` -> `visual.head.mlp.fc1` / `fc2`."""
    if k[0] == "proj" and k[1:] == ["kernel"]:
        return "visual.head.proj.weight", "linear"
    if k[0] in ("proj_fc1", "proj_fc2") and len(k) == 2:
        return _dense(f"visual.head.mlp.fc{k[0][-1]}", k[1])
    raise KeyError(f"unmapped timm head param: {k}")


def _convnext_vision_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `visual` of a ConvNeXt tower to the timm
    layout (`visual.trunk.stem.*`, `visual.trunk.stages.*`,
    `visual.trunk.head.norm.*`, `visual.head.*`), as `_eva_vision_key_map` does."""
    k = list(flax_key)
    if k[0] == "head_norm":
        return f"visual.trunk.head.norm.{_LN[k[1]]}", None
    if k[0] != "trunk":
        return _timm_head_key_map(k)
    rest = k[1:]
    if rest[0] == "stem_conv":
        return ("visual.trunk.stem.0.weight", "conv") if rest[1] == "kernel" else ("visual.trunk.stem.0.bias", None)
    if rest[0] == "stem_norm":
        return f"visual.trunk.stem.1.{_LN[rest[1]]}", None
    m = re.fullmatch(r"downsample_norm_(\d+)", rest[0])
    if m:
        return f"visual.trunk.stages.{m.group(1)}.downsample.0.{_LN[rest[1]]}", None
    m = re.fullmatch(r"downsample_conv_(\d+)", rest[0])
    if m:
        t = "conv" if rest[1] == "kernel" else None
        return f"visual.trunk.stages.{m.group(1)}.downsample.1.{'weight' if t else 'bias'}", t
    m = re.fullmatch(r"stage(\d+)_block(\d+)", rest[0])
    if m:
        base = f"visual.trunk.stages.{m.group(1)}.blocks.{m.group(2)}"
        sub = rest[1:]
        if sub[0] == "conv_dw":
            t = "conv" if sub[1] == "kernel" else None
            return f"{base}.conv_dw.{'weight' if t else 'bias'}", t
        if sub[0] == "norm":
            return f"{base}.norm.{_LN[sub[1]]}", None
        if sub[0] in ("mlp_fc1", "mlp_fc2"):
            return _dense(f"{base}.mlp.fc{sub[0][-1]}", sub[1])
        if sub == ["gamma"]:
            return f"{base}.gamma", None
    raise KeyError(f"unmapped ConvNeXt vision param: {flax_key}")


def _swin_vision_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `visual` of a Swin tower to the classic
    timm Swin layout (`visual.trunk.patch_embed.*`,
    `visual.trunk.layers.{i}.blocks.{j}.*`,
    `visual.trunk.layers.{i}.downsample.*`, `visual.trunk.norm.*`,
    `visual.head.*`)."""
    k = list(flax_key)
    if k[0] != "trunk":
        return _timm_head_key_map(k)
    rest = k[1:]
    if rest[0] == "patch_embed_conv":
        t = "conv" if rest[1] == "kernel" else None
        return f"visual.trunk.patch_embed.proj.{'weight' if t else 'bias'}", t
    if rest[0] == "patch_embed_norm":
        return f"visual.trunk.patch_embed.norm.{_LN[rest[1]]}", None
    if rest[0] == "norm":
        return f"visual.trunk.norm.{_LN[rest[1]]}", None
    m = re.fullmatch(r"downsample_norm_(\d+)", rest[0])
    if m:
        return f"visual.trunk.layers.{m.group(1)}.downsample.norm.{_LN[rest[1]]}", None
    m = re.fullmatch(r"downsample_reduction_(\d+)", rest[0])
    if m:
        return f"visual.trunk.layers.{m.group(1)}.downsample.reduction.weight", "linear"
    m = re.fullmatch(r"layer(\d+)_block(\d+)", rest[0])
    if m:
        base = f"visual.trunk.layers.{m.group(1)}.blocks.{m.group(2)}"
        sub = rest[1:]
        if sub[0] in ("norm1", "norm2"):
            return f"{base}.{sub[0]}.{_LN[sub[1]]}", None
        if sub[0] in ("attn_qkv", "attn_proj"):
            return _dense(f"{base}.attn.{sub[0][5:]}", sub[1])
        if sub == ["rel_pos_table"]:
            return f"{base}.attn.relative_position_bias_table", None
        if sub[0] in ("mlp_fc1", "mlp_fc2"):
            return _dense(f"{base}.mlp.fc{sub[0][-1]}", sub[1])
    raise KeyError(f"unmapped Swin vision param: {flax_key}")


def _timm_vit_vision_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `visual` of a timm plain-ViT tower to the
    timm ViT layout (`visual.trunk.patch_embed.proj.*`,
    `visual.trunk.cls_token`, `visual.trunk.pos_embed`,
    `visual.trunk.blocks.{j}.*` with the rel-pos MLP at
    `attn.rel_pos.mlp.*`, `visual.trunk.norm.*` / `fc_norm.*`,
    `visual.head.proj.weight`)."""
    k = list(flax_key)
    if k[0] == "patch_embed_conv":
        t = "conv" if k[1] == "kernel" else None
        return f"visual.trunk.patch_embed.proj.{'weight' if t else 'bias'}", t
    if k in (["cls_token"], ["pos_embed"]):
        return f"visual.trunk.{k[0]}", None
    if k[0] in ("norm", "fc_norm") and len(k) == 2:
        return f"visual.trunk.{k[0]}.{_LN[k[1]]}", None
    m = re.fullmatch(r"block(\d+)", k[0])
    if m:
        base = f"visual.trunk.blocks.{m.group(1)}"
        sub = k[1:]
        if sub[0] in ("norm1", "norm2"):
            return f"{base}.{sub[0]}.{_LN[sub[1]]}", None
        if sub[0] in ("attn_qkv", "attn_proj"):
            return _dense(f"{base}.attn.{sub[0][5:]}", sub[1])
        if sub[0] in ("mlp_fc1", "mlp_fc2"):
            return _dense(f"{base}.mlp.fc{sub[0][-1]}", sub[1])
    m = re.fullmatch(r"rel_pos(\d+)", k[0])
    if m and len(k) == 3:
        # timm keeps the bias MLP on the attention module
        return _dense(f"visual.trunk.blocks.{m.group(1)}.attn.rel_pos.mlp.{k[1]}", k[2])
    return _timm_head_key_map(k)


def _timm_key_map(timm_model_name: str):
    """The key map of a timm tower, by its trunk family (`convnext*`,
    `swin*`, `vit_*`, as `models/clip.py::_visual_class` routes it)."""
    for prefix, key_map in (("convnext", _convnext_vision_key_map), ("swin", _swin_vision_key_map),
                            ("vit_", _timm_vit_vision_key_map)):
        if timm_model_name.startswith(prefix):
            return key_map
    raise KeyError(f"timm trunk {timm_model_name!r} has no key map")


def _hf_key(base: str, rest: list) -> tuple[str, Any]:
    """A leaf of a transformers Flax trunk under the torch module ``base``:
    the path joined by '.', `kernel` a transposed linear weight (the ViT
    patch projection's an OIHW conv weight), `scale` and `embedding` a
    verbatim `weight`, every other leaf (`bias`, the T5 norm's `weight`,
    `cls_token`, `position_embeddings`) verbatim under its own name."""
    leaf, path = rest[-1], ".".join(rest[:-1])
    if leaf == "kernel":
        return f"{base}.{path}.weight", "conv" if rest[-3:-1] == ["patch_embeddings", "projection"] else "linear"
    name = "weight" if leaf in ("scale", "embedding") else leaf
    return f"{base}.{path}.{name}" if path else f"{base}.{name}", None


def _hf_vision_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """The transformers trunk adapter: `trunk/...` -> `visual.trunk.<the
    transformers torch ViTModel names>`, `head` -> `visual.head.weight`."""
    k = list(flax_key)
    if k[0] == "trunk" and len(k) > 1:
        return _hf_key("visual.trunk", k[1:])
    if k == ["head", "kernel"]:
        return "visual.head.weight", "linear"
    raise KeyError(f"unmapped HF trunk adapter param: {flax_key}")


def _vision_key_map(flax_key: tuple[str, ...], cfg: Optional[CLIPConfig] = None) -> tuple[str, Any]:
    """The visual tower's key map. A timm tower's is chosen from ``cfg``, as
    the JAX package's `_vision_key_map(flax_key, cfg)` chooses it: its flax
    names collide with other towers' (`trunk` in Swin and ConvNeXt;
    `cls_token`, `pos_embed` and `norm` in EVA and the timm ViT; `proj` in
    the OpenCLIP ViT). Otherwise the EVA layout, else the plain OpenCLIP
    ViT's, else the ModifiedResNet's (these trees share no top-level name
    but the stem's `conv1`, which the ViT map takes for both; the JAX
    package tries them in this order), else the transformers trunk
    adapter's (whose `head` the EVA map takes alike), which ``cfg`` with
    `hf_trunk_name` picks directly."""
    if cfg is not None and cfg.vision.timm_model_name:
        return _timm_key_map(cfg.vision.timm_model_name)(flax_key)
    if cfg is not None and cfg.vision.hf_trunk_name:
        return _hf_vision_key_map(flax_key)
    for key_map in (_eva_vision_key_map, _vit_vision_key_map, _resnet_vision_key_map):
        try:
            return key_map(flax_key)
        except KeyError:
            pass
    return _hf_vision_key_map(flax_key)


def _text_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `text` to (torch_key, transform), as
    `_eva_vision_key_map` does. An HF text tower's `trunk/...` is
    `text.transformer.<the transformers torch names>`, its `proj` the
    reference's `text.proj.weight` (linear) or `text.proj.{0,2}.weight`
    (the MLP's `layers_0`, `layers_2`)."""
    k = list(flax_key)
    if k[0] == "trunk" and len(k) > 1:
        return _hf_key("text.transformer", k[1:])
    if k == ["proj", "kernel"]:
        return "text.proj.weight", "linear"
    if k[0] == "proj" and len(k) == 3 and k[2] == "kernel" and re.fullmatch(r"layers_\d+", k[1]):
        return f"text.proj.{k[1][len('layers_'):]}.weight", "linear"
    if k == ["cls_emb"]:
        return "text.cls_emb", None
    if k == ["token_embedding", "embedding"]:
        return "text.token_embedding.weight", None
    if k == ["positional_embedding"]:
        return "text.positional_embedding", None
    if k == ["text_projection"]:
        return "text.text_projection", None
    if k == ["ln_final", "scale"]:
        return "text.ln_final.weight", None
    if k == ["ln_final", "bias"]:
        return "text.ln_final.bias", None
    m = re.match(r"resblocks_(\d+)", k[0])
    if m:
        i = m.group(1)
        rest = k[1:]
        base = f"text.transformer.resblocks.{i}"
        ln = {"scale": "weight", "bias": "bias"}
        if rest[0] in ("ls_1", "ls_2"):
            return f"{base}.{rest[0]}.gamma", None
        if rest[0] in ("ln_1", "ln_2"):
            return f"{base}.{rest[0]}.{ln[rest[1]]}", None
        if rest[0] == "in_proj":
            if rest[1] == "kernel":
                return f"{base}.attn.in_proj_weight", "linear"
            return f"{base}.attn.in_proj_bias", None
        if rest[0] == "out_proj":
            t = "linear" if rest[1] == "kernel" else None
            return f"{base}.attn.out_proj.{'weight' if t else 'bias'}", t
        if rest[0] in ("c_fc", "c_proj"):
            t = "linear" if rest[1] == "kernel" else None
            return f"{base}.mlp.{rest[0]}.{'weight' if t else 'bias'}", t
    raise KeyError(f"unmapped text param: {flax_key}")


def _decoder_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `text_decoder` (the CoCa decoder) to
    (torch_key, transform), as `_eva_vision_key_map` does: the self blocks
    have the text tower's layout under `text_decoder.resblocks.{i}`; a
    cross block's q / k / v kernels and biases fill thirds of the packed
    `attn.in_proj_weight` and `attn.in_proj_bias` (transform
    ("linear_slice", i) or ("slice", i))."""
    k = list(flax_key)
    ln = {"scale": "weight", "bias": "bias"}
    if k == ["text_projection"]:
        return "text_decoder.text_projection", None
    if k[0] == "ln_final":
        return f"text_decoder.ln_final.{ln[k[1]]}", None
    if re.match(r"resblocks_(\d+)", k[0]):
        tkey, t = _text_key_map(flax_key)
        return tkey.replace("text.transformer.", "text_decoder."), t
    m = re.match(r"cross_attn_(\d+)", k[0])
    if m:
        base, rest = f"text_decoder.cross_attn.{m.group(1)}", k[1:]
        if rest[0] in ("ln_1", "ln_1_kv", "ln_2"):
            return f"{base}.{rest[0]}.{ln[rest[1]]}", None
        if rest[0] in _QKV:
            if rest[1] == "kernel":
                return f"{base}.attn.in_proj_weight", ("linear_slice", _QKV[rest[0]])
            return f"{base}.attn.in_proj_bias", ("slice", _QKV[rest[0]])
        if rest[0] == "out_proj":
            t = "linear" if rest[1] == "kernel" else None
            return f"{base}.attn.out_proj.{'weight' if t else 'bias'}", t
        if rest[0] in ("c_fc", "c_proj"):
            t = "linear" if rest[1] == "kernel" else None
            return f"{base}.mlp.{rest[0]}.{'weight' if t else 'bias'}", t
    raise KeyError(f"unmapped decoder param: {flax_key}")


_KEY_MAPS = {"visual": _vision_key_map, "text": _text_key_map, "text_decoder": _decoder_key_map}


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def flax_to_torch_key(path: tuple[str, ...], cfg: Optional[CLIPConfig] = None) -> tuple[str, Any]:
    """(torch key, transform) of a flax param path (`visual`, `text`,
    `text_decoder` or `logit_scale` first); a timm tower's visual keys need
    ``cfg``."""
    if path == ("logit_scale",):
        return "logit_scale", None
    if path[0] == "visual":
        return _vision_key_map(path[1:], cfg)
    return _KEY_MAPS[path[0]](path[1:])


def state_dict_from_jax(params: Any, cfg: Optional[CLIPConfig] = None) -> dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of arrays: `visual`, `text`, a CoCa's
    `text_decoder`, and `logit_scale`) -> float32 torch state dict in the
    reference layout (linear weights transposed, the HWIO patch kernel made
    OIHW, the thirds of a packed q / k / v projection joined in q, k, v
    order, as `clipself_tpu/models/torch_io.py::export_state_dict` joins
    them). A timm tower's tree needs its config ``cfg``: its flax names
    collide with the other towers' (`_vision_key_map`)."""
    unknown = sorted(set(params) - set(_KEY_MAPS) - {"logit_scale"})
    if unknown:
        raise KeyError(f"params of parts the port does not build: {unknown}")
    out, packed = {}, {}
    for part in _KEY_MAPS:
        for path, val in _flatten(params.get(part, {})).items():
            key, transform = flax_to_torch_key((part,) + path, cfg)
            arr = np.asarray(val, dtype=np.float32)
            if isinstance(transform, tuple):
                kind, idx = transform
                packed.setdefault(key, {})[idx] = arr.T if kind == "linear_slice" else arr
                continue
            if transform == "linear":
                arr = arr.T
            elif transform == "conv":
                arr = arr.transpose(3, 2, 0, 1)
            out[key] = torch.tensor(arr)
    for key, thirds in packed.items():
        if sorted(thirds) != [0, 1, 2]:
            raise KeyError(f"{key}: the tree holds thirds {sorted(thirds)} of the packed projection")
        out[key] = torch.tensor(np.concatenate([thirds[0], thirds[1], thirds[2]], axis=0))
    if "text.transformer.shared.weight" in out:
        # a T5 trunk: the encoder's `embed_tokens` is the `shared` module,
        # under both keys in the torch state dict, once in the flax tree
        out["text.transformer.encoder.embed_tokens.weight"] = out["text.transformer.shared.weight"].clone()
    out["logit_scale"] = torch.tensor(np.asarray(params["logit_scale"], dtype=np.float32))
    return out


# flax module names of the detector's 2x2 stride-2 transposed convolutions
_DECONV_NAMES = ("deconv", "upsample")


def detector_state_dict_from_jax(det_params: Any) -> dict[str, torch.Tensor]:
    """The flax param tree of `clipself_tpu.detector.fvit.FViTDetector`
    (nested dicts of arrays) -> float32 state dict of the port's
    `FViTDetector`. Keys are the tree paths joined by '.', with `kernel` and
    `scale` named `weight`. Layouts: conv kernels HWIO -> OIHW; dense kernels
    transposed; a transposed-conv kernel [kh, kw, in, out] -> [in, out, kh,
    kw] with both spatial axes reversed (flax `ConvTranspose` correlates the
    dilated input with the kernel as stored, `torch.conv_transpose2d`
    scatters it, which mirrors it). The bbox head's first fc needs no row
    permutation: the port flattens pooled rois channels-last, as flax does."""
    out = {}
    for path, val in _flatten(det_params).items():
        arr = np.asarray(val, dtype=np.float32)
        leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
        if path[-1] == "kernel" and arr.ndim == 4:
            if path[-2] in _DECONV_NAMES:
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T
        out[".".join(path[:-1] + (leaf,))] = torch.tensor(arr.copy())
    return out


def detector_state_dict_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """The inverse of `detector_state_dict_from_jax`: a state dict of the
    port's `FViTDetector` -> the flax param tree (nested dicts of float32
    NumPy arrays) in flax layouts. A `weight` is a `kernel`, or a norm's
    `scale` where it is one-dimensional (the detector's only 1-D weights
    are GroupNorm scales)."""
    tree: dict = {}
    for key, val in sd.items():
        path = key.split(".")
        arr = val.detach().float().cpu().numpy()
        if path[-1] == "weight":
            path[-1] = "scale" if arr.ndim == 1 else "kernel"
        if path[-1] == "kernel" and arr.ndim == 4:
            if path[-2] in _DECONV_NAMES:  # [in, out, kh, kw] -> [kh, kw, in, out], mirrored
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:  # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
        elif path[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.array(arr)  # a contiguous copy, 0-d kept
    return tree


def unwrap_state_dict(sd: dict) -> dict:
    """Probe `state_dict|model|module` containers, strip `module.` prefixes
    and drop RoPE buffers (reference `eva_clip/factory.py:80-106`)."""
    for key in ("state_dict", "model", "module"):
        if key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return {
        k: v
        for k, v in sd.items()
        if "rope.freqs" not in k
        and ".rope." not in k
        and not k.endswith(("freqs_cos", "freqs_sin", "rope.flag"))
    }


def load_weights(model: nn.Module, source: Union[str, dict]) -> None:
    """Load a reference-layout state dict, or a `.pt` checkpoint path, into
    a port `CLIP` with `strict=True`: every key of the visual tower, the
    text tower and `logit_scale` must be there, and no other (BatchNorm's
    `num_batches_tracked`, the rel-pos bias's `relative_position_index` and
    a timm Swin block's `attn_mask`, buffers the port recomputes, are
    dropped). A text-tower
    key may come without its `text.` prefix (`import_state_dict` of the JAX
    package takes the open_clip hub layout so). A checkpoint with no
    text-tower key at all raises a KeyError that names them: the text tower
    is never left at its initial weights."""
    if isinstance(source, str):
        source = torch.load(source, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in unwrap_state_dict(source).items()
          if not k.endswith(("num_batches_tracked", "relative_position_index", ".attn_mask"))}
    text_keys = [k for k in model.state_dict() if k.startswith("text.")]
    for key in text_keys:
        bare = key[len("text."):]
        if key not in sd and bare in sd:
            sd[key] = sd.pop(bare)
    if text_keys and not any(k in sd for k in text_keys):
        raise KeyError(
            f"the checkpoint holds none of the {len(text_keys)} text-tower keys "
            f"({text_keys[0]!r}, ..., {text_keys[-1]!r}; with or without the 'text.' prefix)"
        )
    model.load_state_dict(
        {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}, strict=True
    )


def resize_pos_embed_np(pe: np.ndarray, tgt_tokens: int) -> np.ndarray:
    """Bicubic-resize a [1, 1+S^2, D] pos-embed to [1, tgt_tokens, D]
    (a copy of `clipself_tpu/models/torch_io.py::resize_pos_embed_np`,
    reference `resize_evaclip_pos_embed`, `eva_clip/utils.py:78-139`)."""
    if pe.shape[1] == tgt_tokens:
        return pe
    src = int(round((pe.shape[1] - 1) ** 0.5))
    tgt = int(round((tgt_tokens - 1) ** 0.5))
    cls_pe = pe[:, :1]
    grid = pe[:, 1:].reshape(src, src, -1).astype(np.float32)
    w = resize_weight_matrix(src, tgt, "bicubic")
    grid = np.einsum("oh,hwd->owd", w, grid)
    grid = np.einsum("pw,owd->opd", w, grid)
    return np.concatenate([cls_pe, grid.reshape(1, tgt * tgt, -1)], axis=1)


def is_torchscript_archive(path: str) -> bool:
    """Whether ``path`` is a `torch.jit` archive (a zip holding
    `constants.pkl`, as the OpenAI releases are)."""
    import zipfile

    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.split("/")[-1] == "constants.pkl" for n in z.namelist())


def import_state_dict(model: nn.Module, sd: dict, source: str = "state dict") -> list[str]:
    """Fill a port `CLIP` from a reference-layout state dict (tensors or
    arrays) the way the JAX package's `import_state_dict` fills a param tree
    (`clipself_tpu/models/torch_io.py:511`): containers unwrapped and RoPE
    buffers dropped (`unwrap_state_dict`), a text-tower key also taken
    without its `text.` prefix, the absolute pos-embed (`visual.pos_embed`
    of the EVA towers, `visual.positional_embedding` of the OpenCLIP ViT)
    bicubic-resized to the model's grid, keys the model lacks ignored, and
    **non-strict**: a parameter the dict lacks keeps its value (logged). A
    shape that differs otherwise raises: a timm tower's `visual.trunk.pos_embed`
    and Swin tables are not resized (no registry config needs it). Returns
    the missing keys."""
    sd = unwrap_state_dict(sd)
    missing = []
    with torch.no_grad():
        for key, param in model.state_dict().items():
            tkey = key
            if tkey not in sd and tkey.startswith("text.") and tkey[len("text."):] in sd:
                tkey = tkey[len("text."):]  # the open_clip hub layout
            if tkey not in sd:
                missing.append(key)
                continue
            val = sd[tkey]
            arr = val.detach().cpu().float().numpy() if torch.is_tensor(val) else np.asarray(val, np.float32)
            if key == "visual.pos_embed":
                arr = resize_pos_embed_np(arr, param.shape[1])
            elif key == "visual.positional_embedding":
                arr = resize_pos_embed_np(arr[None], param.shape[0])[0]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))  # a 0-d stays 0-d
    if missing:
        log.info(f"{source}: {len(missing)} key(s) not in the checkpoint keep their "
                 f"initial values: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    log.debug(f"{source}: {len(sd)} checkpoint keys, {len(missing)} missing: {missing}")
    return missing


def load_pretrained(model: nn.Module, path: str) -> list[str]:
    """Load a reference-layout `.pt` checkpoint, or a `.npz` of the same
    keys, into a port `CLIP` with `import_state_dict` (non-strict), as the
    JAX package's `load_pretrained` does (`clipself_tpu/models/torch_io.py:594`).
    Unlike `load_weights`, which is strict. Returns the missing keys.

    A directory (an Orbax run of the JAX trainer) needs jax to read and
    raises; so does a name that is not a file (resolve a catalog tag with
    `models/pretrained.py::resolve_pretrained` first, as `create_model`
    does). A `torch.jit` archive (an OpenAI release) raises too, naming
    `models/openai.py::load_openai_model`: the JAX route gives such a file
    to `torch.load` and fails on the script module it returns."""
    if os.path.isdir(path):
        raise ValueError(
            f"--pretrained {path}: a directory is an Orbax checkpoint of the JAX trainer, which "
            "needs jax to read; export it as a .pt (--export-torch) and pass that"
        )
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"--pretrained {path}: no such file (a catalog tag resolves through "
            "models/pretrained.py::resolve_pretrained)"
        )
    if is_torchscript_archive(path):
        raise ValueError(
            f"--pretrained {path}: a torch.jit archive (an OpenAI release) holds no state dict "
            "to import; build the model from it with models/openai.py::load_openai_model"
        )
    if path.endswith(".npz"):
        with np.load(path) as npz:
            sd = {k: npz[k] for k in npz.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_state_dict(model, sd, source=f"--pretrained {path}")
