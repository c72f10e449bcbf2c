"""Weights in the reference PyTorch state-dict layout.

`state_dict_from_jax` turns the JAX package's param tree (nested dicts of
NumPy arrays) into the state dict of the reference `CustomCLIP`: the visual
tower, the text tower and `logit_scale`, with the key maps of the EVA branch
of `clipself_tpu/models/torch_io.py::_vision_key_map` and of `_text_key_map`
copied here (the result is pinned equal to that module's
`export_state_dict`). `load_weights` loads such a dict, or a reference
`.pt` checkpoint, into the whole CLIP with `strict=True`; text-tower keys
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
from typing import Any, Union

import numpy as np
import torch
from torch import nn

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


def _text_key_map(flax_key: tuple[str, ...]) -> tuple[str, Any]:
    """Map a flax param path under `text` to (torch_key, transform), as
    `_eva_vision_key_map` does."""
    k = list(flax_key)
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


_KEY_MAPS = {"visual": _eva_vision_key_map, "text": _text_key_map}


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def state_dict_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of arrays: `visual`, `text` and
    `logit_scale`) -> float32 torch state dict in the reference layout
    (linear weights transposed, the HWIO patch kernel made OIHW)."""
    unknown = sorted(set(params) - set(_KEY_MAPS) - {"logit_scale"})
    if unknown:
        raise KeyError(f"params of parts the port does not build: {unknown}")
    out = {}
    for part, key_map in _KEY_MAPS.items():
        for path, val in _flatten(params[part]).items():
            key, transform = key_map(path)
            arr = np.asarray(val, dtype=np.float32)
            if transform == "linear":
                arr = arr.T
            elif transform == "conv":
                arr = arr.transpose(3, 2, 0, 1)
            out[key] = torch.tensor(arr)
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
    text tower and `logit_scale` must be there, and no other. A text-tower
    key may come without its `text.` prefix (`import_state_dict` of the JAX
    package takes the open_clip hub layout so). A checkpoint with no
    text-tower key at all raises a KeyError that names them: the text tower
    is never left at its initial weights."""
    if isinstance(source, str):
        source = torch.load(source, map_location="cpu", weights_only=True)
    sd = dict(unwrap_state_dict(source))
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


def load_pretrained(model: nn.Module, path: str) -> list[str]:
    """Load a reference-layout `.pt` checkpoint, or a `.npz` of the same
    keys, into a port `CLIP` the way the JAX package's `load_pretrained` /
    `import_state_dict` fill a param tree (`clipself_tpu/models/torch_io.py:511,
    :594`): containers unwrapped and RoPE buffers dropped
    (`unwrap_state_dict`), a text-tower key also taken without its `text.`
    prefix, `visual.pos_embed` bicubic-resized to the model's grid, keys
    the model lacks ignored, and **non-strict**: a parameter the checkpoint
    lacks keeps its value (logged). A shape that differs otherwise raises.
    Returns the missing keys. Unlike `load_weights`, which is strict.

    A directory (an Orbax run of the JAX trainer) needs jax to read and
    raises; so does a name that is not a file (a catalog tag of
    `resolve_pretrained`: the registry is ROADMAP.md queue 1 item 8)."""
    if os.path.isdir(path):
        raise ValueError(
            f"--pretrained {path}: a directory is an Orbax checkpoint of the JAX trainer, which "
            "needs jax to read; export it as a .pt (--export-torch) and pass that"
        )
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"--pretrained {path}: no such file (catalog tags such as 'eva02' resolve through "
            "the JAX package's pretrained registry, not ported: ROADMAP.md queue 1 item 8)"
        )
    if path.endswith(".npz"):
        with np.load(path) as npz:
            sd = {k: npz[k] for k in npz.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
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
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))  # a 0-d stays 0-d
    if missing:
        log.info(f"--pretrained {path}: {len(missing)} key(s) not in the checkpoint keep their "
                 f"initial values: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    log.debug(f"--pretrained {path}: {len(sd)} checkpoint keys, {len(missing)} missing: {missing}")
    return missing
