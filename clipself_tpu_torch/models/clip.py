"""CLIP assembly with the dense-prediction API: a visual tower (EVA01 /
EVA02, the plain OpenCLIP / OpenAI ViT, the ModifiedResNet or a timm-family
tower), the text tower and `logit_scale` (a port of
`clipself_tpu/models/clip.py`). The text tower is frozen by recipe
(`train/optim.py::trainable_labels`).

The visual tower is chosen from the config as the JAX package chooses it:
`hf_trunk_name` gives the transformers trunk adapter `TrunkAdapter`,
`timm_model_name` `ConvNeXtTower` (`convnext*`), `SwinTower` (`swin*`) or
`TimmViTTower` (`vit_*`), `eva_model_name` `EvaViT`, `resnet_layers`
`ModifiedResNet`, a config with none of these `OpenCLIPViT`. The text tower
is `HFTextTower` where the config names `hf_model_name`, else the CLIP
`TextTransformer`. A config with a multimodal decoder builds a
`models/coca.py::CoCa` (`models/factory.py::model_class`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from clipself_tpu_torch.core.config import CLIPConfig, VisionConfig
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.models.convnext import ConvNeXtTower
from clipself_tpu_torch.models.eva_vit import EvaViT
from clipself_tpu_torch.models.hf_configs import trunk_config
from clipself_tpu_torch.models.hf_text import HFTextTower
from clipself_tpu_torch.models.modified_resnet import ModifiedResNet
from clipself_tpu_torch.models.open_clip_vit import OpenCLIPViT
from clipself_tpu_torch.models.swin import SwinTower
from clipself_tpu_torch.models.timm_vit import TimmViTTower
from clipself_tpu_torch.models.text_transformer import TextTransformer
from clipself_tpu_torch.models.trunk_adapter import TrunkAdapter
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1


def _visual_class(cfg: CLIPConfig):
    """The port's tower class of ``cfg``."""
    v = cfg.vision
    if v.hf_trunk_name:
        return TrunkAdapter
    if v.timm_model_name:
        # one tower a timm trunk family (`clipself_tpu/models/clip.py:45-64`)
        for prefix, tower in (("convnext", ConvNeXtTower), ("swin", SwinTower), ("vit_", TimmViTTower)):
            if v.timm_model_name.startswith(prefix):
                return tower
        raise NotImplementedError(
            f"timm trunk {v.timm_model_name!r} has no native tower "
            "(supported families: convnext_*, swin_*, vit_*)"
        )
    if v.eva_model_name:
        return EvaViT
    return ModifiedResNet if v.resnet_layers else OpenCLIPViT


def dense_stride(v: VisionConfig) -> int:
    """The stride of a tower's dense map in pixels: 32 for the ConvNeXt and
    Swin towers, whose configs carry the default `patch_size`, the HF
    config's `patch_size` for the transformers trunk adapter, else the
    config's `patch_size` (32 for the ResNets)."""
    if v.hf_trunk_name:
        return trunk_config(v.hf_trunk_name, v.hf_trunk_kwargs).patch_size
    return 32 if (v.timm_model_name or "").startswith(("convnext", "swin")) else v.patch_size


class CLIP(nn.Module):
    def __init__(
        self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False
    ):
        super().__init__()
        self.cfg = cfg
        self.visual = _visual_class(cfg)(cfg.vision, cfg.embed_dim, dtype, grad_checkpointing)
        text = HFTextTower if cfg.text.hf_model_name else TextTransformer
        self.text = text(cfg.text, cfg.embed_dim, dtype)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def init_weights(self, generator: torch.Generator) -> None:
        """The visual tower's initial draw from ``generator``, then the text
        tower's."""
        self.visual.init_weights(generator)
        self.text.init_weights(generator)

    def forward(self, image: torch.Tensor, text: torch.Tensor):
        """(image embedding, text embedding), both L2-normalized, and
        exp(logit_scale) (`clipself_tpu/models/clip.py::CLIP.__call__`)."""
        return (
            self.encode_image(image, normalize=True),
            self.encode_text(text, normalize=True),
            self.logit_scale.exp(),
        )

    def encode_text(self, text: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        """text [B, n] token ids -> [B, embed_dim] EOT embedding."""
        feats = self.text(text)
        return l2_normalize(feats) if normalize else feats

    def encode_image(self, image: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        """image [B, H, W, 3] -> [B, embed_dim] CLS embedding."""
        feats = self.visual(image)
        return l2_normalize(feats) if normalize else feats

    def encode_dense(
        self, image: torch.Tensor, keep_shape: bool = False, normalize: bool = False
    ) -> torch.Tensor:
        """image [B, H, W, 3] -> dense features [B, gh, gw, C] (keep_shape)
        or [B, gh*gw, C], L2-normalized by every tower but the timm-family
        ones; ``normalize`` normalizes them (once more), as the JAX
        package's flag does."""
        feats = self.visual.encode_dense(image, keep_shape=keep_shape)
        return l2_normalize(feats) if normalize else feats

    def encode_pseudo_boxes(
        self,
        image: torch.Tensor,
        normed_boxes: torch.Tensor,
        normalize: bool = False,
        extract_type: str = "v2",
    ) -> torch.Tensor:
        """image [B, H, W, 3]; normed_boxes [B, M, 4] xyxy in [0, 1] ->
        RoI features [B, M, C] (`clipself_tpu/models/clip.py:132-145`).
        ``extract_type`` 'v1' (mask-attention pooling) and 'v3' reach the
        OpenCLIP ViT; the EVA tower has one RoI path and ignores it, as the
        reference and the JAX package do."""
        feats = self.visual.extract_roi_features(image, normed_boxes, extract_type)
        return l2_normalize(feats) if normalize else feats

    def _mask_feats(self, image: torch.Tensor, masks: torch.Tensor, mask_attn: bool) -> torch.Tensor:
        """Mask-attention pooling where the tower has it (``mask_attn``; the
        ModifiedResNet's is its masked mean), else the tower's own
        `mask_pool` where it has one (the timm towers and the ResNet: the
        timm towers L2-normalize their dense map first), else the masked
        mean of the dense map (the EVA tower and the OpenCLIP ViT, whose
        JAX `mask_pool` is that expression), as the JAX wrapper calls
        `visual.mask_pool`."""
        if mask_attn and hasattr(self.visual, "mask_attn_pool"):
            return self.visual.mask_attn_pool(image, masks)
        if hasattr(self.visual, "mask_pool"):
            return self.visual.mask_pool(image, masks)
        return mask_pool(self.visual.encode_dense(image, keep_shape=True), masks)

    def encode_masks(
        self,
        image: torch.Tensor,
        masks: torch.Tensor,
        normalize: bool = True,
        mask_attn: bool = False,
    ) -> torch.Tensor:
        """image [B, H, W, 3]; masks [B, M, gh, gw] binary -> [B, M, C]
        (`clipself_tpu/models/clip.py:147-161`)."""
        feats = self._mask_feats(image, masks, mask_attn)
        return l2_normalize(feats) if normalize else feats

    def encode_rois_and_image(self, image: torch.Tensor, normed_boxes: torch.Tensor):
        """(normalized RoI features, normalized image embedding) of one
        trunk pass (the OpenCLIP ViT, the ModifiedResNet and the timm-family
        towers; v1 RoIs for ConvNeXt and Swin, v2 for the others)."""
        return self.visual.encode_rois_and_image(image, normed_boxes)

    def encode_rois_and_masks(
        self,
        image: torch.Tensor,
        normed_boxes: torch.Tensor,
        masks: torch.Tensor,
        normalize: bool = True,
        extract_type: str = "v2",
        mask_attn: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """RoI features and mask features: image [B, H, W, 3]; normed_boxes
        [B, M, 4] xyxy in [0, 1]; masks [B, M, gh, gw]. Returns ([B, M, C],
        [B, M, C]). At extract_type 'v2' without ``mask_attn`` both come
        from ONE dense trunk pass; otherwise from the separate calls, as
        the JAX package falls back (`clipself_tpu/models/clip.py:163-209`).
        The shared pass pools the dense map as `encode_dense` gives it, which
        the timm towers leave un-normalized (so does the JAX wrapper), while
        their own v2 RoIs and `mask_pool` normalize it first."""
        if extract_type == "v2" and not mask_attn:
            dense = self.visual.encode_dense(image, keep_shape=True)
            _, gh, gw, _ = dense.shape
            rois = roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
            mp = mask_pool(dense, masks)
        else:
            # the tower's own call, not `encode_pseudo_boxes`: on a mesh that
            # method is an FSDP2 forward of its own, which would give the
            # root's parameters back before `_mask_feats` reads them
            rois = self.visual.extract_roi_features(image, normed_boxes, extract_type)
            mp = self._mask_feats(image, masks, mask_attn)
        if normalize:
            rois = l2_normalize(rois)
            mp = l2_normalize(mp)
        return rois, mp

    def visual_taps(self, image: torch.Tensor, out_indices: tuple, with_dense: bool = False):
        """Intermediate visual-trunk taps for detection backbones
        (`EvaViT.forward_taps`)."""
        return self.visual.forward_taps(image, out_indices, with_dense=with_dense)
