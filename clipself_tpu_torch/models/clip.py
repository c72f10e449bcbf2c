"""CLIP assembly with the dense-prediction API: the EVA visual tower, the
text tower and `logit_scale` (a port of `clipself_tpu/models/clip.py`). The
text tower is frozen by recipe (`train/optim.py::trainable_labels`)."""

from __future__ import annotations

import math

import torch
from torch import nn

from clipself_tpu_torch.core.config import CLIPConfig
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.models.eva_vit import EvaViT
from clipself_tpu_torch.models.text_transformer import TextTransformer
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1


class CLIP(nn.Module):
    def __init__(
        self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False
    ):
        super().__init__()
        if not cfg.vision.eva_model_name:
            raise NotImplementedError(
                f"{cfg.name}: only the EVA vision towers are ported (ROADMAP.md queue 1 item 8)"
            )
        self.cfg = cfg
        self.visual = EvaViT(cfg.vision, cfg.embed_dim, dtype, grad_checkpointing)
        self.text = TextTransformer(cfg.text, cfg.embed_dim, dtype)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

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
        """image [B, H, W, 3] -> L2-normalized dense features
        [B, gh, gw, C] (keep_shape) or [B, gh*gw, C]; ``normalize``
        normalizes them once more, as the JAX package's flag does."""
        feats = self.visual.encode_dense(image, keep_shape=keep_shape)
        return l2_normalize(feats) if normalize else feats

    def encode_pseudo_boxes(
        self, image: torch.Tensor, normed_boxes: torch.Tensor, normalize: bool = False
    ) -> torch.Tensor:
        """image [B, H, W, 3]; normed_boxes [B, M, 4] xyxy in [0, 1] ->
        RoI features [B, M, C] (`clipself_tpu/models/clip.py:132-145`; the
        EVA tower has one extract type, so it takes no ``extract_type``)."""
        feats = self.visual.extract_roi_features(image, normed_boxes)
        return l2_normalize(feats) if normalize else feats

    def encode_rois_and_masks(
        self,
        image: torch.Tensor,
        normed_boxes: torch.Tensor,
        masks: torch.Tensor,
        normalize: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """RoI features and mask-pooled features from ONE dense trunk pass
        (extract_type 'v2'). image [B, H, W, 3]; normed_boxes [B, M, 4] xyxy
        in [0, 1]; masks [B, M, gh, gw]. Returns ([B, M, C], [B, M, C])."""
        dense = self.visual.encode_dense(image, keep_shape=True)
        _, gh, gw, _ = dense.shape
        rois = roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
        mp = mask_pool(dense, masks)
        if normalize:
            rois = l2_normalize(rois)
            mp = l2_normalize(mp)
        return rois, mp

    def visual_taps(self, image: torch.Tensor, out_indices: tuple, with_dense: bool = False):
        """Intermediate visual-trunk taps for detection backbones
        (`EvaViT.forward_taps`)."""
        return self.visual.forward_taps(image, out_indices, with_dense=with_dense)
