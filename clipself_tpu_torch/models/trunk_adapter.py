"""The transformers vision trunk adapter in PyTorch, without `transformers`:
a port of `clipself_tpu/models/trunk_adapter.py::FlaxTrunkAdapter`.

A transformers ViT trunk (`models/hf_vit.py`, no pooler) made a CLIP tower
with the dense-prediction protocol: the class token ('cls') or the mean of
the patch tokens ('mean', `VisionConfig.hf_trunk_pool`) through a bias-free
`head` is the image embedding; `encode_dense` is the head on every patch
token, L2-normalized, [B, gh, gw, C]; RoI features are 1x1 RoI-align of that
map, `mask_pool` its masked mean. The patch size is the HF config's
(`hf_trunk_kwargs`), not `VisionConfig.patch_size`
(`models/clip.py::dense_stride`).

The config is `models/hf_configs.py::trunk_config(hf_trunk_name,
hf_trunk_kwargs)`: a model type ('vit') builds offline, a hub id (a name
with "/") raises OSError naming its `config.json`. The trunk computes in
float32 whatever the model's dtype, as the JAX adapter's Flax trunk does;
the head runs in the compute dtype. ``grad_checkpointing`` recomputes each
trunk layer in the backward pass (the JAX adapter takes `remat` and leaves
it unused; recomputation changes no value). Parameter names:
`visual.trunk.<transformers ViTModel names>`, `visual.head.weight`.
`load_hf_trunk_params` imports a transformers torch ViT state dict.
"""

from __future__ import annotations

import torch
from torch import nn

from clipself_tpu_torch.core.config import VisionConfig
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.models.eva_vit import Dense, _lecun_normal
from clipself_tpu_torch.models.hf_configs import trunk_config
from clipself_tpu_torch.models.hf_text import graft_state_dict
from clipself_tpu_torch.models.hf_vit import ViTModel
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1


class TrunkAdapter(nn.Module):
    def __init__(
        self,
        cfg: VisionConfig,
        embed_dim: int,
        dtype: torch.dtype = torch.float32,
        grad_checkpointing: bool = False,
    ):
        super().__init__()
        if cfg.hf_trunk_pool not in ("cls", "mean"):
            raise ValueError(f"hf_trunk_pool {cfg.hf_trunk_pool!r} (takes 'cls' or 'mean')")
        self.cfg, self.dtype, self.grad_checkpointing = cfg, dtype, grad_checkpointing
        self.hf_config = trunk_config(cfg.hf_trunk_name, cfg.hf_trunk_kwargs)
        self.patch_size = self.hf_config.patch_size
        self.trunk = ViTModel(self.hf_config)
        self.head = Dense(self.hf_config.hidden_size, embed_dim, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The trunk's transformers init, then flax `Dense`'s lecun-normal
        (truncated) head. Parameters must lie on the generator's device."""
        self.trunk.init_weights(generator)
        _lecun_normal(self.head.weight, self.head.in_features, generator)

    def _pooled(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens[:, 0] if self.cfg.hf_trunk_pool == "cls" else tokens[:, 1:].mean(dim=1)

    def _dense(self, tokens: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """[B, gh, gw, C] L2-normalized head of the patch tokens."""
        t = l2_normalize(self.head(tokens[:, 1:].to(self.dtype)))
        p = self.patch_size
        return t.reshape(x.shape[0], x.shape[1] // p, x.shape[2] // p, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> [B, embed_dim] (not normalized)."""
        return self.head(self._pooled(self.trunk(x, self.grad_checkpointing)).to(self.dtype))

    def encode_dense(self, x: torch.Tensor, keep_shape: bool = True) -> torch.Tensor:
        """The L2-normalized head on every patch token: [B, gh, gw, C] if
        keep_shape, else [B, gh*gw, C]."""
        d = self._dense(self.trunk(x, self.grad_checkpointing), x)
        return d if keep_shape else d.reshape(d.shape[0], -1, d.shape[-1])

    def extract_roi_features(
        self, x: torch.Tensor, normed_boxes: torch.Tensor, extract_type: str = "v2"
    ) -> torch.Tensor:
        """1x1 RoI-align of the dense map; one RoI path, ``extract_type`` is
        ignored, as in the JAX adapter."""
        dense = self.encode_dense(x, keep_shape=True)
        _, gh, gw, _ = dense.shape
        return roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))

    def mask_pool(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Masked mean of the dense map under ``masks`` [B, M, gh, gw]."""
        return mask_pool(self.encode_dense(x, keep_shape=True), masks)

    def encode_rois_and_image(self, x: torch.Tensor, normed_boxes: torch.Tensor):
        """(L2-normalized RoI features [B, M, C], L2-normalized image
        embedding [B, C]) from one trunk pass."""
        tokens = self.trunk(x, self.grad_checkpointing)
        image = l2_normalize(self.head(self._pooled(tokens).to(self.dtype)))
        dense = self._dense(tokens, x)
        _, gh, gw, _ = dense.shape
        rois = roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
        return l2_normalize(rois), image


def load_hf_trunk_params(torch_state_dict: dict, model: nn.Module) -> None:
    """Import a transformers torch `ViTModel` state dict (tensors or arrays)
    into ``model.visual.trunk`` in place, and `head.weight` [embed_dim, W]
    into the head where the dict carries one; the head keeps its value
    otherwise (`clipself_tpu/models/trunk_adapter.py:120-162`). A pooler's
    keys are dropped (the adapter's trunk has none, as the JAX adapter's
    `add_pooling_layer=False`); any other key set or shape that differs
    from the trunk's raises ValueError."""
    visual = model.visual
    sd = {k: v for k, v in torch_state_dict.items() if not k.startswith(("head.", "pooler."))}
    graft_state_dict(visual.trunk, sd, "HF ViT trunk")
    if "head.weight" in torch_state_dict:
        with torch.no_grad():
            visual.head.weight.copy_(torch.as_tensor(torch_state_dict["head.weight"], dtype=torch.float32))
