"""The plain-ViT towers of the timm config family with the dense-prediction
protocol, in PyTorch.

A port of `clipself_tpu/models/timm_vit.py` (reference `TimmModel`,
`src/open_clip/timm_model.py:29-108`, network-default pooling, a bias-free
linear projection) for its two configs:

  - `vit_relpos_medium_patch16_cls_224`: width 512, 12 blocks, 8 heads, a
    class token, NO absolute position embedding; every block adds a
    relative-position bias to its logits, made by its own `RelPosMlp` from
    log-scaled relative coordinates (timm mode 'cr': sign(d) * log1p(|d|)
    -> fc1 -> ReLU -> fc2 -> heads, zero-padded over the class row and
    column). Pooled: the class token after `norm`;
  - `vit_medium_patch16_gap_256`: the same trunk with an absolute
    `pos_embed`, no class token, the mean of the tokens after `fc_norm`
    (the pre-pool norm is the identity).

Both blocks are timm's: pre-norm attention with a bias-free fused `qkv`,
then a 4x exact-GELU MLP, both residual, no layer scale; every LayerNorm
(eps 1e-6) runs the port's LayerNorm (`eva_vit.LayerNorm`: the hand-written
kernel on the card). Attention without a bias (the GAP variant) runs the
flash kernel through `ops/attention.py::multi_head_attention`: the JAX
tower's einsum attention is the same softmax(q k^T * scale) v with float32
logits, and on the card a CUDA tensor launches the hand-written kernel;
with the rel-pos bias it is `attention_masked`, plain PyTorch on every
device, as no Pallas kernel stands behind the JAX tower's biased einsum.

The absolute `pos_embed` is never resized, at a forward or at import, as in
the JAX tower: the GAP variant runs at 256^2 only. `RelPosMlp` holds an
[N^2, 512] float32 activation (N the patch tokens; at 448^2 1.2 GB a block),
as the JAX tower does, so the rel-pos variant runs at 224^2 and 448^2.

The dense protocol is the one the JAX tower defines: `encode_dense` is the
variant's norm and the projection on every patch token, NOT L2-normalized;
RoI features (any extract type) are 1x1 RoI-align of the L2-normalized map;
`mask_pool` pools that map. Parameter names are timm's ViT state dict's
(`visual.trunk.patch_embed.proj.weight`, `visual.trunk.cls_token`,
`visual.trunk.pos_embed`, `visual.trunk.blocks.{j}.attn.qkv.weight`,
`visual.trunk.blocks.{j}.attn.rel_pos.mlp.fc1.weight`,
`visual.trunk.norm.weight` / `visual.trunk.fc_norm.weight`,
`visual.head.proj.weight`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipself_tpu_torch.core.config import VisionConfig
from clipself_tpu_torch.models.common import device_constant, l2_normalize
from clipself_tpu_torch.models.convnext import Mlp, TimmHead, init_timm_weights
from clipself_tpu_torch.models.eva_vit import Dense, LayerNorm, PatchEmbed, _trunc_normal
from clipself_tpu_torch.ops.attention import multi_head_attention
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1

# arch hyperparameters per timm model name; a copy of
# `clipself_tpu/models/timm_vit.py::TIMM_VIT_ARCHS`
TIMM_VIT_ARCHS: dict[str, dict] = {
    "vit_relpos_medium_patch16_cls_224": dict(
        width=512, depth=12, heads=8, patch=16, cls_token=True,
        pool="token", rel_pos=True, rel_pos_dim=512, qkv_bias=False,
        fc_norm=False, abs_pos=False,
    ),
    "vit_medium_patch16_gap_256": dict(
        width=512, depth=12, heads=8, patch=16, cls_token=False,
        pool="avg", rel_pos=False, rel_pos_dim=0, qkv_bias=False,
        fc_norm=True, abs_pos=True,
    ),
}
LN_EPS = 1e-6


@lru_cache(maxsize=32)
def _rel_log_coords(gh: int, gw: int) -> np.ndarray:
    """[gh*gw, gh*gw, 2] log-scaled relative coordinates, timm
    `gen_relative_log_coords` mode 'cr': sign(d) * log1p(|d|)."""
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij"))
    flat = coords.reshape(2, -1).astype(np.float32)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # [N, N, 2]
    return np.sign(rel) * np.log1p(np.abs(rel))


class RelPosMlp(nn.Module):
    """The per-block relative-position bias head (timm `RelPosMlp`, mode
    'cr'): the float32 bias [heads, P + N, P + N] of N = gh*gw patch tokens
    and P prefix (class) tokens, zero on the prefix rows and columns."""

    def __init__(self, heads: int, hidden: int, prefix_tokens: int):
        super().__init__()
        self.prefix_tokens = prefix_tokens
        self.mlp = nn.Module()
        self.mlp.fc1 = Dense(2, hidden)
        self.mlp.fc2 = Dense(hidden, heads)

    def forward(self, gh: int, gw: int) -> torch.Tensor:
        coords = device_constant(("rel log coords", gh, gw), _rel_log_coords(gh, gw), self.mlp.fc1.weight.device)
        bias = self.mlp.fc2(F.relu(self.mlp.fc1(coords)))
        bias = bias.permute(2, 0, 1)  # [heads, N, N]
        p = self.prefix_tokens
        return F.pad(bias, (p, 0, p, 0)) if p else bias


class Attention(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool, rel_pos: Optional[RelPosMlp]):
        super().__init__()
        self.width, self.heads = width, heads
        self.qkv = Dense(width, 3 * width, bias=qkv_bias)
        self.proj = Dense(width, width)
        self.rel_pos = rel_pos

    def forward(self, x: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
        b, n, w = x.shape
        hd = w // self.heads
        # strided views of the packed rows: the flash kernel reads them as they are
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, hd).unbind(2)
        bias = None if self.rel_pos is None else self.rel_pos(*grid)[None]
        out = multi_head_attention(q, k, v, hd ** -0.5, bias)
        return self.proj(out.reshape(b, n, w))


class TimmViTBlock(nn.Module):
    """timm's ViT block: pre-norm attention, then the MLP, both residual."""

    def __init__(self, a: dict):
        super().__init__()
        width = a["width"]
        rel_pos = RelPosMlp(a["heads"], a["rel_pos_dim"], int(a["cls_token"])) if a["rel_pos"] else None
        self.norm1 = LayerNorm(width, LN_EPS)
        self.attn = Attention(width, a["heads"], a["qkv_bias"], rel_pos)
        self.norm2 = LayerNorm(width, LN_EPS)
        self.mlp = Mlp(width, 4 * width)

    def forward(self, x: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), grid)
        return x + self.mlp(self.norm2(x))


class TimmViTTrunk(nn.Module):
    """Patch embedding (+ class token, + absolute positions), the blocks and
    the variant's norm (`norm`, or `fc_norm` after pooling)."""

    def __init__(self, cfg: VisionConfig, a: dict):
        super().__init__()
        width, grid = a["width"], cfg.image_size // a["patch"]
        self.patch_embed = PatchEmbed(width, a["patch"])
        if a["cls_token"]:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        if a["abs_pos"]:
            self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + int(a["cls_token"]), width))
        self.blocks = nn.ModuleList(TimmViTBlock(a) for _ in range(a["depth"]))
        setattr(self, "fc_norm" if a["fc_norm"] else "norm", LayerNorm(width, LN_EPS))


class TimmViTTower(nn.Module):
    """`TimmModel` over a timm-style ViT trunk, the rel-pos 'cls' and the GAP
    variants (`clipself_tpu/models/timm_vit.py::TimmViTTower`)."""

    def __init__(
        self,
        cfg: VisionConfig,
        embed_dim: int,
        dtype: torch.dtype = torch.float32,
        grad_checkpointing: bool = False,
    ):
        super().__init__()
        if cfg.timm_model_name not in TIMM_VIT_ARCHS:
            raise KeyError(
                f"unknown timm ViT trunk {cfg.timm_model_name!r} (supported: {sorted(TIMM_VIT_ARCHS)})"
            )
        self.cfg, self.dtype, self.grad_checkpointing = cfg, dtype, grad_checkpointing
        self.arch = a = TIMM_VIT_ARCHS[cfg.timm_model_name]
        self.trunk = TimmViTTrunk(cfg, a)
        self.head = TimmHead(a["width"], embed_dim, "linear")

    @property
    def norm(self) -> LayerNorm:
        """The variant's norm: `fc_norm` (GAP) or `norm`."""
        return self.trunk.fc_norm if self.arch["fc_norm"] else self.trunk.norm

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with the JAX tower's distributions:
        lecun-normal (truncated) patch and dense kernels, zero biases, a zero
        class token, a truncated normal(0.02) position embedding (the
        LayerNorms keep their unit scales). Parameters must lie on the generator's device."""
        init_timm_weights(self, generator)
        if self.arch["cls_token"]:
            self.trunk.cls_token.zero_()
        if self.arch["abs_pos"]:
            _trunc_normal(self.trunk.pos_embed, 0.02, generator)

    def _tokens(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """Patch embedding (+ class token, + positions) and the blocks:
        ([B, P + N, width] without the final norm, (gh, gw))."""
        a, trunk = self.arch, self.trunk
        t = trunk.patch_embed(x, self.dtype)
        b, gh, gw, c = t.shape
        t = t.reshape(b, gh * gw, c)
        if a["cls_token"]:
            t = torch.cat([trunk.cls_token.to(self.dtype).expand(b, 1, c), t], dim=1)
        if a["abs_pos"]:
            pe = trunk.pos_embed
            if pe.shape[1] != t.shape[1]:
                raise ValueError(
                    f"pos_embed holds {pe.shape[1]} tokens but the input gives {t.shape[1]}: the "
                    "tower takes its config's image size (resize at import time with "
                    "resize_pos_embed_np)"
                )
            t = t + pe.to(self.dtype)
        for blk in trunk.blocks:
            if self.grad_checkpointing and torch.is_grad_enabled():
                t = checkpoint(blk, t, (gh, gw), use_reentrant=False, preserve_rng_state=False)
            else:
                t = blk(t, (gh, gw))
        return t, (gh, gw)

    def _pooled(self, tokens: torch.Tensor) -> torch.Tensor:
        """timm `forward_head`: the variant's pooling and norm placement."""
        a = self.arch
        if a["fc_norm"]:
            return self.norm((tokens[:, 1:] if a["cls_token"] else tokens).mean(dim=1))
        tokens = self.norm(tokens)
        return tokens[:, 0] if a["pool"] == "token" else tokens.mean(dim=1)

    def _dense(self, tokens: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
        """[B, gh, gw, embed_dim] projected patch tokens, NOT normalized."""
        patches = tokens[:, 1:] if self.arch["cls_token"] else tokens
        return self.head(self.norm(patches)).reshape(tokens.shape[0], *grid, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image embedding [B, embed_dim] (not normalized)."""
        return self.head(self._pooled(self._tokens(x)[0]))

    def encode_dense(self, x: torch.Tensor, keep_shape: bool = True) -> torch.Tensor:
        """The variant's norm and the projection on every patch token, NOT
        normalized: [B, gh, gw, C] if keep_shape, else [B, gh*gw, C]."""
        d = self._dense(*self._tokens(x))
        return d if keep_shape else d.reshape(d.shape[0], -1, d.shape[-1])

    def extract_roi_features(
        self, x: torch.Tensor, normed_boxes: torch.Tensor, extract_type: str = "v2"
    ) -> torch.Tensor:
        """RoI features [B, M, C] by 1x1 RoI-align of the L2-normalized dense
        map; the tower has one RoI path, ``extract_type`` is ignored, as in
        the JAX tower."""
        dense = l2_normalize(self.encode_dense(x, keep_shape=True))
        _, gh, gw, _ = dense.shape
        return roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))

    def mask_pool(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Masked mean of the L2-normalized dense map under ``masks`` [B, M, gh, gw]."""
        return mask_pool(l2_normalize(self.encode_dense(x, keep_shape=True)), masks)

    def encode_rois_and_image(self, x: torch.Tensor, normed_boxes: torch.Tensor):
        """(L2-normalized RoI features [B, M, C], L2-normalized image
        embedding [B, C]) from one trunk pass."""
        tokens, grid = self._tokens(x)
        image = l2_normalize(self.head(self._pooled(tokens)))
        dense = l2_normalize(self._dense(tokens, grid))
        rois = roi_align_1x1(dense, denormalize_boxes(normed_boxes, *grid))
        return l2_normalize(rois), image
