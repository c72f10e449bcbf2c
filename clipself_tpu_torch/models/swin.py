"""The Swin Transformer tower of the timm config family with the
dense-prediction protocol, in PyTorch.

A port of `clipself_tpu/models/swin.py` (reference `TimmModel` over a timm
Swin trunk, `src/open_clip/timm_model.py:29-108`, network-default pooling and
a bias-free linear projection):

  - trunk: a 4x4 stride-4 patch embedding and a LayerNorm, four stages of
    pre-norm blocks ((shifted-)window attention with a learned relative
    position bias, then a 4x exact-GELU MLP, both residual) with patch
    merging after every stage but the last (the 2x2 neighbours concatenated
    in MSR's order (0,0), (1,0), (0,1), (1,1) -> LayerNorm(4C) -> a
    bias-free linear to 2C), and a final LayerNorm: the map the trunk
    returns is already normed (timm `forward_features`);
  - the shift is a cyclic roll by (-s, -s) before the window partition and
    (+s, +s) after; pairs of tokens from different regions of the shifted
    grid get -100 on their logits (`_shift_attn_mask`); the table index of
    a pair is (dy + ws - 1) * (2ws - 1) + (dx + ws - 1)
    (`_relative_position_index`); a stage whose grid is no larger than the
    window runs one unshifted window of the grid's size, as timm and MSR
    clamp it. The tower takes only inputs whose stage grids divide by the
    window (896^2 with window 7, not 1024^2: the JAX tower's reshape fails
    there, the port raises a ValueError);
  - window attention is `ops/attention.py::attention_masked` over all
    windows at once, the table bias and the shift mask added to the float32
    logits: the JAX tower's einsum attention, behind which no Pallas kernel
    stands;
  - every LayerNorm (eps 1e-5; at patch merging over 4C) runs the port's
    LayerNorm (`eva_vit.LayerNorm`: the hand-written kernel on the card) on
    contiguous channels-last rows;
  - head and protocol: pooled = mean of the normed map -> projection
    (`convnext.TimmHead`); `encode_dense` is the projection on every
    position, NOT L2-normalized; `mask_pool` and RoI v2 normalize it first;
    RoI v1 RoI-aligns the normed trunk map to the crop-size grid and pools
    each RoI through the head;
  - module and parameter names are the classic timm Swin state dict's
    (`visual.trunk.patch_embed.proj.weight`,
    `visual.trunk.layers.{i}.blocks.{j}.attn.relative_position_bias_table`,
    `visual.trunk.layers.{i}.downsample.reduction.weight`,
    `visual.trunk.norm.weight`, `visual.head.proj.weight`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipself_tpu_torch.core.config import VisionConfig
from clipself_tpu_torch.models.common import device_constant, l2_normalize
from clipself_tpu_torch.models.convnext import (
    Mlp,
    TimmHead,
    init_timm_weights,
    roi_target_size,
)
from clipself_tpu_torch.models.eva_vit import Dense, LayerNorm, PatchEmbed, _trunc_normal
from clipself_tpu_torch.ops.attention import attention_masked
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1, roi_align_nxn

# (embed_dim, depths, num_heads, window_size) per timm model name; a copy of
# `clipself_tpu/models/swin.py::SWIN_ARCHS`
SWIN_ARCHS: dict[str, tuple[int, Tuple[int, ...], Tuple[int, ...], int]] = {
    "swin_tiny_patch4_window7_224": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
    "swin_small_patch4_window7_224": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
    "swin_base_patch4_window7_224": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7),
    "swin_large_patch4_window7_224": (192, (2, 2, 18, 2), (6, 12, 24, 48), 7),
}
LN_EPS = 1e-5
PATCH = 4


@lru_cache(maxsize=64)
def _relative_position_index(ws: int) -> np.ndarray:
    """[ws^2, ws^2] index into the (2ws-1)^2-row relative-position table
    (MSR Swin `WindowAttention.__init__`)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, ws^2, ws^2]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


@lru_cache(maxsize=64)
def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws^2, ws^2] additive mask (-100 across shifted-region pairs) of
    the cyclic-shift trick (MSR Swin `SwinTransformerBlock.attn_mask`)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws*ws, C], windows row-major within each image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of `_window_partition`."""
    bnw, _, c = x.shape
    b = bnw // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def effective_window(h: int, w: int, ws: int, shift: int) -> tuple[int, int]:
    """(window, shift) a block runs on an h x w grid: one unshifted window of
    the grid's size when the grid is no larger than the window."""
    if min(h, w) <= ws:
        return min(h, w), 0
    return ws, shift


def _shift_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """`_shift_attn_mask` as a float32 [nW, 1, ws^2, ws^2] tensor on ``device``."""
    return device_constant(("swin mask", h, w, ws, shift), _shift_attn_mask(h, w, ws, shift)[:, None], device)


def _table_index(ws: int, device) -> torch.Tensor:
    """`_relative_position_index` flattened, int64 on ``device``."""
    return device_constant(("swin index", ws), _relative_position_index(ws).reshape(-1).astype(np.int64), device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.proj = Dense(dim, dim)

    def bias(self, ws: int) -> torch.Tensor:
        """The float32 [heads, ws^2, ws^2] relative-position bias of a window."""
        table = self.relative_position_bias_table
        if table.shape[0] != (2 * ws - 1) ** 2:
            raise ValueError(
                f"the relative-position table holds {table.shape[0]} rows, a {ws}x{ws} window needs "
                f"{(2 * ws - 1) ** 2}: the stage's grid clamps the window otherwise than at the "
                "config's image size"
            )
        return table[_table_index(ws, table.device)].reshape(ws * ws, ws * ws, -1).permute(2, 0, 1)

    def forward(self, xw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """xw [B*nW, N, C] windows; ``mask`` float32, broadcast against the
        [B*nW, heads, N, N] logits."""
        bn, n, c = xw.shape
        hd = c // self.heads
        qkv = self.qkv(xw).view(bn, n, 3, self.heads, hd)
        q, k, v = qkv.unbind(2)
        out = attention_masked(q, k, v, hd ** -0.5, mask)
        return self.proj(out.reshape(bn, n, c))


class SwinBlock(nn.Module):
    """Pre-norm Swin block: (shifted-)window attention, then the MLP. Its
    table is sized for the window it runs on a ``grid`` x ``grid`` stage
    (the JAX tower's params are made at the config's image size)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, grid: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = WindowAttention(dim, heads, effective_window(grid, grid, window, shift)[0])
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = effective_window(h, w, self.window, self.shift)
        if h % ws or w % ws:
            raise ValueError(
                f"a {h}x{w} stage grid does not divide into {ws}x{ws} windows: the Swin tower takes "
                "inputs whose stage grids each divide by the window (e.g. 896^2, not 1024^2, at window 7)"
            )
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = self.attn.bias(ws)[None]  # [1, heads, N, N]
        if shift:
            n_win = (h // ws) * (w // ws)
            mask = (mask + _shift_mask(h, w, ws, shift, x.device))  # [nW, heads, N, N]
            mask = mask.expand(b, n_win, -1, -1, -1).reshape(b * n_win, *mask.shape[1:])
        y = _window_reverse(self.attn(_window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, LN_EPS)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        # MSR's order: (0::2, 0::2), (1::2, 0::2), (0::2, 1::2), (1::2, 1::2)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, grid: int, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2, grid) for j in range(depth)
        )
        self.downsample = PatchMerging(dim) if merge else None


class _PatchEmbed(PatchEmbed):
    """The 4x4 patch embedding and its LayerNorm (`patch_embed.proj`, `patch_embed.norm`)."""

    def __init__(self, width: int):
        super().__init__(width, PATCH)
        self.norm = LayerNorm(width, LN_EPS)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.norm(super().forward(x, dtype))


class SwinTrunk(nn.Module):
    """Patch embed, four stages, final norm; returns the normed map [B, H/32, W/32, C]."""

    def __init__(self, cfg: VisionConfig, dtype: torch.dtype, grad_checkpointing: bool):
        super().__init__()
        embed_dim, depths, heads, window = SWIN_ARCHS[cfg.timm_model_name]
        self.dtype, self.grad_checkpointing = dtype, grad_checkpointing
        self.patch_embed = _PatchEmbed(embed_dim)
        grid = cfg.image_size // PATCH
        layers = []
        for s, depth in enumerate(depths):
            layers.append(SwinStage(embed_dim * 2 ** s, depth, heads[s], window, grid, s < len(depths) - 1))
            grid //= 2
        self.layers = nn.ModuleList(layers)
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(self.num_features, LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x, self.dtype)
        for stage in self.layers:
            for blk in stage.blocks:
                if self.grad_checkpointing and torch.is_grad_enabled():
                    x = checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
                else:
                    x = blk(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return self.norm(x)


class SwinTower(nn.Module):
    """`TimmModel` over the Swin trunk (`clipself_tpu/models/swin.py::SwinTower`)."""

    def __init__(
        self,
        cfg: VisionConfig,
        embed_dim: int,
        dtype: torch.dtype = torch.float32,
        grad_checkpointing: bool = False,
    ):
        super().__init__()
        if cfg.timm_model_name not in SWIN_ARCHS:
            raise KeyError(f"unknown Swin trunk {cfg.timm_model_name!r} (supported: {sorted(SWIN_ARCHS)})")
        self.cfg, self.dtype = cfg, dtype
        self.trunk = SwinTrunk(cfg, dtype, grad_checkpointing)
        self.head = TimmHead(self.trunk.num_features, embed_dim, cfg.timm_proj)

    @property
    def grad_checkpointing(self) -> bool:
        return self.trunk.grad_checkpointing

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with the JAX tower's distributions:
        lecun-normal (truncated) patch and dense kernels, zero biases,
        truncated normal(0.02) relative-position tables (the LayerNorms keep
        their unit scales).
        Parameters must lie on the generator's device."""
        init_timm_weights(self, generator)
        for m in self.modules():
            if isinstance(m, WindowAttention):
                _trunc_normal(m.relative_position_bias_table, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image embedding [B, embed_dim] (not normalized): the mean of the
        normed map, projected."""
        return self.head(self.trunk(x).mean(dim=(1, 2)))

    def encode_dense(self, x: torch.Tensor, keep_shape: bool = True) -> torch.Tensor:
        """The projection of every position of the normed map, NOT
        normalized: [B, gh, gw, C] if keep_shape, else [B, gh*gw, C]."""
        tokens = self.head(self.trunk(x))
        return tokens if keep_shape else tokens.reshape(tokens.shape[0], -1, tokens.shape[-1])

    def _rois_head(self, feats: torch.Tensor, x: torch.Tensor, normed_boxes: torch.Tensor) -> torch.Tensor:
        _, fh, fw, _ = feats.shape
        tar = roi_target_size(self.cfg.image_size, x.shape[1:3], (fh, fw))
        rois = roi_align_nxn(feats, denormalize_boxes(normed_boxes, fh, fw), tar)
        return self.head(rois.mean(dim=(2, 3)))

    def extract_roi_features(
        self, x: torch.Tensor, normed_boxes: torch.Tensor, extract_type: str = "v1"
    ) -> torch.Tensor:
        """RoI features [B, M, C]: v1 by RoI-align of the normed trunk map to
        the crop-size grid, averaged and projected; v2 by 1x1 RoI-align of
        the L2-normalized dense map."""
        if extract_type == "v1":
            return self._rois_head(self.trunk(x), x, normed_boxes)
        if extract_type == "v2":
            dense = l2_normalize(self.encode_dense(x, keep_shape=True))
            _, gh, gw, _ = dense.shape
            return roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
        raise NotImplementedError(extract_type)

    def mask_pool(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Masked mean of the L2-normalized dense map under ``masks`` [B, M, gh, gw]."""
        return mask_pool(l2_normalize(self.encode_dense(x, keep_shape=True)), masks)

    def encode_rois_and_image(self, x: torch.Tensor, normed_boxes: torch.Tensor):
        """(L2-normalized v1 RoI features [B, M, C], L2-normalized image
        embedding [B, C]) from one trunk pass."""
        feats = self.trunk(x)
        rois = l2_normalize(self._rois_head(feats, x, normed_boxes))
        return rois, l2_normalize(self.head(feats.mean(dim=(1, 2))))

