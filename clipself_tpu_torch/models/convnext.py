"""The ConvNeXt tower of the timm config family with the dense-prediction
protocol, in PyTorch.

A port of `clipself_tpu/models/convnext.py` (reference `TimmModel`,
`src/open_clip/timm_model.py:29-239`, over a timm ConvNeXt trunk):

  - trunk: a 4x4 stride-4 stem and a LayerNorm, four stages of blocks
    (7x7 depthwise conv -> LayerNorm -> 4x MLP with exact GELU -> layer
    scale `gamma`, residual), a LayerNorm and a 2x2 stride-2 conv before
    every stage but the first; the final map is NOT normed (the head norm
    lives with the pooling). No stochastic depth: the JAX block ignores
    `timm_drop_path`;
  - head: global average pool -> `trunk.head.norm` -> the projection, a
    bias-free linear `head.proj` or the MLP `head.mlp.fc1` (bias), exact
    GELU, `head.mlp.fc2` (no bias) (`TimmHead`);
  - the dense protocol: `encode_dense` is the head norm and projection on
    every position, NOT L2-normalized (the reference's; consumers
    normalize); `mask_pool` and RoI v2 normalize the map first; RoI v1
    RoI-aligns the raw trunk map to the grid a crop at `cfg.image_size`
    gives and runs each RoI through the pooled head;
  - activations are channels-last [B, H, W, C] at every module boundary:
    the stride-k k x k convs are reshape + matmul (`ops/patchify.py`), the
    depthwise conv (`groups=dim`, cuDNN on the card; the JAX package runs it
    outside any Pallas kernel) sees an NCHW view of a channels-last tensor
    and returns one, so every LayerNorm reads contiguous [.., C] rows;
  - every LayerNorm (eps 1e-6) runs the port's LayerNorm
    (`eva_vit.LayerNorm`: the hand-written kernel on the card, float32
    inside, the input's dtype out), as the flax norms of the JAX tower
    compute in float32 and are cast back;
  - module and parameter names are the timm state dict's
    (`visual.trunk.stem.0.weight`, `visual.trunk.stages.{s}.blocks.{i}.conv_dw.weight`,
    `visual.trunk.head.norm.weight`, `visual.head.proj.weight`, ...), the
    layout of the OpenCLIP convnext checkpoints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipself_tpu_torch.core.config import VisionConfig
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.models.eva_vit import Dense, LayerNorm, PatchEmbed, _lecun_normal
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.ops.patchify import patchify
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1, roi_align_nxn

# timm ConvNeXt variants (depths, channel widths) of the convnext_*.json
# configs; a copy of `clipself_tpu/models/convnext.py::CONVNEXT_ARCHS`
CONVNEXT_ARCHS: dict[str, tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}
LN_EPS = 1e-6
LS_INIT = 1e-6


class PatchConv(nn.Module):
    """A k x k stride-k VALID convolution with bias on a channels-last map,
    as reshape + matmul; float32 OIHW `weight` and `bias`."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return patchify(x, self.weight, self.bias, dtype)


class DepthwiseConv(nn.Module):
    """The 7x7 depthwise convolution (padding 3, bias) of a ConvNeXt block:
    [B, H, W, C] -> [B, H, W, C] in x's dtype, through an NCHW view of the
    channels-last tensor (the output is channels-last in memory too)."""

    def __init__(self, dim: int, k: int = 7):
        super().__init__()
        self.dim, self.k = dim, k
        self.weight = nn.Parameter(torch.zeros(dim, 1, k, k))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     padding=self.k // 2, groups=self.dim)
        return y.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (timm `Mlp`)."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None, bias2: bool = True):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, out or dim, bias=bias2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class TimmHead(nn.Module):
    """The projection of `TimmModel` into the joint space: `proj` (linear, no
    bias; `timm_model.py:100`) or `mlp` (`Mlp(width, 2 * embed, embed)`,
    fc2 without bias)."""

    def __init__(self, width: int, embed_dim: int, kind: str):
        super().__init__()
        if kind == "linear":
            self.proj = Dense(width, embed_dim, bias=False)
        elif kind == "mlp":
            self.mlp = Mlp(width, 2 * embed_dim, embed_dim, bias2=False)
        else:
            raise ValueError(f"unknown timm_proj {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x) if hasattr(self, "proj") else self.mlp(x)


def roi_target_size(image_size: int, img_hw, feat_hw) -> tuple[int, int]:
    """The RoI grid that a crop at the tower's ``image_size`` gives:
    image_size * feat / img on each axis, at least 1 (`timm_model.py:166-168`)."""
    th = (image_size * feat_hw[0]) // img_hw[0]
    tw = (image_size * feat_hw[1]) // img_hw[1]
    return max(th, 1), max(tw, 1)


@torch.no_grad()
def init_timm_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The flax initialisers of the JAX timm towers on every conv, patch
    embedding and dense layer under ``module``: lecun-normal (truncated)
    kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, (PatchConv, DepthwiseConv)):
            _lecun_normal(m.weight, m.weight[0].numel(), generator)
            m.bias.zero_()
        elif isinstance(m, PatchEmbed):
            _lecun_normal(m.proj["weight"], m.proj["weight"][0].numel(), generator)
            m.proj["bias"].zero_()
        elif isinstance(m, Dense):
            _lecun_normal(m.weight, m.in_features, generator)
            if m.bias is not None:
                m.bias.zero_()


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = DepthwiseConv(dim)
        self.norm = LayerNorm(dim, LN_EPS)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), LS_INIT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(self.norm(self.conv_dw(x)))
        return x + y * self.gamma.to(y.dtype)


class ConvNeXtStage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, downsample: bool):
        super().__init__()
        # timm's Sequential(LayerNorm2d '0', Conv2d '1'); the first stage has none
        self.downsample = nn.ModuleList([LayerNorm(cin, LN_EPS), PatchConv(cin, dim, 2)]) if downsample else None
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim) for _ in range(depth))


class _Head(nn.Module):
    """Holds the head norm under the timm name `trunk.head.norm`."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, LN_EPS)


class ConvNeXtTrunk(nn.Module):
    """Stem, four stages; returns the final map [B, H/32, W/32, C], not normed."""

    def __init__(self, depths: Tuple[int, ...], dims: Tuple[int, ...], dtype: torch.dtype,
                 grad_checkpointing: bool):
        super().__init__()
        self.dtype, self.grad_checkpointing = dtype, grad_checkpointing
        self.stem = nn.ModuleList([PatchConv(3, dims[0], 4), LayerNorm(dims[0], LN_EPS)])
        self.stages = nn.ModuleList(
            ConvNeXtStage(dims[max(s - 1, 0)], dim, depth, s > 0)
            for s, (depth, dim) in enumerate(zip(depths, dims))
        )
        self.head = _Head(dims[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem[1](self.stem[0](x, self.dtype))
        for stage in self.stages:
            if stage.downsample is not None:
                norm, conv = stage.downsample
                x = conv(norm(x), self.dtype)
            for blk in stage.blocks:
                if self.grad_checkpointing and torch.is_grad_enabled():
                    x = checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
                else:
                    x = blk(x)
        return x


class ConvNeXtTower(nn.Module):
    """`TimmModel` over the ConvNeXt trunk (`clipself_tpu/models/convnext.py::ConvNeXtTower`)."""

    def __init__(
        self,
        cfg: VisionConfig,
        embed_dim: int,
        dtype: torch.dtype = torch.float32,
        grad_checkpointing: bool = False,
    ):
        super().__init__()
        name = cfg.timm_model_name
        if name not in CONVNEXT_ARCHS:
            raise NotImplementedError(
                f"timm trunk {name!r} has no native implementation (supported: {sorted(CONVNEXT_ARCHS)})"
            )
        self.cfg, self.dtype = cfg, dtype
        depths, dims = CONVNEXT_ARCHS[name]
        self.trunk = ConvNeXtTrunk(depths, dims, dtype, grad_checkpointing)
        self.head = TimmHead(dims[-1], embed_dim, cfg.timm_proj)

    @property
    def grad_checkpointing(self) -> bool:
        return self.trunk.grad_checkpointing

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with the JAX tower's distributions:
        lecun-normal (truncated) conv and dense kernels, zero biases, layer
        scale 1e-6 (the LayerNorms keep their unit scales). Parameters must lie on the
        generator's device."""
        init_timm_weights(self, generator)
        for m in self.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.fill_(LS_INIT)

    def _forward_head(self, feats: torch.Tensor) -> torch.Tensor:
        """[..., h, w, C] maps -> joint space: average pool, head norm,
        projection."""
        return self.head(self.trunk.head.norm(feats.mean(dim=(-3, -2))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image embedding [B, embed_dim] (not normalized)."""
        return self._forward_head(self.trunk(x))

    def encode_dense(self, x: torch.Tensor, keep_shape: bool = True) -> torch.Tensor:
        """Head norm and projection on every position of the final map,
        NOT normalized: [B, gh, gw, C] if keep_shape, else [B, gh*gw, C]."""
        tokens = self.head(self.trunk.head.norm(self.trunk(x)))
        return tokens if keep_shape else tokens.reshape(tokens.shape[0], -1, tokens.shape[-1])

    def _rois_head(self, feats: torch.Tensor, x: torch.Tensor, normed_boxes: torch.Tensor) -> torch.Tensor:
        """The v1 RoI features [B, M, C] of the trunk map ``feats``."""
        _, fh, fw, _ = feats.shape
        tar = roi_target_size(self.cfg.image_size, x.shape[1:3], (fh, fw))
        rois = roi_align_nxn(feats, denormalize_boxes(normed_boxes, fh, fw), tar)
        return self._forward_head(rois)

    def extract_roi_features(
        self, x: torch.Tensor, normed_boxes: torch.Tensor, extract_type: str = "v1"
    ) -> torch.Tensor:
        """RoI features [B, M, C] of ``normed_boxes`` [B, M, 4] (xyxy in
        [0, 1]): v1 (the adapter's default) by RoI-align of the raw trunk map
        to the crop-size grid and the pooled head; v2 by 1x1 RoI-align of the
        L2-normalized dense map."""
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
        return rois, l2_normalize(self._forward_head(feats))
