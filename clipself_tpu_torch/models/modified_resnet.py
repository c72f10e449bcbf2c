"""The CLIP ModifiedResNet tower with the dense-prediction protocol, in
PyTorch.

A port of `clipself_tpu/models/modified_resnet.py` (reference
`src/open_clip/modified_resnet.py`):

  - the three-conv stem and a 2x2 average pool; anti-aliased bottlenecks
    (a 2x2 average pool before the strided 1x1, the downsample an average
    pool, a 1x1 conv and a BatchNorm); the attention-pooling head with
    q/k/v/c projections, whose query is the mean token;
  - BatchNorm is frozen (inference mode: the running statistics normalise,
    nothing updates them in the forward), computed in float32 and cast to
    the compute dtype. The statistics are PARAMETERS, as in the JAX package,
    where they live in the param tree: they get gradients, and AdamW moves
    them in every unlocked group unless `--lock-image-freeze-bn-stats`
    freezes them (`train/optim.py::trainable_labels`); weight decay skips
    them (their names hold `bn` or are 1-D). They keep the reference names
    `running_mean` / `running_var`, so the state-dict keys are the
    reference's;
  - the dense protocol: the attention pool's value path on every token
    (`v_proj`, then `c_proj`, no attention mixing) with the positional
    embedding bicubic-resized to the input's grid, L2-normalized; RoI
    features v1 by 7x7 RoI-align on the stage-4 map and the attention pool
    of each RoI, v2 (and v3) by 1x1 RoI-align on the dense map;
    `mask_attn_pool` is `mask_pool`, as in the reference;
  - images are channels-last [B, H, W, 3] at the module boundaries; the
    convolutions (cuDNN on the card; the JAX package computes them outside
    any Pallas kernel) see NCHW views of channels-last tensors;
  - no kernel of the port runs here: the JAX package runs no Pallas kernel
    on this tower (BatchNorm, not LayerNorm, and XLA attention in the pool),
    so the pool's attention is `ops/attention.py::attention_masked` without
    a mask, plain PyTorch on every device.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipself_tpu_torch.core.config import VisionConfig
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.models.eva_vit import Dense, _lecun_normal
from clipself_tpu_torch.ops.attention import attention_masked
from clipself_tpu_torch.ops.interpolate import resize_2d
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1, roi_align_nxn

BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over the channels of an NCHW tensor:
    (x - running_mean) / sqrt(running_var + 1e-5) * weight + bias in
    float32, returned in the compute dtype."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(t):
            return t[:, None, None]

        y = (x.float() - c(self.running_mean)) / torch.sqrt(c(self.running_var) + BN_EPS)
        return (y * c(self.weight) + c(self.bias)).to(self.dtype)


class Conv(nn.Module):
    """A bias-free convolution with a float32 OIHW `weight`, computed in the
    compute dtype (flax `nn.Conv(dtype=..., param_dtype=float32)`)."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype, stride: int = 1):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, k // 2
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, self.stride, self.padding)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax `avg_pool(x, (k, k), strides=(k, k))`, VALID: the window mean."""
    return F.avg_pool2d(x, k, k)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, dtype: torch.dtype):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv(inplanes, planes, 1, dtype)
        self.bn1 = FrozenBatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, 3, dtype)
        self.bn2 = FrozenBatchNorm(planes, dtype)
        self.conv3 = Conv(planes, out_ch, 1, dtype)
        self.bn3 = FrozenBatchNorm(out_ch, dtype)
        # the reference's Sequential(avgpool '-1', conv '0', bn '1')
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(Conv(inplanes, out_ch, 1, dtype), FrozenBatchNorm(out_ch, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = _avg_pool(identity, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """The attention-pooling head over a [B, h, w, C] map: the mean token
    and the tokens, a learned positional embedding, multi-head attention
    (the mean token's output is the pooled feature) and `c_proj`."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.spacial_dim, self.embed_dim, self.num_heads = spacial_dim, embed_dim, num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Dense(embed_dim, embed_dim)
        self.k_proj = Dense(embed_dim, embed_dim)
        self.v_proj = Dense(embed_dim, embed_dim)
        self.c_proj = Dense(embed_dim, output_dim)

    def _pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """[1 + gh*gw, C], the grid bicubic-resized to (gh, gw)."""
        pe, s = self.positional_embedding, self.spacial_dim
        if (gh, gw) == (s, s):
            return pe
        grid = pe[1:].reshape(s, s, -1).permute(2, 0, 1)[None]
        grid = resize_2d(grid, (gh, gw), method="bicubic")[0]
        return torch.cat([pe[:1], grid.permute(1, 2, 0).reshape(gh * gw, -1)], dim=0)

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[B, h, w, C] -> [B, 1 + h*w, C]: the mean token first, positions added."""
        b, gh, gw, c = x.shape
        t = x.reshape(b, gh * gw, c)
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        return t + self._pos_embed(gh, gw).to(t.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, h, w, C] stage-4 map -> [B, output_dim] pooled feature."""
        t = self._tokens(x)
        b, n, c = t.shape
        heads = (b, n, self.num_heads, c // self.num_heads)
        q, k, v = (p(t).view(heads) for p in (self.q_proj, self.k_proj, self.v_proj))
        out = attention_masked(q, k, v, (c // self.num_heads) ** -0.5)
        return self.c_proj(out.reshape(b, n, c))[:, 0]

    def forward_dense(self, x: torch.Tensor) -> torch.Tensor:
        """The per-token value path: [B, h, w, C] -> [B, h, w, output_dim]."""
        b, gh, gw, _ = x.shape
        t = self.c_proj(self.v_proj(self._tokens(x)))
        return t[:, 1:].reshape(b, gh, gw, -1)


class ModifiedResNet(nn.Module):
    def __init__(
        self,
        cfg: VisionConfig,
        embed_dim: int,
        dtype: torch.dtype = torch.float32,
        grad_checkpointing: bool = False,
    ):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.grad_checkpointing = grad_checkpointing
        layers: Sequence[int] = cfg.resnet_layers
        width = cfg.width
        self.conv1 = Conv(3, width // 2, 3, dtype, stride=2)
        self.bn1 = FrozenBatchNorm(width // 2, dtype)
        self.conv2 = Conv(width // 2, width // 2, 3, dtype)
        self.bn2 = FrozenBatchNorm(width // 2, dtype)
        self.conv3 = Conv(width // 2, width, 3, dtype)
        self.bn3 = FrozenBatchNorm(width, dtype)
        inplanes = width
        for stage, (planes, n) in enumerate(zip((width, width * 2, width * 4, width * 8), layers)):
            blocks = []
            for i in range(n):
                blocks.append(Bottleneck(inplanes, planes, 2 if (i == 0 and stage > 0) else 1, dtype))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(
            cfg.image_size // 32, width * 32, width * 32 // cfg.head_width, embed_dim
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with the JAX tower's distributions:
        lecun-normal (truncated) conv and dense kernels, zero biases,
        BatchNorm weight 1, bias 0, running mean 0, running var 1, the
        positional embedding normal(C^-0.5). Parameters must lie on the
        generator's device."""
        for m in self.modules():
            if isinstance(m, Conv):
                _lecun_normal(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, Dense):
                _lecun_normal(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
                m.running_var.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
        pool = self.attnpool
        pool.positional_embedding.normal_(0.0, pool.embed_dim ** -0.5, generator=generator)

    @property
    def stages(self) -> list[nn.Sequential]:
        return [self.layer1, self.layer2, self.layer3, self.layer4]

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> the stage-4 map [B, H/32, W/32, width * 32]."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # an NCHW view, channels-last in memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = _avg_pool(x, 2)
        for stage in self.stages:
            for blk in stage:
                if self.grad_checkpointing and torch.is_grad_enabled():
                    x = checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
                else:
                    x = blk(x)
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image embedding [B, embed_dim] (not normalized): the attention pool."""
        return self.attnpool(self._trunk(x))

    def encode_dense(self, x: torch.Tensor, keep_shape: bool = True) -> torch.Tensor:
        """L2-normalized dense features: [B, gh, gw, C] if keep_shape, else
        [B, gh*gw, C]."""
        dense = l2_normalize(self.attnpool.forward_dense(self._trunk(x)))
        return dense if keep_shape else dense.reshape(dense.shape[0], -1, dense.shape[-1])

    def extract_roi_features(
        self, x: torch.Tensor, normed_boxes: torch.Tensor, extract_type: str = "v1"
    ) -> torch.Tensor:
        """RoI features [B, M, C] of ``normed_boxes`` [B, M, 4] (xyxy in [0,
        1]): v1 by RoI-align of the stage-4 map to the pool's grid, then the
        attention pool of each RoI; any other type by 1x1 RoI-align on the
        dense map."""
        if extract_type == "v1":
            feats = self._trunk(x)
            _, gh, gw, _ = feats.shape
            tar = self.attnpool.spacial_dim
            b, m = normed_boxes.shape[:2]
            rois = roi_align_nxn(feats, denormalize_boxes(normed_boxes, gh, gw), (tar, tar))
            return self.attnpool(rois.reshape(b * m, tar, tar, -1)).reshape(b, m, -1)
        dense = self.encode_dense(x, keep_shape=True)
        _, gh, gw, _ = dense.shape
        return roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))

    def mask_pool(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Masked mean of the dense map under ``masks`` [B, M, gh, gw]."""
        return mask_pool(self.encode_dense(x, keep_shape=True), masks)

    def mask_attn_pool(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """`mask_pool`: the reference aliases it for the ResNet."""
        return self.mask_pool(x, masks)

    def encode_rois_and_image(self, x: torch.Tensor, normed_boxes: torch.Tensor):
        """(L2-normalized v2 RoI features [B, M, C], L2-normalized image
        embedding [B, C]) from one trunk pass."""
        feats = self._trunk(x)
        image = l2_normalize(self.attnpool(feats))
        dense = l2_normalize(self.attnpool.forward_dense(feats))
        _, gh, gw, _ = dense.shape
        rois = roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
        return l2_normalize(rois), image
