"""The plain OpenCLIP / OpenAI vision transformer with the dense protocol, in
PyTorch.

A port of `clipself_tpu/models/open_clip_vit.py` (reference
`VisionTransformer`, `src/open_clip/transformer.py:318-492`, and the fork's
dense protocol, `transformer.py:550-589, 659-834`):

  - trunk: a bias-free patchify (`conv1`, the OIHW weight computed as
    reshape + matmul, `ops/patchify.py`), the CLS token and a learned
    positional embedding (bicubic-resized to the input's grid), `ln_pre`,
    pre-LN blocks with the packed q/k/v projection of
    `torch.nn.MultiheadAttention` and a GELU MLP (QuickGELU by
    `cfg.quick_gelu`, LayerScale by `cfg.ls_init_value`), `ln_post` and the
    linear `proj`;
  - every LayerNorm uses eps 1e-5 whatever `cfg.ln_eps` says, as the JAX
    tower's `_layer_norm` does, and runs the port's LayerNorm
    (`eva_vit.LayerNorm`, the hand-written kernel on the card): float32
    inside, the input's dtype out;
  - attention without a mask runs the flash kernel, reading q, k and v as
    strided views of the packed projection; with the additive mask of
    mask-attention pooling it runs `ops/attention.py::attention_masked`,
    plain PyTorch on every device, as the JAX package runs XLA there;
  - the dense protocol: the final block's value path (the V rows of the
    packed projection, no token mixing), `ln_post` on every patch token,
    `proj`, L2-normalize; RoI features v2 by 1x1 RoI-align on that map, v1
    by mask-attention pooling (one query a box, seeded from the CLS token,
    seeing the CLS token and the patches inside its box; nobody attends to
    a query), v3 both from one trunk pass;
  - module and parameter names follow the reference state dict
    (`visual.conv1.weight`, `visual.transformer.resblocks.{i}.attn.in_proj_weight`,
    `mlp.c_fc`, `ls_1.gamma`, ...), so `models/torch_io.py` loads reference
    and OpenAI checkpoints;
  - `grad_checkpointing` recomputes each block in the backward pass, as the
    EVA tower's does (the JAX tower takes `remat` and does not apply it;
    the results are the same either way);
  - under tensor parallelism (`parallel/tensor_parallel.py`) a rank holds
    its heads' rows of each third of `in_proj_weight` and its slice of the
    MLP's hidden width; `out_proj` and `c_proj` are row-parallel, the
    LayerNorms and the mask of mask-attention pooling (broadcast over the
    rank's heads) stay whole.

With `attentional_pool` (the CoCa towers) `attn_pool`, a
`models/common.py::AttentionalPooler` of `n_queries` queries in embed_dim
space, pools the trunk's tokens; `ln_post` then normalizes embed_dim and
`proj` is square (`forward_pooled`). The dense protocol assumes no pooler,
as the JAX tower's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipself_tpu_torch.core.config import VisionConfig
from clipself_tpu_torch.models.common import AttentionalPooler, LayerScale, gelu, l2_normalize
from clipself_tpu_torch.models.eva_vit import Dense, LayerNorm, _lecun_normal
from clipself_tpu_torch.ops.attention import multi_head_attention
from clipself_tpu_torch.ops.interpolate import resize_2d
from clipself_tpu_torch.ops.patchify import patchify
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1
from clipself_tpu_torch.parallel.tensor_parallel import TensorParallel

# the JAX tower's `_layer_norm` keeps flax's default epsilon
LN_EPS = 1e-5
# the additive mask's "never attend"
_NEG = -1e9


class Attention(nn.Module):
    """Self-attention with the packed q/k/v projection of
    `torch.nn.MultiheadAttention` (`in_proj_weight` [3W, W], `in_proj_bias`).
    ``heads`` and ``width`` are this rank's: all of them, or under tensor
    parallelism (``tp``, `parallel/tensor_parallel.py`) its share of the
    heads, whose q, k and v rows it holds; `out_proj` is then row-parallel."""

    tp: Optional[TensorParallel] = None

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Dense(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        b, n, _ = x.shape
        w = self.width
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        heads = (b, n, self.heads, w // self.heads)
        # strided views of the packed rows: the flash kernel reads them as they are
        q, k, v = (t.view(heads) for t in qkv.split(w, dim=-1))
        out = multi_head_attention(q, k, v, (w // self.heads) ** -0.5, mask)
        return self.out_proj(out.reshape(b, n, w))

    def value_path(self, x: torch.Tensor) -> torch.Tensor:
        """The V rows of the packed projection, then `out_proj`: the branch
        without token mixing (reference `proj_without_attn`)."""
        if self.tp is not None:
            x = self.tp.enter(x)
        w = self.width
        v = F.linear(x, self.in_proj_weight[2 * w:].to(x.dtype), self.in_proj_bias[2 * w:].to(x.dtype))
        return self.out_proj(v)


class Mlp(nn.Module):
    """The GELU MLP; under tensor parallelism (``tp``) this rank holds a
    slice of the hidden width and `c_proj` is row-parallel."""

    tp: Optional[TensorParallel] = None

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.quick_gelu = cfg.quick_gelu
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.c_fc = Dense(cfg.width, hidden)
        self.c_proj = Dense(hidden, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        return self.c_proj(gelu(self.c_fc(x), self.quick_gelu))


class CLIPBlock(nn.Module):
    """Pre-LN residual block (reference `ResidualAttentionBlock`)."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width, LN_EPS)
        self.attn = Attention(cfg.width, cfg.num_heads)
        self.ln_2 = LayerNorm(cfg.width, LN_EPS)
        self.mlp = Mlp(cfg)
        ls = cfg.ls_init_value
        self.ls_1 = LayerScale(cfg.width, ls) if ls is not None else None
        self.ls_2 = LayerScale(cfg.width, ls) if ls is not None else None

    @staticmethod
    def _scaled(y: torch.Tensor, ls: Optional[LayerScale]) -> torch.Tensor:
        return y if ls is None else ls(y)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + self._scaled(self.mlp(self.ln_2(x)), self.ls_2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self._scaled(self.attn(self.ln_1(x), mask), self.ls_1)
        return self._mlp(x)

    def forward_without_attn(self, x: torch.Tensor) -> torch.Tensor:
        """The value path (reference `ResidualAttentionBlockV2.proj_without_attn`,
        `transformer.py:247-260`); ls_1 / ls_2 wrap the branches as in the
        full forward."""
        x = x + self._scaled(self.attn.value_path(self.ln_1(x)), self.ls_1)
        return self._mlp(x)


class _Transformer(nn.Module):
    """Holds the blocks under the reference name `transformer.resblocks`."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(cfg) for _ in range(cfg.layers))


class OpenCLIPViT(nn.Module):
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
        w, p, base = cfg.width, cfg.patch_size, cfg.grid_size
        self.conv1 = nn.ParameterDict({"weight": nn.Parameter(torch.zeros(w, 3, p, p))})
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(base * base + 1, w))
        self.ln_pre = LayerNorm(w, LN_EPS)
        self.transformer = _Transformer(cfg)
        # the CoCa tower (reference `transformer.py:380-384`): the pooler's
        # queries live in embed_dim space, ln_post normalizes embed_dim and
        # the projection is square
        self.attn_pool = (
            AttentionalPooler(embed_dim, w, cfg.attn_pooler_heads, cfg.n_queries)
            if cfg.attentional_pool else None
        )
        out = embed_dim if cfg.attentional_pool else w
        self.ln_post = LayerNorm(out, LN_EPS)
        self.proj = nn.Parameter(torch.zeros(out, embed_dim))

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer.resblocks

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with the JAX tower's distributions:
        normal(width^-0.5) class and positional embeddings and projection,
        lecun-normal (truncated) patch and dense kernels, zero biases, unit
        LayerNorm scales, the LayerScale init value; the pooler's after the
        trunk's (`AttentionalPooler.init_weights`). Parameters must lie on
        the generator's device."""
        w = self.cfg.width
        conv = self.conv1["weight"]
        _lecun_normal(conv, conv[0].numel(), generator)
        for t in (self.class_embedding, self.positional_embedding):
            t.normal_(0.0, w ** -0.5, generator=generator)
        for blk in self.blocks:
            _lecun_normal(blk.attn.in_proj_weight, w, generator)
            blk.attn.in_proj_bias.zero_()
        for m in self.transformer.modules():
            if isinstance(m, Dense):
                _lecun_normal(m.weight, m.in_features, generator)
                m.bias.zero_()
        self.proj.normal_(0.0, w ** -0.5, generator=generator)
        if self.attn_pool is not None:
            self.attn_pool.init_weights(generator)

    # ---- embedding -----------------------------------------------------

    def _pos_embed(self, grid_hw: tuple[int, int]) -> torch.Tensor:
        """The positional embedding [1 + gh*gw, width], its grid
        bicubic-resized to the input's."""
        c = self.cfg
        base = c.grid_size
        gh, gw = grid_hw
        pe = self.positional_embedding
        if (gh, gw) == (base, base):
            return pe
        grid_pe = pe[1:].reshape(1, base, base, c.width).permute(0, 3, 1, 2)
        grid_pe = resize_2d(grid_pe, (gh, gw), method="bicubic")
        grid_pe = grid_pe[0].permute(1, 2, 0).reshape(gh * gw, c.width)
        return torch.cat([pe[:1], grid_pe], dim=0)

    def embed(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """Patchify [B, H, W, 3] -> tokens [B, 1 + gh*gw, width] with CLS
        and positions, through `ln_pre`."""
        c = self.cfg
        b = x.shape[0]
        t = patchify(x, self.conv1["weight"], None, self.dtype)
        gh, gw = t.shape[1], t.shape[2]
        t = t.reshape(b, gh * gw, c.width)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, c.width)
        t = torch.cat([cls, t], dim=1)
        t = t + self._pos_embed((gh, gw)).to(self.dtype)
        return self.ln_pre(t), (gh, gw)

    def _run(self, fn, *args) -> torch.Tensor:
        """Call a block; under `grad_checkpointing`, with gradients on, keep
        only its inputs and run it again in the backward pass."""
        if self.grad_checkpointing and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def _project(self, t: torch.Tensor) -> torch.Tensor:
        """`ln_post`, then `proj`, in the compute dtype."""
        t = self.ln_post(t)
        return t @ self.proj.to(t.dtype)

    def _dense_trunk(self, x: torch.Tensor):
        """(tokens entering the final block, grid) of one pass."""
        t, grid = self.embed(x)
        for blk in self.blocks[:-1]:
            t = self._run(blk, t)
        return t, grid

    # ---- public protocol -----------------------------------------------

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image embedding [B, embed_dim] (not normalized): the pooled half
        of `forward_pooled`."""
        return self.forward_pooled(x)[0]

    def forward_pooled(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(pooled [B, embed_dim], tokens), the reference forward with
        output_tokens (`clipself_tpu/models/open_clip_vit.py:204-221`): with
        the attentional pooler the trunk's tokens are pooled to n_queries,
        `ln_post` runs on all of them and (pooled, tokens) = (t[:, 0] @
        proj, t[:, 1:]) ([B, n_queries - 1, embed_dim]); without it `ln_post`
        runs on the CLS token alone and the tokens are the trunk's raw patch
        tokens [B, gh*gw, width]."""
        t, _ = self.embed(x)
        for blk in self.blocks:
            t = self._run(blk, t)
        if self.attn_pool is not None:
            t = self.ln_post(self.attn_pool(t))
            return t[:, 0] @ self.proj.to(t.dtype), t[:, 1:]
        return self._project(t[:, 0]), t[:, 1:]

    def forward_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The final-norm token sequence [B, 1 + gh*gw, width], CLS first."""
        t, _ = self.embed(x)
        for blk in self.blocks:
            t = self._run(blk, t)
        return self.ln_post(t)

    def encode_dense(self, x: torch.Tensor, keep_shape: bool = True) -> torch.Tensor:
        """Dense patch features: blocks[:-1], the final block's value path,
        `ln_post` + `proj` on the patch tokens, L2-normalize. Returns
        [B, gh, gw, C] if keep_shape else [B, gh*gw, C]."""
        t, (gh, gw) = self._dense_trunk(x)
        t = self._run(self.blocks[-1].forward_without_attn, t)
        tokens = l2_normalize(self._project(t[:, 1:]))
        return tokens.reshape(x.shape[0], gh, gw, -1) if keep_shape else tokens

    def extract_roi_features(
        self, x: torch.Tensor, normed_boxes: torch.Tensor, extract_type: str = "v2"
    ):
        """RoI features of ``normed_boxes`` [B, M, 4] (xyxy in [0, 1]):
        v2 [B, M, C] by 1x1 aligned RoI-align on the dense map; v1 [B, M, C]
        by mask-attention pooling (unnormalized); v3 the pair (v1, v2) of
        one trunk pass."""
        if extract_type == "v2":
            dense = self.encode_dense(x, keep_shape=True)
            _, gh, gw, _ = dense.shape
            return roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
        if extract_type not in ("v1", "v3"):
            raise NotImplementedError(extract_type)
        gh, gw = x.shape[1] // self.cfg.patch_size, x.shape[2] // self.cfg.patch_size
        masks = self.boxes_to_grid_masks(normed_boxes, gh, gw)
        if extract_type == "v1":
            return self.mask_attn_pool(x, masks)
        v1, dense = self.mask_attn_pool(x, masks, return_dense=True)
        v2 = roi_align_1x1(l2_normalize(dense), denormalize_boxes(normed_boxes, gh, gw))
        return v1, v2

    def encode_rois_and_image(self, x: torch.Tensor, normed_boxes: torch.Tensor):
        """(L2-normalized v2 RoI features [B, M, C], L2-normalized image
        embedding [B, C]) from one pass: the final block runs both ways on
        the same input."""
        t, (gh, gw) = self._dense_trunk(x)
        image = l2_normalize(self._project(self._run(self.blocks[-1], t)[:, 0]))
        td = self._run(self.blocks[-1].forward_without_attn, t)
        dense = l2_normalize(self._project(td[:, 1:])).reshape(x.shape[0], gh, gw, -1)
        rois = roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
        return l2_normalize(rois), image

    # ---- v1: mask-attention pooling --------------------------------------

    @staticmethod
    def boxes_to_grid_masks(normed_boxes: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        """[B, M, 4] normalized xyxy -> [B, M, gh, gw] binary float32 cell
        masks: corners scaled to the grid and truncated to integers select
        [y0, y1) x [x0, x1) (reference `_generate_masks_per_image`,
        `transformer.py:635-646`)."""
        scale = torch.tensor([gw, gh, gw, gh], dtype=torch.float32, device=normed_boxes.device)
        c = (normed_boxes.float() * scale).to(torch.int32)
        ys = torch.arange(gh, device=c.device)[:, None]
        xs = torch.arange(gw, device=c.device)[None, :]
        x0, y0, x1, y1 = (c[..., i, None, None] for i in range(4))
        return ((ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)).float()

    @staticmethod
    def attention_mask(masks: torch.Tensor) -> torch.Tensor:
        """The additive float32 mask [B, 1, N, N] of mask-attention pooling
        over the tokens [Q queries | CLS | patches] (N = Q + 1 + gh*gw) of
        ``masks`` [B, Q, gh, gw]: -1e9 on every query column, and on query
        q's row at the patches outside mask q; 0 elsewhere."""
        b, q = masks.shape[:2]
        n_img = masks.shape[2] * masks.shape[3]
        n_all = q + 1 + n_img
        attn = torch.zeros((b, n_all, n_all), dtype=torch.float32, device=masks.device)
        attn[:, :, :q] = _NEG  # nobody attends to the queries
        attn[:, :q, q + 1:] = torch.where(masks.reshape(b, q, n_img) > 0, 0.0, _NEG)
        return attn[:, None]  # broadcast over the heads

    def mask_attn_pool(self, image: torch.Tensor, masks: torch.Tensor, return_dense: bool = False):
        """Mask-attention pooling (reference `mask_attn_pool` +
        `_mask_attn_pool`, `transformer.py:736-834`) of ``masks`` [B, Q, gh,
        gw] (binary): [B, Q, embed_dim], unnormalized. An all-empty (padding)
        mask gives a query that sees the CLS token alone.

        The tokens are [Q queries | CLS | patches], each query a copy of the
        CLS token after `ln_pre`; under an additive float32 mask no token
        attends to a query (itself included) and query q sees the CLS token
        and the patches where mask q is 1. With ``return_dense`` also the
        unnormalized dense map [B, gh, gw, C] of the final block's value path
        over the patch tokens of the same trunk pass."""
        b, q = masks.shape[:2]
        t, (gh, gw) = self.embed(image)
        tokens = torch.cat([t[:, :1].expand(b, q, t.shape[-1]), t], dim=1)
        attn = self.attention_mask(masks)
        for blk in self.blocks[:-1]:
            tokens = self._run(blk, tokens, attn)
        out = self._run(self.blocks[-1], tokens, attn)
        pooled = self._project(out[:, :q])
        if not return_dense:
            return pooled
        td = self._run(self.blocks[-1].forward_without_attn, tokens)[:, q + 1:]
        return pooled, self._project(td).reshape(image.shape[0], gh, gw, -1)
