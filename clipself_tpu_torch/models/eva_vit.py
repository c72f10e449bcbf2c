"""EVA vision transformer with the dense-prediction protocol, in PyTorch.

A port of `clipself_tpu/models/eva_vit.py`: the EVA02 configurations
(pre-norm blocks, sub-LN q/k/v projections with an inner attention LN, SwiGLU
with `ffn_ln`, 2-D RoPE on the patch tokens) and the EVA01 / bigE variants
their flags select:

  - ``subln=False``: one fused `qkv` projection with the standalone `q_bias`
    and `v_bias` and no k bias, no inner attention LN and no `ffn_ln`;
  - ``naiveswiglu=False``: the exact-GELU `Mlp` (`fc1`, `fc2`);
  - ``rope=False``: the learned absolute pos-embed alone, no RoPE launch;
  - ``postnorm``: each branch's norm after its attention or MLP (bigE);
  - ``use_rel_pos_bias`` / ``use_shared_rel_pos_bias``: a learned BEiT
    relative-position bias, per block or one for all blocks, added to the
    logits as an additive mask, so that attention takes
    `ops/attention.py::attention_masked` (plain PyTorch), as the JAX package
    takes XLA there; the table fixes the resolution;
  - ``patch_dropout``: `forward` keeps a subset of the patch tokens when it
    is given a `torch.Generator` or the keep indices, and only then (the JAX
    tower drops only with a `patch_dropout` rng, which its trainer never
    gives); RoPE then rotates each kept token by its grid position
    (`models/rope.py::apply_rope_gathered`, plain PyTorch as in the JAX
    package).

The rest of the design:

  - parameters live in float32 and are cast to the compute dtype at each
    matmul, as flax `Dense(dtype=...)` does; LayerNorms compute in float32
    with the fast-variance association of the JAX tower and return the
    input's dtype (`ops/layer_norm.py`, a hand-written kernel on the card);
  - images are channels-last [B, H, W, 3], tokens [B, N, W];
  - module and parameter names follow the reference torch state dict
    (`visual.blocks.{i}.attn.q_proj.weight`, `q_bias`, ...), so
    `models/torch_io.py` loads reference checkpoints with `strict=True`;
  - RoPE and attention run the hand-written kernels of `ops/`; the sequence
    is never padded (the kernels mask the ragged 4097- and 197-token tails);
  - `grad_checkpointing` recomputes each block in the backward pass, the
    counterpart of the JAX tower's `remat`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipself_tpu_torch.core.config import VisionConfig
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.models.rope import apply_rope_flat_qk, apply_rope_gathered
from clipself_tpu_torch.ops.attention import multi_head_attention
from clipself_tpu_torch.ops.interpolate import resize_2d
from clipself_tpu_torch.ops.layer_norm import layer_norm
from clipself_tpu_torch.ops.patchify import patchify
from clipself_tpu_torch.ops.roi_align import denormalize_boxes, roi_align_1x1

def _trunc_normal(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """flax `truncated_normal(std)`: a normal cut at two standard deviations."""
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _lecun_normal(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax `lecun_normal`: variance 1/fan_in from a normal truncated at two
    standard deviations (0.8796 is the truncated unit normal's std)."""
    _trunc_normal(t, (1.0 / fan_in) ** 0.5 / 0.87962566103423978, generator)


class Dense(nn.Linear):
    """`nn.Linear` with float32 parameters, computed in the input's dtype.
    Built zero-filled; `EvaViT.init_weights` draws the weights."""

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """Row LayerNorm computed in float32 (fast variance,
    y = (x-mu)*(rstd*w)+b) and returned in x's dtype: one rounding of the
    float32 value, as the cast at the JAX tower's call sites."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def rel_pos_index(window: tuple[int, int]) -> tuple[np.ndarray, int]:
    """The BEiT relative-position index over a (wh, ww) grid plus CLS: the
    pairwise (dy, dx) offsets bucketed into a (2wh-1)(2ww-1) table, with
    three extra buckets for cls->token, token->cls and cls->cls. Returns
    ([wh*ww + 1, wh*ww + 1] int32, table rows); a copy of
    `clipself_tpu/models/eva_vit.py::_rel_pos_index`."""
    wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.array([wh - 1, ww - 1])
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    idx = np.zeros((wh * ww + 1, wh * ww + 1), np.int32)
    idx[1:, 1:] = rel[:, :, 0] * (2 * ww - 1) + rel[:, :, 1]
    idx[0, :] = num_rel - 3
    idx[:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx, num_rel


class _RelPos(nn.Module):
    """Holds a learned relative-position table under the reference name
    `relative_position_bias_table` [rows, heads] (zero at init) and its
    index as a buffer the state dict leaves out; `rel_pos_bias()` is the
    additive float32 bias [1, heads, N + 1, N + 1] over the config's
    grid."""

    def _init_rel_pos(self, cfg: VisionConfig) -> None:
        idx, num_rel = rel_pos_index((cfg.grid_size, cfg.grid_size))
        self.relative_position_bias_table = nn.Parameter(torch.zeros(num_rel, cfg.num_heads))
        self.register_buffer(
            "relative_position_index", torch.from_numpy(idx.reshape(-1).astype(np.int64)), persistent=False
        )

    def rel_pos_bias(self) -> torch.Tensor:
        n1 = int(round(self.relative_position_index.numel() ** 0.5))
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.reshape(n1, n1, -1).permute(2, 0, 1)[None]


def _check_window(bias: torch.Tensor, n: int) -> None:
    if bias.shape[-1] != n:
        raise ValueError(
            f"rel-pos-bias window {bias.shape[-1]} != sequence {n}; rel-pos models are "
            "fixed-resolution (resize the table at checkpoint load for other input sizes)"
        )


class RelPosBias(_RelPos):
    """The bias shared by every block (`visual.rel_pos_bias`)."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self._init_rel_pos(cfg)

    def forward(self) -> torch.Tensor:
        return self.rel_pos_bias()


class EvaAttention(_RelPos):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        if cfg.subln:
            self.q_proj = Dense(w, w, bias=False)
            self.k_proj = Dense(w, w, bias=False)
            self.v_proj = Dense(w, w, bias=False)
        else:
            self.qkv = Dense(w, 3 * w, bias=False)
        # the reference keeps the q/v biases as standalone parameters
        self.q_bias = nn.Parameter(torch.zeros(w)) if cfg.qkv_bias else None
        self.v_bias = nn.Parameter(torch.zeros(w)) if cfg.qkv_bias else None
        self.inner_attn_ln = LayerNorm(w, cfg.ln_eps) if cfg.subln else None
        self.proj = Dense(w, w)
        if cfg.use_rel_pos_bias:  # the reference keeps it on the attention
            self._init_rel_pos(cfg)

    def _v(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.subln:
            v = self.v_proj(x)
        else:  # the V rows of the fused projection
            w = self.cfg.width
            v = F.linear(x, self.qkv.weight[2 * w:].to(x.dtype))
        return v if self.v_bias is None else v + self.v_bias.to(v.dtype)

    def _qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.cfg.subln:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        else:  # strided views of the fused rows
            q, k, v = self.qkv(x).split(self.cfg.width, dim=-1)
        if self.q_bias is not None:
            q = q + self.q_bias.to(q.dtype)
            v = v + self.v_bias.to(v.dtype)
        return q, k, v

    def forward(
        self,
        x: torch.Tensor,
        grid_hw: tuple[int, int],
        bias: Optional[torch.Tensor] = None,
        pos_idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``bias``: the shared rel-pos bias or None; ``pos_idx`` [B, K]:
        the grid positions of the patch tokens that patch dropout kept."""
        c = self.cfg
        b, n, w = x.shape
        q, k, v = self._qkv(x)
        heads = (b, n, c.num_heads, c.head_width)
        gh, gw = grid_hw
        if c.rope and pos_idx is not None:
            q, k = (
                torch.cat([t[:, :1], apply_rope_gathered(t[:, 1:], pos_idx, gh, gw, c.pt_hw_seq_len)], 1)
                for t in (q.view(heads), k.view(heads))
            )
        elif c.rope:
            q, k = apply_rope_flat_qk(q.contiguous(), k.contiguous(), gh, gw, c.head_width, 1, c.pt_hw_seq_len)
        mask = bias
        if c.use_rel_pos_bias:
            own = self.rel_pos_bias()
            _check_window(own, n)
            mask = own if mask is None else mask + own
        out = multi_head_attention(
            q.view(heads), k.view(heads), v.view(heads), c.head_width ** -0.5, mask
        ).reshape(b, n, w)
        if self.inner_attn_ln is not None:
            out = self.inner_attn_ln(out)
        return self.proj(out)

    def value_path(self, x: torch.Tensor) -> torch.Tensor:
        """The attention branch without token mixing: v-projection, inner LN
        and output projection (reference `proj_without_attn`)."""
        v = self._v(x)
        if self.inner_attn_ln is not None:
            v = self.inner_attn_ln(v)
        return self.proj(v)


class SwiGLU(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.w1 = Dense(cfg.width, hidden)
        self.w2 = Dense(cfg.width, hidden)
        self.ffn_ln = LayerNorm(hidden, cfg.ln_eps) if cfg.subln else None
        self.w3 = Dense(hidden, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.w1(x)) * self.w2(x)
        return self.w3(h if self.ffn_ln is None else self.ffn_ln(h))


class Mlp(nn.Module):
    """The exact-GELU MLP of the EVA01-style configs (no naiveswiglu)."""

    def __init__(self, cfg: VisionConfig):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.fc1 = Dense(cfg.width, hidden)
        self.ffn_ln = LayerNorm(hidden, cfg.ln_eps) if cfg.subln else None
        self.fc2 = Dense(hidden, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fc1(x))
        return self.fc2(h if self.ffn_ln is None else self.ffn_ln(h))


class EvaBlock(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.postnorm = cfg.postnorm
        self.norm1 = LayerNorm(cfg.width, cfg.ln_eps)
        self.attn = EvaAttention(cfg)
        self.norm2 = LayerNorm(cfg.width, cfg.ln_eps)
        self.mlp = SwiGLU(cfg) if cfg.naiveswiglu else Mlp(cfg)
        if cfg.ls_init_value is not None:
            self.gamma_1 = nn.Parameter(torch.full((cfg.width,), float(cfg.ls_init_value)))
            self.gamma_2 = nn.Parameter(torch.full((cfg.width,), float(cfg.ls_init_value)))
        else:
            self.gamma_1 = self.gamma_2 = None

    @staticmethod
    def _scaled(y: torch.Tensor, gamma: Optional[torch.Tensor]) -> torch.Tensor:
        return y if gamma is None else y * gamma.to(y.dtype)

    def _branch(self, x: torch.Tensor, fn, norm: nn.Module, gamma) -> torch.Tensor:
        """x + gamma * fn(norm(x)), or with postnorm x + gamma * norm(fn(x))."""
        y = norm(fn(x)) if self.postnorm else fn(norm(x))
        return x + self._scaled(y, gamma)

    def forward(
        self,
        x: torch.Tensor,
        grid_hw: tuple[int, int],
        bias: Optional[torch.Tensor] = None,
        pos_idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x = self._branch(x, lambda t: self.attn(t, grid_hw, bias, pos_idx), self.norm1, self.gamma_1)
        return self._branch(x, self.mlp, self.norm2, self.gamma_2)

    def forward_without_attn(self, x: torch.Tensor) -> torch.Tensor:
        """Final-block value path (reference `forward_without_attn`)."""
        x = self._branch(x, self.attn.value_path, self.norm1, self.gamma_1)
        return self._branch(x, self.mlp, self.norm2, self.gamma_2)


class PatchEmbed(nn.Module):
    """Holds the OIHW patch-embedding weight and bias under the reference
    names `patch_embed.proj.{weight,bias}`; computed as reshape + matmul
    (`ops/patchify.py`)."""

    def __init__(self, width: int, patch_size: int):
        super().__init__()
        self.proj = nn.ParameterDict(
            {
                "weight": nn.Parameter(torch.zeros(width, 3, patch_size, patch_size)),
                "bias": nn.Parameter(torch.zeros(width)),
            }
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return patchify(x, self.proj["weight"], self.proj["bias"], dtype)


class EvaViT(nn.Module):
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
        base = cfg.grid_size
        self.patch_embed = PatchEmbed(cfg.width, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, base * base + 1, cfg.width))
        self.blocks = nn.ModuleList(EvaBlock(cfg) for _ in range(cfg.layers))
        self.norm = LayerNorm(cfg.width, cfg.ln_eps)
        self.head = Dense(cfg.width, embed_dim)
        # one table for every block (reference `eva_vit_model.py:423-424`)
        self.rel_pos_bias = RelPosBias(cfg) if cfg.use_shared_rel_pos_bias else None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw the initial weights with the JAX tower's distributions:
        truncated normal(0.02) for cls_token/pos_embed, lecun-normal
        (truncated) kernels, zero biases, unit LayerNorm scales. Parameters
        must lie on the generator's device."""
        _trunc_normal(self.cls_token, 0.02, generator)
        _trunc_normal(self.pos_embed, 0.02, generator)
        w = self.patch_embed.proj["weight"]
        _lecun_normal(w, w[0].numel(), generator)
        self.patch_embed.proj["bias"].zero_()
        for m in self.modules():
            if isinstance(m, Dense):
                _lecun_normal(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()

    def _resized_pos_embed(self, grid_hw: tuple[int, int]) -> torch.Tensor:
        """Bicubic-resize the absolute pos-embed grid to the input grid."""
        c = self.cfg
        base = c.grid_size
        gh, gw = grid_hw
        pe = self.pos_embed
        if (gh, gw) == (base, base):
            return pe
        grid_pe = pe[:, 1:].reshape(1, base, base, c.width).permute(0, 3, 1, 2)
        grid_pe = resize_2d(grid_pe, (gh, gw), method="bicubic")
        grid_pe = grid_pe.permute(0, 2, 3, 1).reshape(1, gh * gw, c.width)
        return torch.cat([pe[:, :1], grid_pe], dim=1)

    def embed(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """Patchify [B, H, W, 3] -> tokens [B, 1 + gh*gw, width] with CLS+pos."""
        c = self.cfg
        b = x.shape[0]
        t = self.patch_embed(x, self.dtype)
        gh, gw = t.shape[1], t.shape[2]
        t = t.reshape(b, gh * gw, c.width)
        cls = self.cls_token.to(self.dtype).expand(b, 1, c.width)
        t = torch.cat([cls, t], dim=1)
        t = t + self._resized_pos_embed((gh, gw)).to(self.dtype)
        return t, (gh, gw)

    def _run(self, fn, *args) -> torch.Tensor:
        """Call a block; under `grad_checkpointing`, with gradients on, keep
        only its inputs and run it again in the backward pass."""
        if self.grad_checkpointing and torch.is_grad_enabled():
            # the blocks draw no random numbers: no generator state to keep
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def _shared_bias(self, n: int) -> Optional[torch.Tensor]:
        """The shared rel-pos bias for a sequence of ``n`` tokens, or None
        (computed once a pass and handed to every block)."""
        if self.rel_pos_bias is None:
            return None
        bias = self.rel_pos_bias()
        _check_window(bias, n)
        return bias

    def _patch_dropout(self, t: torch.Tensor, keep) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Keep a subset of the patch tokens (the CLS token always), as the
        JAX tower's `_patch_dropout` (reference `PatchDropout`). ``keep``:
        None (no drop), a `torch.Generator` (the first max(1, int(N * (1 -
        patch_dropout))) positions of an argsort of uniform noise, as the
        JAX tower draws them from its rng), or the keep indices [B, K].
        Returns (tokens, keep indices or None)."""
        if self.cfg.patch_dropout <= 0.0 or keep is None:
            return t, None
        b, n1, w = t.shape
        if isinstance(keep, torch.Generator):
            n = n1 - 1
            k = max(1, int(n * (1.0 - self.cfg.patch_dropout)))
            noise = torch.rand((b, n), generator=keep, device=keep.device)
            keep = torch.argsort(noise, dim=-1)[:, :k]
        keep = keep.to(t.device)
        patches = torch.gather(t[:, 1:], 1, keep[..., None].expand(-1, -1, w))
        return torch.cat([t[:, :1], patches], dim=1), keep

    def forward(self, x: torch.Tensor, patch_keep=None) -> torch.Tensor:
        """Image embedding from the CLS token [B, embed_dim]; ``patch_keep``
        (a generator or keep indices, see `_patch_dropout`) drops patch
        tokens where the config sets `patch_dropout`."""
        return self.head(self.norm(self._trunk(x, patch_keep)[:, 0]))

    def _trunk(self, x: torch.Tensor, patch_keep) -> torch.Tensor:
        """Every block's output [B, 1 + K, width] over the embedded (and,
        with ``patch_keep``, dropped) tokens, before the final norm."""
        t, grid = self.embed(x)
        t, pos_idx = self._patch_dropout(t, patch_keep)
        bias = self._shared_bias(t.shape[1])
        for blk in self.blocks:
            t = self._run(blk, t, grid, bias, pos_idx)
        return t

    def forward_tokens(self, x: torch.Tensor, patch_keep=None) -> torch.Tensor:
        """The final-norm token sequence [B, 1 + K, width], CLS first, for
        the CoCa consumers (`clipself_tpu/models/eva_vit.py:573-586`): patch
        dropout applies here as on the global-embedding path (K = gh*gw
        without it)."""
        return self.norm(self._trunk(x, patch_keep))

    def forward_pooled(self, x: torch.Tensor, patch_keep=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(pooled [B, embed_dim], tokens [B, K, width]): the projected CLS
        embedding and the final-norm patch tokens, the EVA analogue of the
        ViT's output_tokens path (`clipself_tpu/models/eva_vit.py:588-596`),
        for a CoCa built over an EVA tower."""
        t = self.forward_tokens(x, patch_keep)
        return self.head(t[:, 0]), t[:, 1:]

    def encode_dense(self, x: torch.Tensor, keep_shape: bool = True) -> torch.Tensor:
        """Dense patch features: blocks[:-1], the final block without
        attention, drop CLS, norm + head, L2-normalize. Returns
        [B, gh, gw, C] if keep_shape else [B, gh*gw, C]."""
        t, (gh, gw) = self.embed(x)
        bias = self._shared_bias(t.shape[1])
        for blk in self.blocks[:-1]:
            t = self._run(blk, t, (gh, gw), bias)
        t = self._run(self.blocks[-1].forward_without_attn, t)[:, 1:]
        t = self.head(self.norm(t))
        t = l2_normalize(t)
        return t.reshape(x.shape[0], gh, gw, -1) if keep_shape else t

    def forward_taps(
        self, x: torch.Tensor, out_indices: tuple[int, ...], with_dense: bool = False
    ) -> tuple[list[torch.Tensor], Optional[torch.Tensor]]:
        """Intermediate block outputs for detection backbones, one trunk pass
        (`clipself_tpu/models/eva_vit.py::forward_taps`, the reference F-ViT
        backbone protocol): blocks 0..N-2 run normally and are tapped at
        ``out_indices``; the final block runs WITHOUT attention (value path),
        and if index N-1 is requested its tap is that value-path output. With
        ``with_dense`` also the L2-normalized dense VLM map (norm + head over
        the value-path tokens).

        Returns ([B, gh, gw, width] per tap, dense [B, gh, gw, embed] | None)."""
        t, (gh, gw) = self.embed(x)
        b, width = x.shape[0], self.cfg.width

        def to_map(tokens):
            return tokens[:, 1:].reshape(b, gh, gw, width)

        taps = []
        bias = self._shared_bias(t.shape[1])
        for i, blk in enumerate(self.blocks[:-1]):
            t = self._run(blk, t, (gh, gw), bias)
            if i in out_indices:
                taps.append(to_map(t))
        t = self._run(self.blocks[-1].forward_without_attn, t)
        if (len(self.blocks) - 1) in out_indices:
            taps.append(to_map(t))
        dense = None
        if with_dense:
            dense = l2_normalize(self.head(self.norm(t[:, 1:]))).reshape(b, gh, gw, -1)
        return taps, dense

    def extract_roi_features(
        self, x: torch.Tensor, normed_boxes: torch.Tensor, extract_type: str = "v2"
    ) -> torch.Tensor:
        """RoI features [B, M, C] by 1x1 aligned RoI-align over the dense map;
        ``normed_boxes`` [B, M, 4] xyxy in [0, 1], padded rows allowed
        (`clipself_tpu/models/eva_vit.py:620-634`). The tower has one RoI
        path: ``extract_type`` is ignored, as the reference ignores it
        (`eva_vit_model.py:625`)."""
        dense = self.encode_dense(x, keep_shape=True)
        _, gh, gw, _ = dense.shape
        return roi_align_1x1(dense, denormalize_boxes(normed_boxes, gh, gw))
