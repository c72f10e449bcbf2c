"""CoCa, the contrastive captioner, in PyTorch: a port of
`clipself_tpu/models/coca.py` (reference `src/open_clip/coca_model.py`,
`transformer.py:163-186, :1018-1106`, `generation_utils.py`).

  - the vision tower: the OpenCLIP ViT with the attentional pooler
    (`forward_pooled`: the first pooled token is the image embedding, the
    others the caption's image tokens), or without it (the CLS embedding
    and the raw patch tokens), or an EVA tower (the projected CLS and the
    final-norm patch tokens), as the JAX package builds it;
  - the text tower with `embed_cls` (`TextTransformer.forward_coca`), or an
    HF text tower (`models/hf_text.py::HFTextTower.forward_tokens`: the
    projected pooled feature and the trunk's per-token hidden states,
    without the CLS slot under `cls_pooler`), as
    `clipself_tpu/models/coca.py:178-186, :203-215` routes it;
  - the multimodal decoder: a layer is one causal self-attention block (the
    text tower's `TextBlock` through a `TextConfig` view of the decoder's
    hyperparameters) and one cross-attention block with its own MLP; the
    final LN; the projection to the vocabulary. Module and parameter names
    follow the reference state dict (`text_decoder.resblocks.{i}`,
    `text_decoder.cross_attn.{i}.attn.in_proj_weight`, ...);
  - attention: the decoder's self blocks and the text tower take the plain
    causal `attention_masked`, the cross blocks and the pooler the plain
    cross route of `ops/attention.py::multi_head_attention` (the JAX
    package runs XLA for all of them); the vision trunk's self-attention
    takes the flash kernels; every LayerNorm the LayerNorm kernel.

Generation keeps the JAX semantics: a fixed [B, max_len] token buffer,
decoded whole at each position (the vision tower runs once); processors and
warpers act on the raw logits and the temperature scales only the final
sampling; the last slot is forced to EOT; a sampled pad or EOT ends its row.
Sampling is Gumbel-max, argmax(logits / T + g), which is what
`jax.random.categorical` computes; g is drawn from a `torch.Generator`, or
given (`noise`), so that a test can hand in the JAX key's own draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clipself_tpu_torch.core.config import CLIPConfig, MultimodalConfig, TextConfig
from clipself_tpu_torch.models.common import gelu, l2_normalize
from clipself_tpu_torch.models.eva_vit import Dense, EvaViT, LayerNorm, _lecun_normal
from clipself_tpu_torch.models.hf_text import HFTextTower
from clipself_tpu_torch.models.open_clip_vit import OpenCLIPViT
from clipself_tpu_torch.models.text_transformer import TextBlock, TextTransformer
from clipself_tpu_torch.ops.attention import multi_head_attention
from clipself_tpu_torch.train.contrastive import clip_loss


def _text_view(c: MultimodalConfig) -> TextConfig:
    """The decoder's hyperparameters as the `TextConfig` of its self blocks."""
    return TextConfig(
        context_length=c.context_length, vocab_size=c.vocab_size, width=c.width, heads=c.heads,
        layers=c.layers, ls_init_value=c.ls_init_value, quick_gelu=c.quick_gelu, ln_eps=c.ln_eps,
    )


class _CrossAttention(nn.Module):
    """The packed projection of `torch.nn.MultiheadAttention`
    (`in_proj_weight` [3W, W], `in_proj_bias`), its thirds applied to the
    query stream and the key / value stream apart."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Dense(width, width)


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int, quick_gelu: bool):
        super().__init__()
        self.quick_gelu = quick_gelu
        self.c_fc = Dense(width, hidden)
        self.c_proj = Dense(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(gelu(self.c_fc(x), self.quick_gelu))


class CrossAttnBlock(nn.Module):
    """Cross-attention residual block (reference `ResidualAttentionBlock`
    with is_cross_attention, `transformer.py:189-245`): q from ln_1(x), k and
    v from ln_1_kv(kv), then `out_proj`, and an MLP of its own."""

    def __init__(self, c: MultimodalConfig):
        super().__init__()
        self.cfg = c
        self.ln_1 = LayerNorm(c.width, c.ln_eps)
        self.ln_1_kv = LayerNorm(c.width, c.ln_eps)
        self.attn = _CrossAttention(c.width)
        self.ln_2 = LayerNorm(c.width, c.ln_eps)
        self.mlp = _Mlp(c.width, int(c.width * c.mlp_ratio), c.quick_gelu)

    def forward(self, x: torch.Tensor, kv: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The residual stream keeps x's dtype; the branches compute in
        ``dtype``, as `TextBlock` does."""
        c, a = self.cfg, self.attn
        b, n, w = x.shape
        h = c.heads
        y, kx = self.ln_1(x).to(dtype), self.ln_1_kv(kv).to(dtype)
        wq, wk, wv = a.in_proj_weight.to(dtype).split(w)
        bq, bk, bv = a.in_proj_bias.to(dtype).split(w)
        out = multi_head_attention(
            F.linear(y, wq, bq).reshape(b, n, h, w // h),
            F.linear(kx, wk, bk).reshape(b, -1, h, w // h),
            F.linear(kx, wv, bv).reshape(b, -1, h, w // h),
            (w // h) ** -0.5,
        )
        x = x + a.out_proj(out.reshape(b, n, w))
        return x + self.mlp(self.ln_2(x).to(dtype))


class MultimodalDecoder(nn.Module):
    """Reference `MultimodalTransformer` (`transformer.py:1018-1106`): per
    layer a causal self block then a cross block, the final LN, and the
    projection to the vocabulary. The blocks' branches and the projection
    compute in ``dtype``; the residual stream keeps the dtype of the token
    stream it starts from (an HF text tower's float32 hidden states stay
    float32 in a bf16 model, as the JAX decoder's promotion keeps them)."""

    def __init__(self, c: MultimodalConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if c.mlp_ratio != 4.0:
            raise NotImplementedError("multimodal mlp_ratio != 4 (no shipped reference config uses it)")
        self.cfg = c
        tc = _text_view(c)
        self.resblocks = nn.ModuleList(TextBlock(tc) for _ in range(c.layers))
        self.cross_attn = nn.ModuleList(CrossAttnBlock(c) for _ in range(c.layers))
        self.ln_final = LayerNorm(c.width, c.ln_eps)
        self.text_projection = nn.Parameter(torch.zeros(c.width, c.vocab_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX decoder's initial distributions: lecun-normal (truncated)
        kernels (each third of a packed projection has fan-in width) with
        zero biases, unit LayerNorm scales, normal(width^-0.5) projection."""
        w = self.cfg.width
        for blk in list(self.resblocks) + list(self.cross_attn):
            _lecun_normal(blk.attn.in_proj_weight, w, generator)
            blk.attn.in_proj_bias.zero_()
        for m in self.modules():
            if isinstance(m, Dense):
                _lecun_normal(m.weight, m.in_features, generator)
                m.bias.zero_()
        self.text_projection.normal_(0.0, w ** -0.5, generator=generator)

    def forward(self, image_embs: torch.Tensor, text_embs: torch.Tensor) -> torch.Tensor:
        """Logits [B, n, vocab] of the token stream ``text_embs`` [B, n, W]
        over the image tokens ``image_embs`` [B, M, W]."""
        n = text_embs.shape[1]
        causal = torch.triu(torch.full((n, n), float("-inf"), device=text_embs.device), diagonal=1)
        x = text_embs
        for blk, cross in zip(self.resblocks, self.cross_attn):
            x = cross(blk(x, causal[None, None], self.dtype), image_embs, self.dtype)
        x = self.ln_final(x).to(self.dtype)
        return x @ self.text_projection.to(self.dtype)


class CoCa(nn.Module):
    """The contrastive captioner (reference `CoCa`, `coca_model.py:80-166`):
    `visual`, `text`, `text_decoder` and `logit_scale`, the roots of the
    reference state dict."""

    def __init__(
        self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False
    ):
        super().__init__()
        if cfg.multimodal is None:
            raise ValueError("CoCa needs a multimodal config")
        v = cfg.vision
        if v.resnet_layers:
            raise NotImplementedError(
                "CoCa needs a token-sequence vision tower; ResNet towers have "
                "no token stream (as in the reference)"
            )
        self.cfg = cfg
        tower = EvaViT if v.eva_model_name else OpenCLIPViT
        self.visual = tower(v, cfg.embed_dim, dtype, grad_checkpointing)
        text = HFTextTower if cfg.text.hf_model_name else TextTransformer
        self.text = text(cfg.text, cfg.embed_dim, dtype)
        self.text_decoder = MultimodalDecoder(cfg.multimodal, dtype)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    @property
    def pad_id(self) -> int:
        return self.cfg.text.pad_id

    def init_weights(self, generator: torch.Generator) -> None:
        """Each part's initial draw from ``generator``: the visual tower,
        the text tower, the decoder."""
        self.visual.init_weights(generator)
        self.text.init_weights(generator)
        self.text_decoder.init_weights(generator)

    def _encode_image(self, image: torch.Tensor, normalize: bool = True):
        """(image latent [B, E], image tokens [B, M, W]), reference
        `_encode_image` (`coca_model.py:131-134`)."""
        pooled, tokens = self.visual.forward_pooled(image)
        return (l2_normalize(pooled) if normalize else pooled), tokens

    def _encode_text(self, text: torch.Tensor, normalize: bool = True, embed_cls: bool = True):
        """(text latent [B, E], token stream [B, L, W]), reference
        `_encode_text` (`coca_model.py:136-139`): with ``embed_cls`` the ids
        lose their last slot to make room for the CLS token (an HF tower's
        too, as in the JAX package)."""
        text = text[:, :-1] if embed_cls else text
        if isinstance(self.text, HFTextTower):
            pooled, tokens = self.text.forward_tokens(text)
        else:
            pooled, tokens = self.text.forward_coca(text)
        return (l2_normalize(pooled) if normalize else pooled), tokens

    def encode_image(self, image: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        return self._encode_image(image, normalize=normalize)[0]

    def encode_text(self, text: torch.Tensor, normalize: bool = True, embed_cls: bool = True) -> torch.Tensor:
        return self._encode_text(text, normalize=normalize, embed_cls=embed_cls)[0]

    def decode_text(self, img_tokens: torch.Tensor, text: torch.Tensor, embed_cls: bool = False) -> torch.Tensor:
        """Caption logits [B, L, V] given the image tokens: the body of a
        generation step."""
        _, token_embs = self._encode_text(text, embed_cls=embed_cls)
        return self.text_decoder(img_tokens, token_embs)

    def forward(self, image: torch.Tensor, text: torch.Tensor, embed_cls: bool = True) -> dict:
        """image [B, H, W, 3], text [B, L] ids -> the reference's output
        dict: normalized image and text features, the caption logits, the
        labels (the last L' ids, L' the logits' length) and
        exp(logit_scale)."""
        text_latent, token_embs = self._encode_text(text, embed_cls=embed_cls)
        image_latent, image_embs = self._encode_image(image)
        return {
            "image_features": image_latent,
            "text_features": text_latent,
            "logits": self.text_decoder(image_embs, token_embs),
            "labels": text[:, -token_embs.shape[1]:],
            "logit_scale": self.logit_scale.exp(),
        }


def coca_loss(
    out: dict, text: Optional[torch.Tensor] = None, caption_weight: float = 2.0,
    contrastive_weight: float = 1.0, pad_id: int = 0,
):
    """The contrastive loss plus the shifted caption cross-entropy over the
    non-pad labels (reference `CoCaLoss`, `src/open_clip/loss.py:134-173`);
    ``text`` defaults to out["labels"]. Returns (loss, {contrastive_loss,
    caption_loss})."""
    con = clip_loss(out["image_features"], out["text_features"], out["logit_scale"])
    labels = out["labels"] if text is None else text[:, -out["logits"].shape[1]:]
    logits, labels = out["logits"][:, :-1], labels[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = (labels != pad_id).float()
    cap = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return contrastive_weight * con + caption_weight * cap, {"contrastive_loss": con, "caption_loss": cap}


def _apply_processors(
    logits: torch.Tensor, tokens: torch.Tensor, pos: int, eot_id: int, pad_id: int, min_len: int,
    repetition_penalty: float,
) -> torch.Tensor:
    """The min-length and repetition-penalty processors
    (`clipself_tpu/models/coca.py::_apply_processors`, the reference's HF
    `MinLengthLogitsProcessor` and `RepetitionPenaltyLogitsProcessor`):
    ``logits`` [B, V] float32, ``tokens`` [B, L] the buffer, positions from
    ``pos`` on its pad fill. Before ``min_len`` EOT is set to -1e9; a token
    generated before ``pos`` (the pad id too: it is a real BPE token) has a
    positive logit divided by the penalty and a negative one multiplied."""
    v = logits.shape[-1]
    vocab = torch.arange(v, device=logits.device)[None, :]
    if min_len > 1:
        logits = torch.where((pos < min_len) & (vocab == eot_id), -1e9, logits)
    if repetition_penalty != 1.0:
        b, length = tokens.shape
        slot = torch.where(torch.arange(length, device=tokens.device)[None, :] < pos, tokens.long(), v)
        seen = torch.zeros((b, v + 1), dtype=torch.bool, device=logits.device)
        seen = seen.scatter(1, slot, True)[:, :v]
        penalized = torch.where(logits > 0, logits / repetition_penalty, logits * repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    return logits


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1), as
    `jax.random.gumbel` forms them."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def _start_tokens(shape, sot_id: int, pad_id: int, device) -> torch.Tensor:
    tokens = torch.full(shape, pad_id, dtype=torch.long, device=device)
    tokens[..., 0] = sot_id
    return tokens


@torch.no_grad()
def generate(
    model: CoCa,
    image: torch.Tensor,
    sot_id: int,
    eot_id: int,
    max_len: int = 77,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    min_len: int = 1,
    repetition_penalty: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Caption tokens [B, max_len] (`clipself_tpu/models/coca.py::generate`,
    reference `CoCa.generate`, `coca_model.py:232-343`): greedy when top_k
    and top_p are 0, else top-k or nucleus (top-p) sampling. The decoder
    reads the whole buffer with embed_cls False at each position, as the
    reference's loop does. Sampling draws Gumbel noise from ``generator``
    (one draw of [B, V] a position, a generator seeded 0 on the image's
    device by default), or takes ``noise`` [max_len - 1, B, V], the draws of
    positions 1 .. max_len - 1."""
    b, pad_id = image.shape[0], model.pad_id
    tokens = _start_tokens((b, max_len), sot_id, pad_id, image.device)
    _, img_tokens = model._encode_image(image)
    done = torch.zeros(b, dtype=torch.bool, device=image.device)
    sampling = top_p > 0.0 or top_k > 0
    if sampling and noise is None and generator is None:
        generator = torch.Generator(device=image.device).manual_seed(0)
    for pos in range(1, max_len):
        logits = model.decode_text(img_tokens, tokens)[:, pos - 1].float()
        logits = _apply_processors(logits, tokens, pos, eot_id, pad_id, min_len, repetition_penalty)
        if top_p > 0.0:
            # HF TopPLogitsWarper: the smallest prefix of the sorted
            # probabilities holding at least top_p of the mass (>= 1 token)
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sorted_logits, dim=-1)
            keep = torch.cumsum(probs, dim=-1) - probs < top_p
            kth = torch.where(keep, sorted_logits, float("inf")).min(dim=-1).values
            logits = torch.where(logits < kth[:, None], -1e9, logits)
        elif top_k > 0:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, -1e9, logits)
        if sampling:
            if noise is None:
                g = gumbel(logits.shape, generator, logits.device)
            else:
                g = noise[pos - 1].to(logits.device)
            nxt = torch.argmax(g + logits / max(temperature, 1e-6), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        if pos == max_len - 1:  # the final slot terminates the caption
            nxt = torch.full_like(nxt, eot_id)
        nxt = torch.where(done, pad_id, nxt)
        tokens[:, pos] = nxt
        # a sampled pad also ends the row, with no EOT appended
        done = done | (nxt == eot_id) | (nxt == pad_id)
    return tokens


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` on the last axis: the k largest values, ties in
    index order (a stable descending sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(
    model: CoCa,
    image: torch.Tensor,
    sot_id: int,
    eot_id: int,
    max_len: int = 77,
    num_beams: int = 6,
    num_beam_groups: int = 1,
    min_len: int = 1,
    repetition_penalty: float = 1.0,
    length_penalty: float = 1.0,
) -> torch.Tensor:
    """The best beam's tokens [B, max_len] (`clipself_tpu/models/coca.py::
    beam_search`, reference `_generate_beamsearch`, `coca_model.py:289-343`).
    The ``num_beams`` beams of an image form ``num_beam_groups`` groups of
    independent searches (the first beam of a group starts at score 0, the
    others at -1e9); a finished beam stays in the pool, extending with pad
    at no cost, so a position is one top-k over [B, group, beams * V]; an
    unfinished beam takes EOT in the final slot. The best of all is chosen
    by cumulative log-probability / generated length ** length_penalty."""
    if num_beams % num_beam_groups:
        raise ValueError("num_beams must divide into groups")
    b, k, g = image.shape[0], num_beams, num_beam_groups
    sub, pad_id, dev = k // g, model.pad_id, image.device
    tokens = _start_tokens((b, k, max_len), sot_id, pad_id, dev)
    scores = torch.where(torch.arange(k, device=dev) % sub == 0, 0.0, -1e9).expand(b, k).clone()
    _, img_tokens = model._encode_image(image)
    img_tokens = img_tokens.repeat_interleave(k, dim=0)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    lens = torch.ones((b, k), dtype=torch.long, device=dev)
    bi = torch.arange(b, device=dev)[:, None]
    for pos in range(1, max_len):
        logits = model.decode_text(img_tokens, tokens.reshape(b * k, max_len))[:, pos - 1].float()
        v = logits.shape[-1]
        logp = _apply_processors(
            torch.log_softmax(logits, dim=-1), tokens.reshape(b * k, max_len), pos, eot_id, pad_id,
            min_len, repetition_penalty,
        ).reshape(b, k, v)
        pad_only = torch.where(torch.arange(v, device=dev) == pad_id, 0.0, float("-inf"))
        logp = torch.where(done[..., None], pad_only, logp)
        cand = (scores[..., None] + logp).reshape(b, g, sub * v)
        top_scores, top_idx = _top_k_stable(cand, sub)  # [B, G, sub]
        src = (top_idx // v + (torch.arange(g, device=dev) * sub)[None, :, None]).reshape(b, k)
        token_idx = (top_idx % v).reshape(b, k)
        scores = top_scores.reshape(b, k)
        tokens = tokens[bi, src]
        was_done = done[bi, src]
        if pos == max_len - 1:
            token_idx = torch.where(was_done, token_idx, eot_id)
        tokens[:, :, pos] = token_idx
        done = was_done | (token_idx == eot_id)
        lens = torch.where(was_done, lens[bi, src], pos + 1)
    norm = scores / torch.clamp(lens.float(), min=1.0) ** length_penalty
    best = torch.argmax(norm, dim=-1)
    return tokens[torch.arange(b, device=dev), best]

