"""The port's CoCa on a CUDA card at full width and depth on seeded random
weights (drawn on the card with a CUDA generator; the float32 model loads
the same values). Marked `cuda`: the cases skip where no card is present.
Run on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_coca_cuda.py -q

  - one bf16 batch of coca_ViT-B-32 (the pooler over 50 tokens: the flash
    kernels on one ragged tile) and of coca_base (no pooler: the raw patch
    tokens feed the decoder; vocabulary 64000) against the plain float32
    path: image latents, text latents and decoder logits at a min row
    cosine >= 0.9996 (the bar of PARITY_CHIP.md);
  - coca_ViT-L-14 captioning at the full 76 tokens: greedy with the f32
    kernels against the f32 plain path (tokens EQUAL, or a first difference
    at a top-2 logit gap under 1e-3), top-k and top-p sampling from a seeded
    generator (the same seed gives the same caption; every caption starts
    with the start token and ends at an end token or a pad), `beam_search` (one beam
    is greedy; four beams in two groups well formed);
  - a CoCa over the EVA02-CLIP-B-16 tower (RoPE on the path: the CoCa
    towers of the registry are plain ViTs) against the plain float32 path;
  - the cross-attention route: q and k of different lengths on the card
    launch no kernel and equal the plain float32 attention.
"""

import contextlib
import dataclasses

import pytest
import torch

from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models import coca, eva_vit, open_clip_vit, rope
from clipself_tpu_torch.models.factory import get_tokenizer, model_class
from clipself_tpu_torch.ops import attention, layer_norm, rope_roll
from clipself_tpu_torch.tokenizer import tokenize

from torch_threads import capped_threads  # noqa: F401  (module fixture)

pytestmark = pytest.mark.cuda

PATH_BF16_MIN_COS = 0.9996
TIE_GAP = 1e-3
CAPTIONS = ["a man riding a wave on top of a surfboard", "two dogs playing with a frisbee in the park"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counts() -> dict:
    return {"flash": attention.LAUNCHES.count, "layer_norm": layer_norm.LAUNCHES.count,
            "rope": rope_roll.LAUNCHES.count}


def _build(cfg, dev):
    """(bf16 model, f32 model) of ``cfg`` with the same weights, drawn once
    on the card."""
    with torch.device(dev):
        m16 = model_class(cfg)(cfg, dtype=torch.bfloat16)
        m16.init_weights(torch.Generator(device=dev).manual_seed(0))
        m32 = model_class(cfg)(cfg, dtype=torch.float32)
    m32.load_state_dict(m16.state_dict())
    return m16.eval(), m32.eval()


@contextlib.contextmanager
def _plain():
    """The kernels' plain versions where a CoCa calls the wrappers; no
    kernel may launch inside."""
    from clipself_tpu_torch.ops.rope_roll import rolled_rope_plain, unpack_tables

    def rope_plain(x, packed, packed_bwd):
        return rolled_rope_plain(x, *unpack_tables(packed))

    def rope_qk_plain(q, k, packed, packed_bwd):
        return rope_plain(q, packed, packed_bwd), rope_plain(k, packed, packed_bwd)

    saved = (eva_vit.multi_head_attention, eva_vit.layer_norm, open_clip_vit.multi_head_attention,
             coca.multi_head_attention, rope.rolled_rope, rope.rolled_rope_qk)
    eva_vit.multi_head_attention = open_clip_vit.multi_head_attention = attention.attention_masked
    coca.multi_head_attention = attention.attention_masked
    eva_vit.layer_norm = layer_norm.layer_norm_plain
    rope.rolled_rope, rope.rolled_rope_qk = rope_plain, rope_qk_plain
    before = _counts()
    try:
        yield
    finally:
        (eva_vit.multi_head_attention, eva_vit.layer_norm, open_clip_vit.multi_head_attention,
         coca.multi_head_attention, rope.rolled_rope, rope.rolled_rope_qk) = saved
    assert _counts() == before, "the plain path launched a kernel"


def _min_row_cos(a, b):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def _inputs(cfg, dev, batch=2):
    size = cfg.vision.image_size
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((batch, size, size, 3), generator=gen, device=dev)
    texts = torch.as_tensor(get_tokenizer(cfg)((CAPTIONS * batch)[:batch]), device=dev).long()
    return images, texts


def _hold_batch(cfg, dev) -> dict:
    """The bf16 forward against the plain f32 path: min row cosine of the
    image latents, text latents and decoder logits, and the bf16 run's
    launches."""
    m16, m32 = _build(cfg, dev)
    images, texts = _inputs(cfg, dev)
    with torch.inference_mode():
        before = _counts()
        k16 = m16(images, texts)
        launched = {k: v - before[k] for k, v in _counts().items()}
        with _plain():
            p32 = m32(images, texts)
    cos = {key: _min_row_cos(k16[key], p32[key]) for key in ("image_features", "text_features", "logits")}
    print(f"{cfg.name}: bf16 vs plain f32 min row cosine {cos}; launches {launched}")
    assert all(torch.isfinite(k16[k]).all() for k in cos)
    assert k16["logits"].shape == (2, cfg.multimodal.context_length, cfg.multimodal.vocab_size)
    return cos, launched


@pytest.mark.parametrize("name", ["coca_ViT-B-32", "coca_base"])
def test_registry_coca_bf16_batch(dev, name):
    cfg = get_model_config(name)
    cos, launched = _hold_batch(cfg, dev)
    assert launched["flash"] == cfg.vision.layers and launched["rope"] == 0, launched
    for key, c in cos.items():
        assert c >= PATH_BF16_MIN_COS, f"{name} {key}: min row cosine {c}"


def test_eva_towered_coca_bf16_batch(dev):
    """CoCa over EVA02-CLIP-B-16's tower (width 768, RoPE, 197 tokens at
    224^2) with coca_ViT-L-14's text tower and decoder (width 768)."""
    base = get_model_config("coca_ViT-L-14")
    cfg = dataclasses.replace(base, name="coca-eva02-b16", vision=get_model_config("EVA02-CLIP-B-16").vision)
    cos, launched = _hold_batch(cfg, dev)
    assert launched["flash"] == launched["rope"] == cfg.vision.layers, launched
    for key, c in cos.items():
        assert c >= PATH_BF16_MIN_COS, f"{key}: min row cosine {c}"


@pytest.fixture(scope="module")
def l14():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = get_model_config("coca_ViT-L-14")
    m16, m32 = _build(cfg, dev)
    images, _ = _inputs(cfg, dev)
    return m16, m32, images


SOT, EOT = (int(tokenize("")[0, i]) for i in (0, 1))
FULL = 76  # the config's context length: the CLS slot makes 77 positions


def _well_formed(tokens):
    """Each row starts with the start token and ends at its first end token
    or pad (a sampled pad ends a row with no end token), pads after it."""
    assert tokens.shape == (2, FULL)
    for row in tokens.tolist():
        assert row[0] == SOT, row
        end = next(i for i, t in enumerate(row) if i and t in (EOT, 0))
        assert all(t == 0 for t in row[end + 1:]), row


def test_l14_greedy_full_length_kernels_vs_plain(l14):
    _, m32, images = l14
    got = coca.generate(m32, images, SOT, EOT, max_len=FULL)
    with _plain():
        want = coca.generate(m32, images, SOT, EOT, max_len=FULL)
        diff = (got != want).nonzero()
        if len(diff):
            b, pos = diff[0].tolist()
            with torch.inference_mode():
                logits = m32.decode_text(m32._encode_image(images[b:b + 1])[1], want[b:b + 1])
            top2 = torch.topk(logits[0, pos - 1], 2).values
            gap = (top2[0] - top2[1]).item()
            print(f"greedy differs first at row {b} position {pos}: top-2 gap {gap:.3e}")
            assert gap < TIE_GAP
    _well_formed(got)


@pytest.mark.parametrize("kw", [{"top_k": 10}, {"top_p": 0.9, "temperature": 0.8}], ids=["top_k", "top_p"])
def test_l14_sampling_full_length(l14, kw):
    m16, _, images = l14

    def sample():
        gen = torch.Generator(device=images.device).manual_seed(3)
        return coca.generate(m16, images, SOT, EOT, max_len=FULL, generator=gen, **kw)

    first = sample()
    assert torch.equal(first, sample())
    _well_formed(first)


def test_l14_beam_search_full_length(l14):
    m16, _, images = l14
    greedy = coca.generate(m16, images, SOT, EOT, max_len=FULL)
    one = coca.beam_search(m16, images, SOT, EOT, max_len=FULL, num_beams=1, length_penalty=0.0)
    assert torch.equal(one, greedy)
    beams = coca.beam_search(m16, images, SOT, EOT, max_len=FULL, num_beams=4, num_beam_groups=2)
    _well_formed(beams)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_route_on_the_card(dev, dtype):
    """The pooler's shapes at coca_ViT-L-14: 256 queries over 257 tokens, 8
    heads of 96."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((2, 256, 8, 96), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((2, 257, 8, 96), generator=gen, device=dev).to(dtype) for _ in range(2))
    before = _counts()
    got = attention.multi_head_attention(q, k, v, 96 ** -0.5)
    assert _counts() == before
    want = attention.attention_masked(q.float(), k.float(), v.float(), 96 ** -0.5)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert _min_row_cos(got, want) >= 0.9999
