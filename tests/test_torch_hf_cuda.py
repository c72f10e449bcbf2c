"""The port's HF towers on a CUDA card at full width on seeded random weights
(drawn on the card with a CUDA generator; the float32 model loads the same
values). Marked `cuda`: the cases skip where no card is present. Run on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_hf_cuda.py -q

  - the default 'mt5' (mT5-small's encoder: 8 layers, d_model 512, 6
    heads, gated tanh GELU, vocabulary 250112) and 'xlm-roberta' (12
    layers, width 768) text towers on 64 id rows of 77: the bf16 model and
    the f32 kernel path against the plain float32 path; XLM-R launches its
    25 LayerNorms a call and no flash kernel, mT5 no kernel at all (its RMS
    norm and biased attention are plain, as in the JAX package);
  - the HF ViT-B/16 trunk adapter at 1024^2 (`hf_trunk_kwargs`
    image_size 1024: 4097 tokens, the float32 flash kernels at
    [2, 4097, 12, 64]) through one evaluator batch, and its dense map
    against the plain float32 path;
  - coca_roberta-ViT-B-32 with its text tower keyed by the model type
    'roberta': forward and `coca_loss` against the plain float32 path, and
    greedy captions of the f32 kernel path against the f32 plain path
    (tokens EQUAL, or a first difference at a top-2 logit gap under 1e-3).

The trunks compute in float32 whatever the model's dtype: a bf16 model
differs from the f32 one in its projections alone.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from clipself_tpu_torch.core.config import TextConfig, get_model_config
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
from clipself_tpu_torch.models import coca, eva_vit, hf_vit, open_clip_vit
from clipself_tpu_torch.models.clip import dense_stride
from clipself_tpu_torch.models.factory import model_class
from clipself_tpu_torch.models.hf_text import HFTextTower
from clipself_tpu_torch.ops import attention, layer_norm

from torch_threads import capped_threads  # noqa: F401  (module fixture)

pytestmark = pytest.mark.cuda

PATH_F32_MAX_ABS = 1e-4
PATH_BF16_MIN_COS = 0.9996
TIE_GAP = 1e-3
VIT_SIDE = 1024


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counts() -> dict:
    return {"flash": attention.LAUNCHES.count, "layer_norm": layer_norm.LAUNCHES.count}


@contextlib.contextmanager
def _plain():
    """The kernels' plain versions where the HF towers (and a CoCa's ViT)
    call the wrappers; no kernel may launch inside."""
    saved = (eva_vit.layer_norm, hf_vit.multi_head_attention, open_clip_vit.multi_head_attention,
             coca.multi_head_attention)
    eva_vit.layer_norm = layer_norm.layer_norm_plain
    hf_vit.multi_head_attention = open_clip_vit.multi_head_attention = attention.attention_masked
    coca.multi_head_attention = attention.attention_masked
    before = _counts()
    try:
        yield
    finally:
        (eva_vit.layer_norm, hf_vit.multi_head_attention, open_clip_vit.multi_head_attention,
         coca.multi_head_attention) = saved
    assert _counts() == before, "the plain path launched a kernel"


def _min_row_cos(a, b):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def _build(make, dev):
    """(bf16 module, f32 module) of ``make(dtype)`` with the same weights,
    drawn once on the card."""
    with torch.device(dev):
        m16 = make(torch.bfloat16)
        m16.init_weights(torch.Generator(device=dev).manual_seed(0))
        m32 = make(torch.float32)
    m32.load_state_dict(m16.state_dict())
    return m16.eval(), m32.eval()


def _ids(dev, rows, length, vocab, pad, bos, eos, seed=0):
    """[rows, length] ids: ``bos`` (none where negative), random ids, ``eos``, then ``pad``."""
    rng = np.random.default_rng(seed)
    ids = np.full((rows, length), pad, np.int64)
    start = 1 if bos >= 0 else 0
    for r in range(rows):
        n = int(rng.integers(3, length - start))
        ids[r, :start] = bos
        ids[r, start:start + n] = rng.integers(3, vocab, n)
        ids[r, start + n] = eos
    return torch.as_tensor(ids, device=dev)


def _hold(k32, k16, p32, what):
    f32_abs = (k32.float() - p32.float()).abs().max().item()
    cos = _min_row_cos(k16, p32)
    print(f"{what}: f32 kernels vs f32 plain max_abs {f32_abs:.3e}; bf16 vs f32 plain min row cosine {cos:.7f}")
    assert all(torch.isfinite(t).all() for t in (k32, k16, p32))
    assert f32_abs <= PATH_F32_MAX_ABS, what
    assert cos >= PATH_BF16_MIN_COS, what


@pytest.mark.parametrize("typ,pad,bos,eos,norms", [("mt5", 0, -1, 1, 0), ("xlm-roberta", 1, 0, 2, 25)])
def test_default_text_tower(dev, typ, pad, bos, eos, norms):
    cfg = TextConfig(hf_model_name=typ, proj="mlp", pooler_type="mean_pooler")
    m16, m32 = _build(lambda dtype: HFTextTower(cfg, 512, dtype), dev)
    ids = _ids(dev, 64, 77, m16.hf_config.vocab_size, pad, bos, eos)
    with torch.inference_mode():
        before = _counts()
        k16 = m16(ids)
        launched = {k: v - before[k] for k, v in _counts().items()}
        k32 = m32(ids)
        with _plain():
            p32 = m32(ids)
    assert launched == {"flash": 0, "layer_norm": norms}, launched
    _hold(k32, k16, p32, f"{typ} text tower [64, 77]")


def test_hf_vit_trunk_at_1024(dev):
    """ViT-B/16's widths at 1024^2 (4097 tokens): one evaluator batch (2
    images, 4 annotations, crops at the trunk's 1024^2), then the dense map
    of the bf16 model and of the f32 kernels against the plain f32 path."""
    base = get_model_config("hf-vit-tiny-test")
    cfg = dataclasses.replace(base, name="hf-vit-b16-1024", embed_dim=512, vision=dataclasses.replace(
        base.vision, image_size=VIT_SIDE, hf_trunk_kwargs=f'{{"image_size": {VIT_SIDE}}}'))
    m16, m32 = _build(lambda dtype: model_class(cfg)(cfg, dtype), dev)
    grid = VIT_SIDE // dense_stride(cfg.vision)
    batch = synthetic_panoptic_batch(0, batch=2, image_size=VIT_SIDE, max_anns=4, valid_anns=4,
                                     crop_size=VIT_SIDE, mask_hw=grid, n_classes=7, seed=0)
    before = _counts()
    res = evaluate_zero_shot(m16, [batch], class_embeddings(7, 512, seed=0), device=dev, ann_bucket=0)
    launched = {k: v - before[k] for k, v in _counts().items()}
    assert len(res) == 12 and all(np.isfinite(v) for v in res.values()), res
    # a dense pass of the 2 images and a crop pass of the 8 crops
    assert launched == {"flash": 2 * 12, "layer_norm": 2 * 25}, launched
    images = torch.as_tensor(batch["images"], device=dev)
    with torch.inference_mode():
        k16 = m16.encode_dense(images, keep_shape=True)
        k32 = m32.encode_dense(images, keep_shape=True)
        with _plain():
            p32 = m32.encode_dense(images, keep_shape=True)
    assert k32.shape == (2, grid, grid, 512)
    _hold(k32, k16, p32, "hf ViT-B/16 dense map at 1024^2")


def test_coca_roberta(dev):
    """coca_roberta-ViT-B-32 (the ViT-B/32 tower, the RoBERTa-base-width
    text tower keyed 'roberta', a 12-layer decoder of width 768): forward
    and `coca_loss` in bf16 and f32 against the plain f32 path; greedy
    captions of 20 tokens, the f32 kernel path against the f32 plain path."""
    base = get_model_config("coca_roberta-ViT-B-32")
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, hf_model_name="roberta"))
    m16, m32 = _build(lambda dtype: model_class(cfg)(cfg, dtype), dev)
    assert isinstance(m16.text, HFTextTower)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((4, 224, 224, 3), generator=gen, device=dev)
    texts = _ids(dev, 4, cfg.multimodal.context_length + 1, cfg.multimodal.vocab_size, 0, 0, 2)
    with torch.inference_mode():
        before = _counts()
        k16 = m16(images, texts)
        launched = {k: v - before[k] for k, v in _counts().items()}
        k32 = m32(images, texts)
        with _plain():
            p32 = m32(images, texts)
        losses = [coca.coca_loss(o, texts)[0].item() for o in (k16, k32, p32)]
    # the ViT-B/32's 12 blocks (2 norms each, ln_pre, ln_post), the text
    # trunk's 25 norms, the decoder's 2 a self block, 3 a cross block and ln_final
    m = cfg.multimodal
    assert launched == {"flash": 12, "layer_norm": 26 + 25 + 5 * m.layers + 1}, launched
    for key in ("image_features", "text_features", "logits"):
        _hold(k32[key], k16[key], p32[key], f"coca_roberta {key}")
    print(f"coca_roberta coca_loss bf16 / f32 kernels / f32 plain: {losses}")
    assert all(np.isfinite(losses)) and abs(losses[1] - losses[2]) <= PATH_F32_MAX_ABS
    sot, eot = 0, 2
    got = coca.generate(m32, images, sot, eot, max_len=20)
    with _plain():
        want = coca.generate(m32, images, sot, eot, max_len=20)
        diff = (got != want).nonzero()
        if len(diff):
            b, pos = diff[0].tolist()
            with torch.inference_mode():
                logits = m32.decode_text(m32._encode_image(images[b:b + 1])[1], want[b:b + 1])
            top2 = torch.topk(logits[0, pos - 1], 2).values
            assert (top2[0] - top2[1]).item() < TIE_GAP
    assert got.shape == (4, 20) and (got[:, 0] == sot).all()
