"""The large towers on a CUDA card, through the evaluator at full width and
depth on seeded random weights. Marked `cuda`: they skip where no card is
present. Run on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_towers_cuda.py -q

ViT-H-14 has head_dim 80, ViT-g-14 and EVA01-CLIP-g-14 88 and ViT-bigG-14
104, which the bfloat16 flash kernels take on wgmma tiles of two 64-column
panels (88 and 104 zero-filling the columns up to the next multiple of 16);
EVA02-CLIP-bigE-14 has 112 and post-norm blocks; EVA01-CLIP-g-14 the fused
`qkv` projection and the GELU MLP. Each takes one evaluator batch of one image at 896^2 (a 64x64
grid, 4097 tokens; 25 crops at the tower's 224^2), which must launch the
flash forward and give finite metrics, and the bf16 dense map of that image
must stay at a min row cosine >= 0.9996 against the plain float32 path (the
kernels' plain versions swapped in; the bar of PARITY_CHIP.md for the JAX
package's bf16 chip path against float32). RN50x64 runs at its own 448^2,
where no kernel of the port launches (BatchNorm and the attention pool's
plain attention), with the same bar. The weights are drawn on the card with
a CUDA generator (a tower of 4.4 B parameters takes minutes on the host);
the float32 model is drawn again from the same seed.

The timm towers take one such batch too: convnext_large_d (the MLP head)
and convnext_xxlarge (LayerNorm width 3072) at 1024^2, their layer scales
drawn uniform in [0.1, 1) so that the blocks matter; the GAP ViT at its
256^2 (the flash forward in every block) and the rel-pos ViT at 224^2 and
448^2; each launching the LayerNorm kernel once a norm of each pass.

Every transformer block is also held on its own: each block of the float32
tower takes the tokens that the plain float32 path gives it, and its output
with the bf16 kernels (min row cosine >= 0.9996) and with the float32
kernels (within 1e-4 of the block output's largest entry) is held against
the plain block's. For EVA02-CLIP-bigE-14 this per-block bar is the only
one: on seeded random weights its post-norm residual stream is not
normalised before the next block's q and k, so the logits grow with depth
and the softmax turns near one-hot, and a rounding anywhere flips it. Over
its 64 blocks the whole dense map of the JAX package's own bf16 path then
diverges from its float32 path as far as the port's does (min row cosine
0.72 against the port's 0.76 on a 64-block, width-128 tower of that layout
on the CPU; 0.75 for the port at full width on the card), and even float32
diverges from float64 (max abs 0.058). Its whole-map cosine is printed.
"""

import contextlib

import numpy as np
import pytest
import torch

from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
from clipself_tpu_torch.models import eva_vit, open_clip_vit, timm_vit
from clipself_tpu_torch.models.clip import CLIP, dense_stride
from clipself_tpu_torch.models.convnext import CONVNEXT_ARCHS, ConvNeXtBlock
from clipself_tpu_torch.ops import attention, layer_norm, rope_roll

from torch_threads import capped_threads  # noqa: F401  (module fixture)

pytestmark = pytest.mark.cuda

PATH_BF16_MIN_COS = 0.9996
BLOCK_F32_MAX_REL = 1e-4
N_CLASSES, MAX_ANNS, VALID_ANNS, BUCKET = 133, 100, 13, 25


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counts() -> dict:
    return {"flash": attention.LAUNCHES.count, "layer_norm": layer_norm.LAUNCHES.count,
            "rope": rope_roll.LAUNCHES.count}


def _build(name: str, dtype: torch.dtype, dev) -> CLIP:
    """The tower's CLIP with seeded random weights drawn on the card; a
    ConvNeXt's layer scales (1e-6 at init, which leaves its blocks all but
    idle) then drawn uniform in [0.1, 1)."""
    with torch.device(dev):
        model = CLIP(get_model_config(name), dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.visual.init_weights(gen)
    model.text.init_weights(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=gen, device=dev) * 0.9 + 0.1)
    return model.eval()


@contextlib.contextmanager
def _plain():
    """The kernels' plain versions where the towers call the wrappers
    (these towers run no RoPE; the timm towers' LayerNorms are `eva_vit`'s)."""
    saved = (eva_vit.multi_head_attention, eva_vit.layer_norm, open_clip_vit.multi_head_attention,
             timm_vit.multi_head_attention)
    eva_vit.multi_head_attention = open_clip_vit.multi_head_attention = attention.attention_masked
    timm_vit.multi_head_attention = attention.attention_masked
    eva_vit.layer_norm = layer_norm.layer_norm_plain
    try:
        yield
    finally:
        (eva_vit.multi_head_attention, eva_vit.layer_norm, open_clip_vit.multi_head_attention,
         timm_vit.multi_head_attention) = saved


def _min_row_cos(a, b):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def _per_block(model, images) -> tuple[float, float]:
    """(min row cosine of the bf16 kernel block against the plain f32 block,
    max abs error of the f32 kernel block over the plain block's largest
    entry), the worst over every transformer block (none in the ResNet),
    each on the tokens that the plain float32 path gives it."""
    visual = model.visual
    worst_cos, worst_rel = 1.0, 0.0
    if not hasattr(visual, "blocks"):
        return worst_cos, worst_rel
    with torch.inference_mode():
        t, grid = visual.embed(images)
        for blk in visual.blocks:
            # an EVA block takes the grid (its RoPE's), a ViT block only the tokens
            call = (lambda x: blk(x, grid)) if isinstance(visual, eva_vit.EvaViT) else blk
            with _plain():
                ref = call(t)
            k32, k16 = call(t), call(t.bfloat16())
            worst_cos = min(worst_cos, _min_row_cos(k16, ref))
            worst_rel = max(worst_rel, ((k32 - ref).abs().max() / ref.abs().max()).item())
            t = ref
    return worst_cos, worst_rel


def _evaluate_and_compare(name, side, dev):
    """One evaluator batch of one image at ``side``^2 in bf16, then the dense
    map against the plain float32 path, and every block against the plain
    block (`_per_block`). Returns (the evaluator run's launch counts, the
    dense map's min row cosine, the blocks' worst bf16 cosine, the blocks'
    worst f32 relative error)."""
    cfg = get_model_config(name)
    grid = side // dense_stride(cfg.vision)
    host = synthetic_panoptic_batch(
        0, batch=1, image_size=side, max_anns=MAX_ANNS, valid_anns=VALID_ANNS,
        crop_size=cfg.vision.image_size, mask_hw=grid, n_classes=N_CLASSES,
    )
    batch = {k: (v if k == "boxes" else torch.as_tensor(v, device=dev)) for k, v in host.items()}
    model = _build(name, torch.bfloat16, dev)
    before = _counts()
    res = evaluate_zero_shot(model, [batch], class_embeddings(N_CLASSES, cfg.embed_dim), device=dev,
                             ann_bucket=BUCKET)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts().items()}
    assert len(res) == 12 and all(np.isfinite(v) for v in res.values()), res
    with torch.inference_mode():
        d16 = model.encode_dense(batch["images"], keep_shape=True)
    del model
    torch.cuda.empty_cache()
    model = _build(name, torch.float32, dev)
    before = _counts()
    with torch.inference_mode(), _plain():
        d32 = model.encode_dense(batch["images"], keep_shape=True)
    torch.cuda.synchronize()
    assert _counts() == before, "the plain path launched a kernel"
    block_cos, block_rel = _per_block(model, batch["images"])
    del model
    torch.cuda.empty_cache()
    assert d16.shape == d32.shape == (1, grid, grid, cfg.embed_dim)
    assert torch.isfinite(d16).all() and torch.isfinite(d32).all()
    cos = _min_row_cos(d16, d32)
    print(f"{name} at {side}^2: dense map bf16 vs plain f32 min row cosine {cos:.7f}; worst block: bf16 "
          f"{block_cos:.7f}, f32 relative {block_rel:.3e}; launches {launched}")
    return launched, cos, block_cos, block_rel


@pytest.mark.parametrize("name,head_dim,whole_map", [
    ("ViT-H-14", 80, True), ("ViT-g-14", 88, True), ("ViT-bigG-14", 104, True), ("EVA01-CLIP-g-14", 88, True),
    ("EVA02-CLIP-bigE-14", 112, False),  # random-weight post-norm: see the module's docstring
])
def test_large_tower_evaluator_batch_at_896(dev, name, head_dim, whole_map):
    """The evaluator's dense pass (every block but the value-path last) and
    crop pass (every block) launch the flash forward, no RoPE; every block
    holds the bf16 and f32 bars, and (but bigE) the whole dense map the
    bf16 bar."""
    v = get_model_config(name).vision
    assert v.head_width == head_dim
    assert attention.kernel_design(torch.bfloat16, head_dim) == "wgmma"
    launched, cos, block_cos, block_rel = _evaluate_and_compare(name, 896, dev)
    assert launched["flash"] == 2 * v.layers - 1 and launched["rope"] == 0, launched
    assert launched["layer_norm"] > 0, launched
    assert block_cos >= PATH_BF16_MIN_COS, f"{name}: a bf16 block's min row cosine {block_cos}"
    assert block_rel <= BLOCK_F32_MAX_REL, f"{name}: an f32 block off by {block_rel} of its largest entry"
    if whole_map:
        assert cos >= PATH_BF16_MIN_COS, f"{name}: bf16 dense map min row cosine {cos}"


def test_resnet_50x64_evaluator_batch_at_448(dev):
    """RN50x64 at its 448^2: no kernel of the port launches; the dense map
    holds the bf16 bar."""
    launched, cos, _, _ = _evaluate_and_compare("RN50x64", 448, dev)
    assert launched == {"flash": 0, "layer_norm": 0, "rope": 0}, launched
    assert cos >= PATH_BF16_MIN_COS, f"RN50x64: bf16 dense map min row cosine {cos}"


@pytest.mark.parametrize("name", ["convnext_large_d", "convnext_xxlarge"])
def test_convnext_evaluator_batch_at_1024(dev, name):
    """ConvNeXt-Large with the MLP head and ConvNeXt-XXLarge (LayerNorm width
    3072) at 1024^2: the LayerNorm kernel alone launches, once a norm of the
    dense and of the crop pass; the dense map holds the bf16 bar."""
    depths = CONVNEXT_ARCHS[get_model_config(name).vision.timm_model_name][0]
    launched, cos, _, _ = _evaluate_and_compare(name, 1024, dev)
    assert launched == {"flash": 0, "layer_norm": 2 * (len(depths) + sum(depths) + 1), "rope": 0}, launched
    assert cos >= PATH_BF16_MIN_COS, f"{name}: bf16 dense map min row cosine {cos}"


@pytest.mark.parametrize("name,side,flash", [
    ("vit_medium_patch16_gap_256", 256, 24),  # its pos_embed is not resized: 256^2 only
    ("vit_relpos_medium_patch16_cls_224", 224, 0),
    ("vit_relpos_medium_patch16_cls_224", 448, 0),  # [784^2, 512] rel-pos MLP activations
])
def test_timm_vit_evaluator_batch(dev, name, side, flash):
    """The GAP ViT's unbiased attention launches the flash forward in every
    block of both passes; the rel-pos ViT's biased attention is plain. Two
    LayerNorms a block and the final one a pass; the dense map holds the
    bf16 bar."""
    launched, cos, _, _ = _evaluate_and_compare(name, side, dev)
    assert launched == {"flash": flash, "layer_norm": 2 * 25, "rope": 0}, launched
    assert cos >= PATH_BF16_MIN_COS, f"{name} at {side}^2: bf16 dense map min row cosine {cos}"
