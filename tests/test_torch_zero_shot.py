"""Port zero-shot evaluator (`clipself_tpu_torch.eval.zero_shot`) vs the JAX
package's, on two synthetic tiny batches, float32 on the CPU with the same
weights. Per-batch logits agree within 1e-4 (whole-tower f32 drift, see
test_torch_eva_clip.py); the top-k metrics then come out equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.eval import zero_shot as jzero_shot
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.eval import zero_shot
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
TOL = 1e-4
N_CLASSES = 11


@pytest.fixture(scope="module")
def setup():
    jmodel, params = jax_create_model(NAME, dtype=jnp.float32, seed=0)
    params = jax.tree.map(np.asarray, params)
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    # 30 padded slots, 7 valid: the bucket of 25 cuts the ann axis to 25
    batches = [
        synthetic_panoptic_batch(
            i, batch=2, image_size=32, max_anns=30, valid_anns=7, crop_size=32,
            mask_hw=4, n_classes=N_CLASSES, seed=5,
        )
        for i in range(2)
    ]
    emb = class_embeddings(N_CLASSES, 64, seed=5)
    return jmodel, params, model.eval(), batches, emb


def test_batch_logits_match_jax(setup):
    jmodel, params, model, batches, emb = setup
    e = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12)
    jfn = jzero_shot._make_batch_features(jmodel, "v2", False)
    for b in batches:
        want = jfn(
            params, jnp.asarray(e), *(jnp.asarray(a) for a in (
                b["images"], b["boxes"][..., :4], b["crops"], b["gt_masks"]
            ))
        )
        got = zero_shot.batch_logits(
            model, torch.from_numpy(e),
            *(torch.from_numpy(a) for a in (
                b["images"], b["boxes"][..., :4], b["crops"], b["gt_masks"]
            )),
        )
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_evaluate_zero_shot_matches_jax(setup):
    jmodel, params, model, batches, emb = setup
    want = jzero_shot.evaluate_zero_shot(jmodel, params, batches, emb, ann_bucket=25)
    got = zero_shot.evaluate_zero_shot(model, batches, emb, device="cpu", ann_bucket=25)
    assert sorted(got) == sorted(want) and len(got) == 12
    np.testing.assert_equal(got, want)


def test_batch_logits_image_ave_pool_match_jax(setup):
    """The crops scored by their mean dense feature (`image_ave_pool`):
    `encode_dense(normalize=True)` averaged and L2-normalized, as the JAX
    package's batch features compute them."""
    jmodel, params, model, batches, emb = setup
    e = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12)
    jfn = jzero_shot._make_batch_features(jmodel, "v2", True)
    b = batches[0]
    args = (b["images"], b["boxes"][..., :4], b["crops"], b["gt_masks"])
    want = jfn(params, jnp.asarray(e), *(jnp.asarray(a) for a in args))
    got = zero_shot.batch_logits(
        model, torch.from_numpy(e), *(torch.from_numpy(a) for a in args), image_ave_pool=True
    )
    cls_crops = zero_shot.batch_logits(model, torch.from_numpy(e), *(torch.from_numpy(a) for a in args))[1]
    assert (got[1] - cls_crops).abs().max() > 1e-3  # another crop feature than the CLS one
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_evaluate_zero_shot_image_ave_pool_matches_jax(setup):
    jmodel, params, model, batches, emb = setup
    want = jzero_shot.evaluate_zero_shot(
        jmodel, params, batches[:1], emb, image_ave_pool=True, ann_bucket=25
    )
    got = zero_shot.evaluate_zero_shot(
        model, batches[:1], emb, device="cpu", ann_bucket=25, image_ave_pool=True
    )
    assert sorted(got) == sorted(want) and len(got) == 12
    np.testing.assert_equal(got, want)


def test_bucket_width():
    boxes = np.zeros((2, 100, 8), np.float32)
    boxes[0, :13, 5] = 1.0
    assert zero_shot._bucket_width(boxes, 25) == 25
    boxes[1, 60, 5] = 1.0
    assert zero_shot._bucket_width(boxes, 25) == 75
    assert zero_shot._bucket_width(boxes, 0) == 100
    assert zero_shot._bucket_width(boxes[:, :20], 25) == 20


def test_macc_and_topk_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 40)
    is_thing = rng.integers(0, 2, 40).astype(np.float32)
    got_c = zero_shot._topk_correct(logits, labels)
    np.testing.assert_array_equal(got_c, jzero_shot._topk_correct(logits, labels))
    np.testing.assert_equal(
        zero_shot.macc_with_is_thing(got_c, is_thing, labels, "rois"),
        jzero_shot.macc_with_is_thing(got_c, is_thing, labels, "rois"),
    )
