"""Port plain tensor ops and copied helpers vs the JAX package, float32 on
the CPU. Copies (config registry, resize weight matrices) are pinned equal;
computed ops agree to 1e-5 (the same f32 products and sums, in another
order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipself_tpu.core import config as jconfig
from clipself_tpu.ops import interpolate as jinterp
from clipself_tpu.ops.mask_pool import mask_pool as jax_mask_pool
from clipself_tpu.ops import roi_align as jroi
from clipself_tpu.ops.patchify import PatchEmbed as JPatchEmbed
from clipself_tpu_torch.core import config
from clipself_tpu_torch.ops import interpolate, mask_pool, patchify, roi_align

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-5


def test_config_registry_copy_equals_original():
    names = jconfig.list_models()
    assert config.list_models() == names
    for name in names:
        assert dataclasses.asdict(config.get_model_config(name)) == dataclasses.asdict(
            jconfig.get_model_config(name)
        ), name


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("sizes", [(4, 6), (16, 64), (14, 7), (5, 5)])
def test_resize_weight_matrix_copy_equals_original(method, sizes):
    got = interpolate.resize_weight_matrix(*sizes, method)
    assert np.array_equal(got, jinterp.resize_weight_matrix(*sizes, method))


@pytest.mark.parametrize("out_hw", [(6, 6), (64, 48)])
def test_resize_2d_matches_jax(out_hw):
    x = np.random.default_rng(0).standard_normal((1, 8, 4, 4)).astype(np.float32)
    want = np.asarray(jinterp.resize_2d(jnp.asarray(x), out_hw, "bicubic"))
    got = interpolate.resize_2d(torch.from_numpy(x), out_hw, "bicubic").numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_patchify_matches_jax_patch_embed():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 35, 40, 3)).astype(np.float32)  # ragged: VALID drops
    kernel = rng.standard_normal((8, 8, 3, 16)).astype(np.float32)  # HWIO
    bias = rng.standard_normal((16,)).astype(np.float32)
    want = np.asarray(
        JPatchEmbed(16, patch_size=8).apply(
            {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, jnp.asarray(x)
        )
    )
    weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())  # OIHW
    got = patchify.patchify(torch.from_numpy(x), weight, torch.from_numpy(bias), torch.float32)
    assert got.shape == (2, 4, 5, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_roi_align_1x1_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    lo = rng.uniform(-0.1, 0.6, (2, 12, 2))
    hi = lo + rng.uniform(0.0, 0.6, (2, 12, 2))
    boxes = np.concatenate([lo, hi], -1).astype(np.float32)
    boxes[0, 0] = [0.3, 0.3, 0.3, 0.3]  # degenerate: zero samples
    boxes[1, 0] = [0.9, 0.9, 1.2, 1.3]  # past the border
    jb = jroi.denormalize_boxes(jnp.asarray(boxes), 7, 9)
    want = np.asarray(jroi.roi_align_1x1(jnp.asarray(feats), jb))
    tb = roi_align.denormalize_boxes(torch.from_numpy(boxes), 7, 9)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    got = roi_align.roi_align_1x1(torch.from_numpy(feats), tb).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_mask_pool_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    masks = (rng.uniform(size=(2, 4, 5, 6)) < 0.3).astype(np.float32)
    masks[1, 3] = 0.0  # padded annotation
    want = np.asarray(jax_mask_pool(jnp.asarray(feats), jnp.asarray(masks)))
    got = mask_pool.mask_pool(torch.from_numpy(feats), torch.from_numpy(masks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
