"""Port EVA02-CLIP tower (`clipself_tpu_torch.models`) vs the JAX package on
`EVA02-CLIP-Tiny-Test`, float32 on the CPU, the same weights on both sides
(through `state_dict_from_jax`). Whole-tower outputs accumulate the
products and sums of every layer in another order: atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
TOL = 1e-4


@pytest.fixture(scope="module")
def towers():
    jmodel, params = jax_create_model(NAME, dtype=jnp.float32, seed=0)
    params = jax.tree.map(np.asarray, params)
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    return jmodel, params, model.eval()


def _inputs(size: int, patch: int = 8):
    rng = np.random.default_rng(size)
    g = size // patch
    img = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.6, (2, 5, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (2, 5, 2))], -1).astype(np.float32)
    masks = (rng.uniform(size=(2, 5, g, g)) < 0.3).astype(np.float32)
    return img, boxes, masks


@pytest.mark.parametrize("size", [32, 48])  # 48^2 resizes the 4x4 pos-embed grid to 6x6
@pytest.mark.parametrize("method", ["encode_image", "encode_dense", "encode_rois_and_masks"])
def test_tower_matches_jax(towers, size, method):
    jmodel, params, model = towers
    img, boxes, masks = _inputs(size)
    v = {"params": params}
    ti, tb, tm = (torch.from_numpy(a) for a in (img, boxes, masks))
    with torch.no_grad():
        if method == "encode_image":
            want = [jmodel.apply(v, jnp.asarray(img), True, method="encode_image")]
            got = [model.encode_image(ti, normalize=True)]
        elif method == "encode_dense":
            want = [jmodel.apply(v, jnp.asarray(img), False, True, method="encode_dense")]
            got = [model.encode_dense(ti, keep_shape=True)]
        else:
            want = jmodel.apply(
                v, *(jnp.asarray(a) for a in (img, boxes, masks)), method="encode_rois_and_masks"
            )
            got = model.encode_rois_and_masks(ti, tb, tm)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_state_dict_from_jax_equals_export_state_dict(towers):
    _, params, model = towers
    cfg = get_model_config(NAME)
    ref = jtorch_io.export_state_dict(params, cfg)  # the whole CLIP, text tower included
    sd = state_dict_from_jax(params)
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    # the port's module tree has exactly these keys (strict loading)
    assert sorted(model.state_dict()) == sorted(ref)


def test_load_weights_is_strict(towers, tmp_path):
    _, params, _ = towers
    sd = state_dict_from_jax(params)
    model = CLIP(get_model_config(NAME), torch.float32)
    # reference checkpoints: wrapped, `module.`-prefixed, with RoPE buffers
    # the port drops (every text key loads: tests/test_torch_text.py)
    wrapped = {f"module.{k}": v for k, v in sd.items()}
    wrapped["module.visual.rope.freqs_cos"] = torch.zeros(3)
    torch.save({"state_dict": wrapped, "epoch": 3}, tmp_path / "ckpt.pt")
    load_weights(model, str(tmp_path / "ckpt.pt"))
    assert torch.equal(model.visual.head.weight, sd["visual.head.weight"])
    missing = dict(sd)
    del missing["visual.blocks.0.attn.q_bias"]
    with pytest.raises(RuntimeError, match="q_bias"):
        load_weights(model, missing)


def test_create_model_is_seeded():
    a = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    b = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    c = create_model(NAME, device="cpu", dtype=torch.float32, seed=4)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    pe = a.visual.pos_embed
    assert pe.abs().max() <= 0.04 and 0.015 < pe.std() < 0.02  # trunc normal(0.02)
    w = a.visual.blocks[0].mlp.w1.weight
    assert abs(w.std().item() * w.shape[1] ** 0.5 - 1.0) < 0.1  # lecun normal
    assert not torch.equal(a.visual.head.weight, c.visual.head.weight)
    assert torch.equal(a.visual.head.bias, torch.zeros_like(a.visual.head.bias))
    assert not a.training
