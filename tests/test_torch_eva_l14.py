"""The L/14 shapes through the port (`clipself_tpu_torch`) vs the JAX package,
float32 on the CPU, the same weights on both sides (`state_dict_from_jax`).

The config is `EVA02-CLIP-L-14-336` cut on both sides by
`dataclasses.replace`: patch 14, head width 64, `mlp_ratio` 2.6667,
`pt_hw_seq_len` 16 and the flags kept; width 128 (2 heads, SwiGLU hidden 341,
an odd LayerNorm width), 3 layers, image 56 (a 4x4 grid); the text tower is
Tiny-Test's, so that building the JAX model stays fast. The dense pass runs
at 112^2: an 8x8 grid, so the pos-embed is resized and the RoPE tables are
interpolated.

Tolerances, as in `test_torch_eva_clip.py` and `test_torch_train_step.py`:
tower outputs sum every layer's products in another order, 1e-4; the loss
1e-5; every trainable gradient 1e-4 of its largest entry (plus 1e-8 where a
tensor vanishes). Recomputation runs the same float32 operations again in
the same order, so on the CPU the run with `grad_checkpointing` equals the
run without it to 1e-7 of the largest entry. Parameters after one AdamW
step: the first update is lr * g / (|g| + eps), so an entry whose gradient
is of the size of eps = 1e-8 turns last-digit noise into a visible share of
lr = 1e-3 (measured: one entry of a tensor at 6.1e-5); at most 0.1% of a
tensor's entries may differ by more than 2e-6 and none by more than 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jax_get_model_config
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu.train import step as jstep
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.train import methods, optim, step

NAME, TEXT_OF = "EVA02-CLIP-L-14-336", "EVA02-CLIP-Tiny-Test"
CUT = dict(width=128, layers=3, image_size=56)
LAYERS = CUT["layers"]
OUT_TOL, LOSS_TOL, GRAD_REL, REMAT_REL = 1e-4, 1e-5, 1e-4, 1e-7
PARAM_BULK, PARAM_BULK_SHARE, PARAM_MAX = 2e-6, 1e-3, 1e-4


def _cut(get):
    full = get(NAME)
    return dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, **CUT), text=get(TEXT_OF).text,
        name="l14-cut",
    )


@pytest.fixture(scope="module")
def jax_setup():
    """{remat: JAX model}, and the parameters (remat does not change them)."""
    jcfg = _cut(jax_get_model_config)
    jmodel, params = jax_create_model(jcfg, dtype=jnp.float32, seed=0)
    jmodel_remat, _ = jax_create_model(jcfg, dtype=jnp.float32, remat=True, init=False)
    return {False: jmodel, True: jmodel_remat}, jax.tree.map(np.asarray, params)


def _torch_model(params, grad_checkpointing=False) -> CLIP:
    cfg = _cut(get_model_config)
    v = cfg.vision
    assert (v.patch_size, v.head_width, v.num_heads, int(v.width * v.mlp_ratio)) == (14, 64, 2, 341)
    model = CLIP(cfg, torch.float32, grad_checkpointing=grad_checkpointing)
    load_weights(model, state_dict_from_jax(params))
    return model


def _batch(seed=0, b=2, m=3, size=112, crop=56):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    valid = np.ones((b, m, 1))
    valid[:, -1] = 0.0
    return {
        "images": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "boxes": np.concatenate([xy, xy + wh, valid], -1).astype(np.float32),
        "crops": rng.standard_normal((b, m, crop, crop, 3)).astype(np.float32),
    }


def test_cut_configs_are_equal_on_both_sides():
    assert dataclasses.asdict(_cut(get_model_config)) == dataclasses.asdict(
        _cut(jax_get_model_config)
    )


def test_encode_dense_matches_jax(jax_setup):
    jmodels, params = jax_setup
    images = _batch()["images"]
    want = jmodels[False].apply(
        {"params": params}, jnp.asarray(images), False, True, method="encode_dense"
    )
    with torch.no_grad():
        got = _torch_model(params).eval().encode_dense(torch.from_numpy(images), keep_shape=True)
    assert got.shape == want.shape == (2, 8, 8, 768)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=OUT_TOL)


def test_encode_image_on_crops_matches_jax(jax_setup):
    jmodels, params = jax_setup
    crops = _batch()["crops"].reshape(6, 56, 56, 3)
    want = jmodels[False].apply({"params": params}, jnp.asarray(crops), True, method="encode_image")
    with torch.no_grad():
        got = _torch_model(params).eval().encode_image(torch.from_numpy(crops), normalize=True)
    assert got.shape == want.shape == (6, 768)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=OUT_TOL)


def _port_loss_and_grads(params, batch, grad_checkpointing):
    model = _torch_model(params, grad_checkpointing)
    teacher = _torch_model(params).requires_grad_(False)
    labels = optim.trainable_labels(model.state_dict().keys(), LAYERS, LAYERS)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    loss, _ = methods.clipself_loss(
        model, teacher, {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    loss.backward()
    grads = {
        name: None if p.grad is None else p.grad.numpy()
        for name, p in model.named_parameters() if labels[name] == "train"
    }
    assert grads
    return loss.item(), grads


@pytest.fixture(scope="module")
def port_plain_run(jax_setup):
    return _port_loss_and_grads(jax_setup[1], _batch(1), grad_checkpointing=False)


@pytest.mark.parametrize("recompute", [False, True], ids=["plain", "recompute"])
def test_distill_loss_and_trainable_grads_match_jax(jax_setup, port_plain_run, recompute):
    """The loss and every trainable gradient of one distill step, all 3
    blocks unlocked, against `jax.value_and_grad` of the JAX loss on the model
    built with the same `remat`; the recomputing run also against the port's
    run without it."""
    jmodels, params = jax_setup
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmethods.clipself_loss(p, params, jbatch, jmodels[recompute]), has_aux=True
    )(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    loss, grads = (
        _port_loss_and_grads(params, batch, grad_checkpointing=True) if recompute else port_plain_run
    )
    assert abs(loss - float(jloss)) <= LOSS_TOL
    for name, g in grads.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g  # outside the graph: zero in JAX
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + 1e-8, err_msg=name)
    if recompute:
        plain_loss, plain_grads = port_plain_run
        assert abs(loss - plain_loss) <= REMAT_REL
        assert grads.keys() == plain_grads.keys()
        for name, g in grads.items():
            p = plain_grads[name]
            assert (g is None) == (p is None), name
            if g is not None:
                np.testing.assert_allclose(
                    g, p, rtol=0, atol=REMAT_REL * np.abs(p).max() + 1e-12, err_msg=name
                )


@pytest.mark.parametrize("recompute", [False, True], ids=["plain", "recompute"])
def test_one_train_step_matches_jax_make_train_step(jax_setup, recompute):
    """One AdamW step through the port's `make_train_step` against the JAX
    `make_train_step` on the model built with the same `remat`: the loss,
    the gradient norm and every parameter after the step."""
    jmodels, params = jax_setup
    batch = _batch(2)
    sched_kw = dict(base_lr=1e-3, warmup=1, total_steps=10)
    tx = joptim.build_optimizer(
        params, joptim.make_schedule("cosine", **sched_kw), wd=0.1,
        unlocked_groups=LAYERS, num_layers=LAYERS,
    )
    jstep_fn = jstep.make_train_step(
        jmodels[recompute], tx, jmethods.clipself_loss, mesh=None, donate=False,
        trainable=joptim.trainable_labels(params, LAYERS, LAYERS), log_grad_norm=True,
    )
    jstate = jstep.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
    jstate, jmetrics = jstep_fn(
        jstate, params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0)
    )

    model = _torch_model(params, grad_checkpointing=recompute)
    opt = optim.build_optimizer(
        model, optim.make_schedule("cosine", **sched_kw), wd=0.1,
        unlocked_groups=LAYERS, num_layers=LAYERS,
    )
    state = step.TrainState(model, opt)
    step_fn = step.make_train_step(
        methods.clipself_loss, _torch_model(params).requires_grad_(False), log_grad_norm=True
    )
    metrics = step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(metrics["loss"].item() - float(jmetrics["loss"])) <= LOSS_TOL
    np.testing.assert_allclose(
        metrics["grad_norm"].item(), float(jmetrics["grad_norm"]), rtol=1e-5
    )
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    moved = 0
    for name, p in model.state_dict().items():
        diff = (p - want[name]).abs()
        assert diff.max().item() <= PARAM_MAX, name
        assert (diff > PARAM_BULK).float().mean().item() <= PARAM_BULK_SHARE, name
        moved += name.startswith("visual.blocks.") and not torch.equal(
            p, state_dict_from_jax(params)[name]
        )
    assert moved > 0 and state.step == 1


def test_recomputation_runs_each_block_twice_and_only_with_gradients(jax_setup, monkeypatch):
    """With `grad_checkpointing` every block's forward runs once in the
    forward pass and once more in the backward pass; under no_grad (the
    teacher, the evaluator) it runs once and keeps no graph."""
    from clipself_tpu_torch.models import eva_vit

    _, params = jax_setup
    model = _torch_model(params, grad_checkpointing=True)
    calls = []
    fwd = eva_vit.EvaBlock.forward
    monkeypatch.setattr(
        eva_vit.EvaBlock, "forward", lambda self, *a: calls.append(1) or fwd(self, *a)
    )
    crops = torch.from_numpy(_batch()["crops"].reshape(6, 56, 56, 3))
    with torch.no_grad():
        assert model.encode_image(crops).grad_fn is None
    assert len(calls) == LAYERS
    calls.clear()
    out = model.encode_image(crops)
    assert len(calls) == LAYERS
    out.sum().backward()
    assert len(calls) == 2 * LAYERS
    assert model.visual.blocks[0].norm1.weight.grad is not None
