"""The port's distill step (`clipself_tpu_torch.train`) against the JAX
package on `EVA02-CLIP-Tiny-Test`, float32 on the CPU, the same weights on
both sides (through `state_dict_from_jax`).

Tolerances, with their reasons: the loss and every gradient sum the same
products in another order through 2 blocks and their backward: loss 1e-6,
gradients 1e-5 of the largest entry of each tensor (plus 1e-8 where a tensor
vanishes). Parameters after AdamW steps: Adam divides by sqrt(v) + eps, so a
near-zero gradient turns its last-digit noise into a visible difference in
the update of that one entry (measured: 1-2 entries of ~10k per tensor,
up to 2.0e-5 at lr 1e-3; the JAX package's own masked-vs-unmasked step test
needs 5e-5 for this). So at most 0.1% of a tensor's entries may differ by
more than 2e-6, and none by more than 5e-5. The losses and gradient norms of
the second and third steps see those parameters: 1e-5 and rtol 5e-5
(measured 2.1e-6 and 7.8e-6). Schedules are
float64 here and float32 in JAX: rtol 1e-6, plus 1e-7 of the base lr where
1 + cos cancels near the end of the cosine (measured 1.2e-8). Table copies
(labels, masks, synthetic data, multiscale sizes) are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.data.loader import SyntheticDistillData as JaxSyntheticDistillData
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.train import ensemble as jensemble
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu.train import step as jstep
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.loader import SyntheticDistillData
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import (
    _eva_vision_key_map,
    _flatten,
    _text_key_map,
    load_weights,
    state_dict_from_jax,
)
from clipself_tpu_torch.train import ensemble, methods, optim, step

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
LAYERS = get_model_config(NAME).vision.layers
LOSS_TOL, GRAD_REL = 1e-6, 1e-5
PARAM_BULK, PARAM_BULK_SHARE, PARAM_MAX = 2e-6, 1e-3, 5e-5
LATER_LOSS_TOL, LATER_NORM_RTOL = 1e-5, 5e-5


@pytest.fixture(scope="module")
def jax_setup():
    jmodel, params = jax_create_model(NAME, dtype=jnp.float32, seed=0)
    return jmodel, jax.tree.map(np.asarray, params)


def _torch_model(params) -> CLIP:
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    return model


def _batch(seed, b=2, m=3, size=48, crop=32):
    """Seeded numpy batch: 48^2 images (a 6x6 grid, so the 4x4 pos-embed is
    resized), one padded box per image."""
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


def _jax_tree_to_torch(tree) -> dict:
    """A JAX param-shaped tree (params, grads, labels) -> {torch key: leaf},
    visual tower, text tower and logit_scale, leaves untransformed."""
    out = {_eva_vision_key_map(path)[0]: leaf for path, leaf in _flatten(tree["visual"]).items()}
    out.update({_text_key_map(path)[0]: leaf for path, leaf in _flatten(tree["text"]).items()})
    out["logit_scale"] = tree["logit_scale"]
    return out


def _frozen_model(params) -> CLIP:
    return _torch_model(params).requires_grad_(False)


def test_clipself_loss_and_trainable_grads_match_jax(jax_setup):
    jmodel, params = jax_setup
    batch = _batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmethods.clipself_loss(p, params, jbatch, jmodel), has_aux=True
    )(params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))  # transposed like the weights

    model = _torch_model(params)
    labels = optim.trainable_labels(model.state_dict().keys(), LAYERS, LAYERS)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = methods.clipself_loss(model, _frozen_model(params), tbatch)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    assert metrics["num_boxes"].item() == 4
    n_checked = 0
    for name, p in model.named_parameters():
        if labels[name] != "train":
            assert p.grad is None, name
            continue
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()  # outside the graph: zero in JAX
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + 1e-8, err_msg=name)
        n_checked += 1
    assert n_checked == sum(v == "train" for v in labels.values()) > 0


@pytest.mark.parametrize("unlocked", [1, LAYERS])
def test_labels_and_decay_mask_match_jax(jax_setup, unlocked):
    _, params = jax_setup
    model = _torch_model(params)
    jlabels = _jax_tree_to_torch(joptim.trainable_labels(params, unlocked, LAYERS))
    assert optim.trainable_labels(model.state_dict().keys(), unlocked, LAYERS) == jlabels
    jmask = _jax_tree_to_torch(joptim.no_decay_mask(params))
    assert optim.no_decay_mask(model.named_parameters()) == {k: bool(v) for k, v in jmask.items()}
    assert any(jmask.values()) and not all(jmask.values())


@pytest.mark.parametrize(
    "name,kw",
    [
        ("cosine", {}),
        ("const", {}),
        ("const-cooldown", dict(cooldown_steps=8, cooldown_power=1.5, cooldown_end_lr=1e-5)),
    ],
)
def test_schedules_match_jax(name, kw):
    want = joptim.make_schedule(name, 1e-3, 5, 20, **kw)
    got = optim.make_schedule(name, 1e-3, 5, 20, **kw)
    for s in range(21):
        np.testing.assert_allclose(
            got(s), float(want(s)), rtol=1e-6, atol=1e-7 * 1e-3, err_msg=f"step {s}"
        )


@pytest.mark.parametrize("unlocked,clip", [(1, None), (LAYERS, 0.05)])
def test_three_train_steps_match_jax(jax_setup, unlocked, clip):
    """Loss per step and every parameter after each of three steps against
    the JAX `make_train_step(mesh=None)`; the clip case clips (the first
    gradient's norm is above 0.05)."""
    jmodel, params = jax_setup
    batch = _batch(1)
    sched_kw = dict(base_lr=1e-3, warmup=1, total_steps=10)
    tx = joptim.build_optimizer(
        params, joptim.make_schedule("cosine", **sched_kw), wd=0.1, grad_clip_norm=clip,
        unlocked_groups=unlocked, num_layers=LAYERS,
    )
    jstep_fn = jstep.make_train_step(
        jmodel, tx, jmethods.clipself_loss, mesh=None, donate=False,
        trainable=joptim.trainable_labels(params, unlocked, LAYERS), log_grad_norm=True,
    )
    jstate = jstep.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = _torch_model(params)
    opt = optim.build_optimizer(
        model, optim.make_schedule("cosine", **sched_kw), wd=0.1, grad_clip_norm=clip,
        unlocked_groups=unlocked, num_layers=LAYERS,
    )
    state = step.TrainState(model, opt)
    step_fn = step.make_train_step(methods.clipself_loss, _frozen_model(params), log_grad_norm=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jmetrics = jstep_fn(jstate, params, jbatch, jax.random.PRNGKey(0))
        metrics = step_fn(state, tbatch)
        tol, rtol = (LOSS_TOL, 1e-6) if i == 0 else (LATER_LOSS_TOL, LATER_NORM_RTOL)
        assert abs(metrics["loss"].item() - float(jmetrics["loss"])) <= tol, i
        np.testing.assert_allclose(
            metrics["grad_norm"].item(), float(jmetrics["grad_norm"]), rtol=rtol
        )
        if clip is not None and i == 0:
            assert float(jmetrics["grad_norm"]) > clip
        want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in model.state_dict().items():
            diff = (p - want[name]).abs()
            assert diff.max().item() <= PARAM_MAX, f"{name} step {i}"
            assert (diff > PARAM_BULK).float().mean().item() <= PARAM_BULK_SHARE, f"{name} step {i}"
    assert state.step == 3 and int(jstate.step) == 3


def test_frozen_leaves_unchanged_and_logit_scale_clamped(jax_setup):
    _, params = jax_setup
    model = _torch_model(params)
    with torch.no_grad():
        model.logit_scale.fill_(5.0)  # above ln(100)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.build_optimizer(
        model, optim.make_schedule("const", 1e-3, 0, 10), unlocked_groups=1, num_layers=LAYERS
    )
    state = step.TrainState(model, opt)
    step.make_train_step(methods.clipself_loss, _frozen_model(params))(
        state, {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    )
    labels = optim.trainable_labels(before, 1, LAYERS)
    after = model.state_dict()
    for name, v in before.items():
        if name == "logit_scale":
            assert after[name].item() == pytest.approx(float(np.log(100.0)))
        elif labels[name] == "freeze":
            assert torch.equal(after[name], v), name
    moved = [n for n in before if labels[n] == "train" and not torch.equal(after[n], before[n])]
    assert moved and all(n.startswith(f"visual.blocks.{LAYERS - 1}.") for n in moved)
    assert not model.visual.pos_embed.requires_grad and model.visual.blocks[-1].mlp.w1.weight.requires_grad


def test_ensemble_matches_jax():
    rng = np.random.default_rng(4)
    s = {"a": rng.standard_normal(5).astype(np.float32), "b": rng.standard_normal((2, 3)).astype(np.float32)}
    t = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in s.items()}
    want = jensemble.student_teacher_ensemble(s, t, 0.7)
    got = ensemble.student_teacher_ensemble(
        {k: torch.from_numpy(v) for k, v in s.items()}, {k: torch.from_numpy(v) for k, v in t.items()}, 0.7
    )
    for k in s:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-7)


@pytest.mark.parametrize("det,patch", [(1024, 16), (896, 14), (640, 16), (512, 14)])
def test_multiscale_sizes_match_jax(det, patch):
    assert methods.multiscale_sizes(det, patch) == jmethods.multiscale_sizes(det, patch)


@pytest.mark.parametrize("target", [24, 40, 32])
def test_resize_images_for_scale_matches_jax(target):
    batch = _batch(3, size=32)
    want = jmethods.resize_images_for_scale({k: jnp.asarray(v) for k, v in batch.items()}, target)
    got = methods.resize_images_for_scale({k: torch.from_numpy(v) for k, v in batch.items()}, target)
    assert got["images"].shape == (2, target, target, 3)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), rtol=0, atol=1e-5)
    assert got["boxes"] is not None and np.array_equal(got["boxes"], batch["boxes"])


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_distill_data_equals_jax(seed):
    kw = dict(batch_size=2, det_size=32, crop_size=16, max_anns=3, seed=seed)
    got, want = SyntheticDistillData(**kw).batch, JaxSyntheticDistillData(**kw).batch
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert next(iter(SyntheticDistillData(**kw))) is not None


def test_optimizer_state_is_that_of_adamw_over_the_trainable_groups(jax_setup):
    _, params = jax_setup
    model = _torch_model(params)
    opt = optim.build_optimizer(
        model, optim.make_schedule("cosine", 1e-3, 2, 10), wd=0.2, unlocked_groups=1,
        num_layers=LAYERS,
    )
    n_train = sum(p.requires_grad for p in model.parameters())
    groups = opt.opt.param_groups
    assert [g["weight_decay"] for g in groups] == [0.2, 0.0]
    assert sum(len(g["params"]) for g in groups) == n_train == len(opt.params)
    assert groups[0]["lr"] == pytest.approx(5e-4)  # the schedule at update 0
