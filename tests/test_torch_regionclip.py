"""The port's RegionCLIP method and step (`train/methods.py::{_fed_class_mask,
regionclip_loss}`, `train/step.py`, gradient accumulation in
`train/optim.py`) against the JAX package on `EVA02-CLIP-Tiny-Test`, float32
on the CPU, the same weights on both sides (through `state_dict_from_jax`)
and the same class-sampling noise: the JAX package's own draws,
``jax.random.uniform(fold_in(PRNGKey(seed), step), (C,))``, handed to the
port as a tensor.

Tolerances, with their reasons: the class mask is discrete: EQUAL. The loss
sums the same BCE terms over 64 classes and 6 valid boxes in another order
(and optax's log-sigmoid form against torch's max-shifted one): 1e-5 of its
value. The gradients pass through the same products as the distill loss's
plus the [boxes, 64] logit product: 1e-4 of each tensor's largest entry (plus
1e-8 where a tensor vanishes). Parameters after AdamW: the bars of
`tests/test_torch_train_step.py` (at most 0.1% of a tensor's entries beyond
2e-6, none beyond 5e-5: Adam turns a near-zero gradient's last-digit noise
into a visible update), with one entry of any tensor allowed beyond 2e-6:
the accumulated mean of two micro-steps cancels to ~3e-7 at one entry of
the 64 of `visual.blocks.0.norm2.bias` (0.219 and its near negative), where
Adam's g / (|g| + 1e-8) moved by 1.95e-5 (measured); and the later steps'
losses within 1e-5 of their value. Step counts and learning rates are exact up to the float32 schedule
of JAX: rtol 1e-6.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu.train import step as jstep
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.train import methods, optim, step

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
LAYERS = get_model_config(NAME).vision.layers
C, SAMPLE, SEED = 64, 10, 3
LOSS_REL, GRAD_REL = 1e-5, 1e-4
PARAM_BULK, PARAM_BULK_SHARE, PARAM_MAX = 2e-6, 1e-3, 5e-5


def _jax_noise(step_index: int, c: int = C) -> np.ndarray:
    """The JAX train step's class-sampling draws at ``step_index``."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step_index)
    return np.asarray(jax.random.uniform(key, (c,)))


def _batch(seed, b=2, m=4, size=48, zero_pad=False):
    """Seeded [B, M, 6] region boxes (xyxy, label, valid) over 48^2 images:
    the last row of each image invalid, and the first image's second box a
    duplicate label of its first. The invalid rows keep a box, as the distill
    step's test batch does; ``zero_pad`` zeroes them as the dataset pads. The
    JAX package's gradient is NaN at a zero row (its RoI feature is zero, and
    the gradient of `l2_normalize` there is 0/0, times the row's zero weight),
    so only the port is run on zero rows
    (`test_zero_padded_rows_change_no_gradient`)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    labels = rng.integers(0, C, (b, m, 1)).astype(np.float64)
    labels[0, 1] = labels[0, 0]
    boxes = np.concatenate([xy, xy + wh, labels, np.ones((b, m, 1))], -1)
    boxes[:, -1, 5] = 0.0
    if zero_pad:
        boxes[:, -1] = 0.0
    return {
        "images": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "boxes": boxes.astype(np.float32),
    }


def _nouns(seed=7) -> np.ndarray:
    emb = np.random.default_rng(seed).standard_normal((C, 64)).astype(np.float32)
    return emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12)


@pytest.fixture(scope="module")
def setup():
    """The JAX model and weights, the noun matrix and ONE jitted
    value-and-grad of the JAX loss over the trainable leaves, shared by the
    cases."""
    jmodel, params = jax_create_model(NAME, dtype=jnp.float32, seed=0)
    params = jax.tree.map(np.asarray, params)
    nouns = _nouns()
    labels = joptim.trainable_labels(params, LAYERS, LAYERS)

    def loss(p, batch, rng):
        p = jax.tree.map(lambda x, l: x if l == "train" else jax.lax.stop_gradient(x), p, labels)
        return jmethods.regionclip_loss(
            p, None, batch, jmodel, rng, noun_embeddings=jnp.asarray(nouns), num_sample_cats=SAMPLE,
        )

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return jmodel, params, nouns, grad_fn


def _torch_model(params) -> CLIP:
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    labels = optim.trainable_labels(model.state_dict().keys(), LAYERS, LAYERS)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    return model


MASK_CASES = {
    # name: (labels, valid, num_sample)
    "padded_rows": ([5, 9, 0, 0], [1, 1, 0, 0], 6),
    "duplicates": ([5, 5, 9, 9, 9], [1, 1, 1, 1, 0], 4),
    "more_appeared_than_sampled": (list(range(0, 40, 3)), [1] * 14, 5),
    "invalid_row_ignored": ([63, 1], [0, 1], 10),
    "sample_every_class": ([2, 3], [1, 1], C),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_fed_class_mask_equals_jax(case):
    labels, valid, k = MASK_CASES[case]
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), len(labels))
    want = np.asarray(jmethods._fed_class_mask(
        jnp.asarray(labels, jnp.int32), jnp.asarray(valid, bool), C, k, key,
    ))
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (C,))))
    got = methods._fed_class_mask(
        torch.tensor(labels), torch.tensor(valid, dtype=torch.bool), C, k, noise,
    )
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    appeared = {lab for lab, v in zip(labels, valid) if v}
    assert appeared <= set(np.flatnonzero(want).tolist())
    assert want.sum() == max(k, len(appeared)) if k < C else want.all()


def test_fed_class_mask_ties_keep_the_lower_index_as_top_k():
    """Equal noise values: `jax.lax.top_k` keeps the lower index first; so
    does the port's stable sort."""
    labels, valid = jnp.asarray([1], jnp.int32), jnp.asarray([True])
    noise = np.full(C, 0.5, np.float32)
    noise[[10, 20]] = 0.9
    want = np.zeros(C, bool)
    want[[1, 10, 20, 0, 2]] = True  # 1 appeared, then 0.9s, then the lowest 0.5s
    orig = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape: jnp.asarray(noise)
        jmask = np.asarray(jmethods._fed_class_mask(labels, valid, C, 5, jax.random.PRNGKey(0)))
    finally:
        jax.random.uniform = orig
    got = methods._fed_class_mask(torch.tensor([1]), torch.tensor([True]), C, 5, torch.from_numpy(noise))
    assert np.array_equal(jmask, want) and np.array_equal(got.numpy(), want)


def test_fed_class_mask_more_samples_than_classes_raises_in_both():
    labels, valid = [1, 2], [1, 1]
    with pytest.raises(Exception):
        jmethods._fed_class_mask(
            jnp.asarray(labels, jnp.int32), jnp.asarray(valid, bool), 8, 9, jax.random.PRNGKey(0)
        )
    with pytest.raises(ValueError, match="num_sample 9 > num_classes 8"):
        methods._fed_class_mask(torch.tensor(labels), torch.tensor(valid, dtype=torch.bool), 8, 9,
                                torch.rand(8))


@pytest.mark.parametrize("step_index,weight", [(0, 1.0), (5, 0.5)])
def test_regionclip_loss_and_grads_match_jax(setup, step_index, weight):
    jmodel, params, nouns, grad_fn = setup
    batch = _batch(step_index)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), step_index)
    (jloss, jmetrics), jgrads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jloss = float(jloss) * weight  # the JAX loss at contrast_weight 1
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))

    model = _torch_model(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = methods.regionclip_loss(
        model, None, tbatch, step_index, noun_embeddings=torch.from_numpy(nouns),
        noise=torch.from_numpy(_jax_noise(step_index)), num_sample_cats=SAMPLE,
        contrast_weight=weight,
    )
    loss.backward()
    assert abs(loss.item() - jloss) <= LOSS_REL * abs(jloss)
    assert metrics["num_boxes"].item() == int(jmetrics["num_boxes"]) == 6
    assert metrics["loss_contrast"].item() == loss.item()
    n_checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        w = want[name].numpy() * weight
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()  # outside the graph: zero in JAX
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + 1e-8, err_msg=name)
        n_checked += 1
    assert n_checked > 0 and np.abs(want["visual.blocks.1.mlp.w3.weight"].numpy()).max() > 0


def _jax_step(setup, accum_steps, clip=None):
    jmodel, params, nouns, _ = setup
    sched = joptim.make_schedule("cosine", 1e-3, 1, 10)
    tx = joptim.build_optimizer(
        params, sched, wd=0.1, grad_clip_norm=clip, unlocked_groups=LAYERS, num_layers=LAYERS,
        accum_steps=accum_steps,
    )
    loss_fn = partial(jmethods.regionclip_loss, noun_embeddings=jnp.asarray(nouns), num_sample_cats=SAMPLE)
    step_fn = jstep.make_train_step(
        jmodel, tx, loss_fn, mesh=None, donate=False,
        trainable=joptim.trainable_labels(params, LAYERS, LAYERS),
    )
    return step_fn, jstep.TrainState.create(jax.tree.map(jnp.asarray, params), tx), sched


def _port_step(setup, accum_steps, clip=None):
    _, params, nouns, _ = setup
    model = _torch_model(params)
    opt = optim.build_optimizer(
        model, optim.make_schedule("cosine", 1e-3, 1, 10), wd=0.1, grad_clip_norm=clip,
        unlocked_groups=LAYERS, num_layers=LAYERS, accum_steps=accum_steps,
    )

    def loss_fn(model, teacher, batch, step_index):
        noise = torch.from_numpy(_jax_noise(step_index))  # the JAX step's own draw at this step
        return methods.regionclip_loss(
            model, teacher, batch, step_index, noun_embeddings=torch.from_numpy(nouns), noise=noise,
            num_sample_cats=SAMPLE,
        )

    return step.make_train_step(loss_fn, None), step.TrainState(model, opt)


def _assert_params_match(model, jparams, what, spare=0):
    """The bars of `test_torch_train_step.py`; ``spare`` entries of a tensor
    may pass the bulk bar on top of its share (still within PARAM_MAX)."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in model.state_dict().items():
        diff = (p - want[name]).abs()
        assert diff.max().item() <= PARAM_MAX, f"{name} {what}"
        beyond = (diff > PARAM_BULK).sum().item()
        assert beyond <= PARAM_BULK_SHARE * diff.numel() + spare, f"{name} {what}: {beyond}"


@pytest.mark.parametrize("clip", [None, 0.05])
def test_three_region_clip_steps_match_jax(setup, clip):
    """Loss per step and every parameter after each of three steps against
    the JAX `make_train_step(mesh=None)` with `regionclip_loss`: each step
    folds its index into the key, so each samples other classes."""
    jstep_fn, jstate, _ = _jax_step(setup, 1, clip)
    step_fn, state = _port_step(setup, 1, clip)
    batch = _batch(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    masks = set()
    for i in range(3):
        jstate, jmetrics = jstep_fn(jstate, None, jbatch, jax.random.PRNGKey(SEED))
        metrics = step_fn(state, tbatch)
        want = float(jmetrics["loss"])
        assert abs(metrics["loss"].item() - want) <= LOSS_REL * abs(want), i
        _assert_params_match(state.model, jstate.params, f"step {i}")
        labels = torch.from_numpy(batch["boxes"][..., 4].reshape(-1)).long()
        valid = torch.from_numpy(batch["boxes"][..., 5].reshape(-1) > 0.5)
        masks.add(tuple(methods._fed_class_mask(labels, valid, C, SAMPLE, torch.from_numpy(_jax_noise(i)))
                        .nonzero().flatten().tolist()))
    assert state.step == 3 and int(jstate.step) == 3
    assert len(masks) == 3  # the step index changes the sampled classes


def test_accum_freq_two_matches_optax_multisteps(setup):
    """`--accum-freq 2` over four micro-steps against `optax.MultiSteps`
    (the JAX `build_optimizer(accum_steps=2)`): the parameters after every
    micro-step (unchanged after the odd ones), the micro-step count, and the
    learning rate of the applied updates (the schedule at the inner count)."""
    jstep_fn, jstate, sched = _jax_step(setup, 2)
    step_fn, state = _port_step(setup, 2)
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    batches = [_batch(20 + i) for i in range(4)]
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep_fn(jstate, None, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.PRNGKey(SEED))
        metrics = step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = float(jmetrics["loss"])
        assert abs(metrics["loss"].item() - want) <= LOSS_REL * abs(want), i
        # one spare entry: where the mean of two micro-steps' gradients
        # cancels (an entry of norm2.bias at 1.95e-5), Adam's normalised
        # step magnifies the two sides' rounding of that mean
        _assert_params_match(state.model, jstate.params, f"micro-step {i}", spare=1)
        assert state.step == int(jstate.step) == i + 1
        updates = int(jstate.opt_state.inner_opt_state.inner_states["train"].inner_state[2].count)
        assert updates == int(jstate.opt_state.gradient_step) == (i + 1) // 2
        if updates:
            np.testing.assert_allclose(state.optimizer.lr, float(sched(updates - 1)), rtol=1e-6)
        if i == 0:  # the first micro-step only accumulates
            assert all(torch.equal(v, initial[k]) for k, v in state.model.state_dict().items())


def test_accumulated_gradients_survive_a_checkpoint(setup, tmp_path):
    """Resuming between two micro-steps of one update restores the running
    mean: the update after it equals the unbroken run's."""
    from clipself_tpu_torch.train import checkpoint as ckpt

    batches = [{k: torch.from_numpy(v) for k, v in _batch(30 + i).items()} for i in range(2)]
    step_fn, whole = _port_step(setup, 2)
    for b in batches:
        step_fn(whole, b)
    step_fn, first = _port_step(setup, 2)
    step_fn(first, batches[0])
    ckpt.save_checkpoint(str(tmp_path), first, None, 1)
    step_fn, resumed = _port_step(setup, 2)
    resumed, epoch = ckpt.restore_checkpoint(str(tmp_path), resumed)
    assert epoch == 1 and resumed.step == 1
    step_fn(resumed, batches[1])
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    _, plain = _port_step(setup, 1)
    with pytest.raises(ValueError, match="accumulation"):
        ckpt.restore_checkpoint(str(tmp_path), plain)


def test_zero_padded_rows_change_no_gradient(setup):
    """Rows padded with zeros, as `RegionCLIPDataset` pads them, give the
    gradients of the same batch whose invalid rows hold a box: finite, and
    equal within float32 summation noise (their weight is zero either way)."""
    _, params, nouns, _ = setup
    grads = []
    for zero_pad in (False, True):
        model = _torch_model(params)
        batch = {k: torch.from_numpy(v) for k, v in _batch(4, zero_pad=zero_pad).items()}
        loss, _ = methods.regionclip_loss(
            model, None, batch, noun_embeddings=torch.from_numpy(nouns),
            noise=torch.from_numpy(_jax_noise(4)), num_sample_cats=SAMPLE,
        )
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for name, g in grads[1].items():
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, grads[0][name], rtol=0, atol=1e-7 * g.abs().max().item() + 1e-12)


def test_fed_loss_noise_is_a_function_of_seed_and_step():
    a = methods.fed_loss_noise(0, 5, C, "cpu")
    assert a.shape == (C,) and a.dtype == torch.float32 and 0.0 <= a.min() and a.max() < 1.0
    assert torch.equal(a, methods.fed_loss_noise(0, 5, C, "cpu"))
    assert not torch.equal(a, methods.fed_loss_noise(0, 6, C, "cpu"))
    assert not torch.equal(a, methods.fed_loss_noise(1, 5, C, "cpu"))


def test_clipself_loss_ignores_the_step_index(setup):
    _, params, _, _ = setup
    model = _torch_model(params)
    rng = np.random.default_rng(0)
    batch = {
        "images": torch.from_numpy(rng.standard_normal((1, 32, 32, 3)).astype(np.float32)),
        "boxes": torch.tensor([[[0.1, 0.1, 0.6, 0.7, 1.0]]]),
        "crops": torch.from_numpy(rng.standard_normal((1, 1, 32, 32, 3)).astype(np.float32)),
    }
    a, _ = methods.clipself_loss(model, model, batch)
    b, _ = methods.clipself_loss(model, model, batch, 17)
    assert torch.equal(a, b)
