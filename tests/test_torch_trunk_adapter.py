"""The port's transformers trunk adapter (`clipself_tpu_torch/models/{hf_vit,trunk_adapter}.py`,
its branches of `models/{clip,torch_io}.py`, `train/optim.py`, the
trainer's default `--downsample-factor`) against the JAX package's
`FlaxTrunkAdapter`, float32 on the CPU, on the registry's
`hf-vit-tiny-test` (a 1-layer ViT of width 32, 2 heads, patch 8, at 32^2:
a 4x4 dense grid) with the class-token and the mean pool; and against
transformers' torch `ViTModel` as a second witness.

Every flax leaf is seeded noise (kernels of spread fan_in^-0.5, norm scales
around 1, other leaves 0.3), carried over with `state_dict_from_jax(params,
cfg)` and loaded strictly; the JAX side runs eagerly where one call is
cheaper than a compile.

Tolerances: outputs, logits and losses sum the same float32 products in
another order: 1e-4 absolute; gradients 1e-4 of each tensor's largest
entry plus 1e-6; tables (state dicts, labels) EQUAL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.eval import zero_shot as jzero_shot
from clipself_tpu.models.clip import CLIP as JCLIP
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu_torch.core.config import VisionConfig, get_model_config
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.eval import zero_shot
from clipself_tpu_torch.models import torch_io
from clipself_tpu_torch.models.clip import CLIP, dense_stride
from clipself_tpu_torch.models.trunk_adapter import TrunkAdapter, load_hf_trunk_params
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.train import main as train_main
from clipself_tpu_torch.train import methods, optim

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "hf-vit-tiny-test"
TOL = 1e-4
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6
POOLS = ("cls", "mean")
N_CLASSES = 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def cfgs(pool: str):
    """(JAX, port) configs of `hf-vit-tiny-test` with ``pool``."""
    return tuple(dataclasses.replace(c, vision=dataclasses.replace(c.vision, hf_trunk_pool=pool))
                 for c in (jget_model_config(NAME), get_model_config(NAME)))


def noise(shapes, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * z
        return np.float32(np.log(1 / 0.07)) + 0.1 * z if name == "logit_scale" else 0.3 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_MODELS: dict = {}


def models(pool: str):
    """(JAX CLIP, flax params, port CLIP with those weights), made once a pool."""
    if pool not in _MODELS:
        jcfg, cfg = cfgs(pool)
        jmodel = JCLIP(jcfg, dtype=jnp.float32)
        img, txt = np.zeros((1, 32, 32, 3), np.float32), np.zeros((1, 8), np.int32)
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img, txt))["params"]
        params = noise(shapes, seed=1)
        model = CLIP(cfg, torch.float32).eval()
        load_weights(model, state_dict_from_jax(params, cfg))
        _MODELS[pool] = (jmodel, params, model)
    return _MODELS[pool]


def inputs(seed: int = 0, m: int = 5):
    """Images [2, 32, 32, 3], boxes [2, m, 4] (one of zero area) and masks
    [2, m, 4, 4] on the dense grid (one empty)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.6, (2, m, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (2, m, 2))], -1).astype(np.float32)
    boxes[0, 1] = [0.3, 0.3, 0.3, 0.3]
    masks = (rng.uniform(size=(2, m, 4, 4)) < 0.5).astype(np.float32)
    masks[1, 0] = 0.0
    return img, boxes, masks


def _visual_mask_pool(module, image, masks):
    return module.visual.mask_pool(image, masks)


def _cases():
    """name -> (JAX method, its arguments, the port's call on the port CLIP)."""
    img, boxes, masks = inputs()
    ti, tb, tm = (torch.from_numpy(a) for a in (img, boxes, masks))
    return {
        "encode_image": ("encode_image", (img, True), lambda m: m.encode_image(ti, True)),
        "encode_dense": ("encode_dense", (img, False, True), lambda m: m.encode_dense(ti, keep_shape=True)),
        "extract_roi_features": ("encode_pseudo_boxes", (img, boxes), lambda m: m.encode_pseudo_boxes(ti, tb)),
        "mask_pool": (_visual_mask_pool, (img, masks), lambda m: m.visual.mask_pool(ti, tm)),
        "encode_masks": ("encode_masks", (img, masks), lambda m: m.encode_masks(ti, tm)),
        "encode_rois_and_image": ("encode_rois_and_image", (img, boxes),
                                  lambda m: m.encode_rois_and_image(ti, tb)),
        "encode_rois_and_masks": ("encode_rois_and_masks", (img, boxes, masks),
                                  lambda m: m.encode_rois_and_masks(ti, tb, tm)),
    }


CASES = _cases()


def _close(got, want, tol=TOL):
    if isinstance(got, tuple):
        for g, w in zip(got, want, strict=True):
            _close(g, w, tol)
        return
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("pool", POOLS)
def test_adapter_matches_jax(pool, case):
    jmodel, params, model = models(pool)
    method, args, call = CASES[case]
    want = jmodel.apply({"params": params}, *args, method=method)
    with torch.no_grad():
        got = call(model)
    _close(got, jax.tree.map(np.asarray, want))


def test_evaluator_batch_matches_jax():
    """One evaluator batch (RoIs and masks from the shared dense pass,
    crops through the class token): `batch_logits` against the JAX
    evaluator's jitted batch, then `evaluate_zero_shot`'s metrics EQUAL."""
    jmodel, params, model = models("cls")
    batch = synthetic_panoptic_batch(0, batch=2, image_size=32, max_anns=6, valid_anns=4, crop_size=32,
                                     mask_hw=32 // dense_stride(model.cfg.vision), n_classes=N_CLASSES, seed=3)
    emb = class_embeddings(N_CLASSES, 16, seed=3)
    e = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12)
    arrays = [batch["images"], batch["boxes"][..., :4], batch["crops"], batch["gt_masks"]]
    want = jzero_shot._make_batch_features(jmodel, "v2", False)(
        params, jnp.asarray(e), *(jnp.asarray(a) for a in arrays))
    got = zero_shot.batch_logits(model, torch.from_numpy(e), *(torch.from_numpy(a) for a in arrays))
    _close(tuple(got), tuple(np.asarray(w) for w in want))
    jres = jzero_shot.evaluate_zero_shot(jmodel, params, [batch], emb, ann_bucket=0)
    res = zero_shot.evaluate_zero_shot(model, [batch], emb, device="cpu", ann_bucket=0)
    assert len(res) == 12
    np.testing.assert_equal(res, jres)


def _distill_batch(seed=0, b=2, m=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.2, 0.5, (b, m, 2)), np.ones((b, m, 1))], -1)
    boxes[:, -1, 4] = 0.0  # an invalid row that keeps its box
    return {
        "images": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "crops": rng.standard_normal((b, m, 32, 32, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("pool", POOLS)
def test_distill_loss_and_grads_match_jax(pool):
    """The distill loss with the image tower unlocked (`--no-lock-image`:
    under the lock no adapter parameter trains, as in JAX), and every
    trainable gradient, against JAX."""
    jmodel, params, _ = models(pool)
    _, cfg = cfgs(pool)
    batch = _distill_batch(1)
    jlabels = joptim.trainable_labels(params, 0, 12, lock_image=False)

    def loss(p):
        p = jax.tree.map(lambda x, lab: x if lab == "train" else jax.lax.stop_gradient(x), p, jlabels)
        return jmethods.clipself_loss(p, params, batch, jmodel)[0]

    jloss, jgrads = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(loss))(params))
    model = CLIP(cfg, torch.float32)
    load_weights(model, state_dict_from_jax(params, cfg))
    teacher = CLIP(cfg, torch.float32).requires_grad_(False)
    load_weights(teacher, state_dict_from_jax(params, cfg))
    labels = optim.trainable_labels(list(model.state_dict()), 0, 12, lock_image=False)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    tloss, _ = methods.clipself_loss(model, teacher, {k: torch.from_numpy(v) for k, v in batch.items()})
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL
    want = state_dict_from_jax(jgrads, cfg)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=GRAD_REL * np.abs(w).max() + GRAD_FLOOR,
                                   err_msg=name)
        checked += 1
    assert checked == sum(k.startswith("visual.") for k in labels) > 0


@pytest.mark.parametrize("lock_image", [True, False], ids=["locked", "unlocked"])
def test_state_dict_round_trip_and_labels_equal_jax(lock_image):
    """JAX params -> the port strictly -> back, leaf by leaf: EQUAL; the
    lock labels (under the lock every adapter parameter freezes, as no block
    pattern matches; without it all of `visual` trains) and the decay mask
    key for key EQUAL to the JAX package's."""
    _, params, model = models("cls")
    _, cfg = cfgs("cls")
    sd = model.state_dict()
    flat = torch_io._flatten(params)
    for path, leaf in flat.items():
        key, transform = torch_io.flax_to_torch_key(path, cfg)
        back = sd[key].numpy()
        back = back.T if transform == "linear" else back.transpose(2, 3, 1, 0) if transform == "conv" else back
        np.testing.assert_array_equal(back, leaf, err_msg=key)
    assert {torch_io.flax_to_torch_key(p, cfg)[0] for p in flat} == set(sd)
    tkey = {p: torch_io.flax_to_torch_key(p, cfg)[0] for p in flat}
    labels = joptim.trainable_labels(params, 2, 12, lock_image=lock_image)
    want = {tkey[p]: v for p, v in torch_io._flatten(labels).items()}
    got = optim.trainable_labels(list(sd), 2, 12, lock_image=lock_image)
    assert got == want
    visual = {k for k in got if k.startswith("visual.")}
    assert {k for k, v in got.items() if v == "train"} == (set() if lock_image else visual)
    decay = {tkey[p]: bool(v) for p, v in torch_io._flatten(joptim.no_decay_mask(params)).items()}
    assert optim.no_decay_mask(model.named_parameters()) == decay


def test_trunk_equals_transformers_vit():
    """The second witness: transformers' torch `ViTModel` (no pooler)
    loaded strictly with the port's trunk state dict gives its hidden
    states; `load_hf_trunk_params` takes a `ViTModel` state dict with a
    pooler (dropped) and a `head.weight` into a port CLIP, whose image
    embedding is then the class token through that head."""
    tf = pytest.importorskip("transformers")
    _, _, model = models("cls")
    c = model.visual.hf_config
    hf_cfg = tf.ViTConfig(**{k: getattr(c, k) for k in (
        "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size", "image_size",
        "patch_size", "num_channels")})
    hf_cfg._attn_implementation = "eager"
    hf = tf.ViTModel(hf_cfg, add_pooling_layer=False).eval()
    hf.load_state_dict(model.visual.trunk.state_dict(), strict=True)
    img = torch.from_numpy(inputs()[0])
    with torch.no_grad():
        _close(model.visual.trunk(img), hf(img.permute(0, 3, 1, 2)).last_hidden_state.numpy())
        torch.manual_seed(1)
        fresh = tf.ViTModel(hf_cfg, add_pooling_layer=True).eval()
        head = torch.randn(16, 32) * 0.1
        other = CLIP(get_model_config(NAME), torch.float32).eval()
        load_hf_trunk_params({**fresh.state_dict(), "head.weight": head}, other)
        want = fresh(img.permute(0, 3, 1, 2)).last_hidden_state[:, 0] @ head.T
        _close(other.encode_image(img), want.numpy())
    with pytest.raises(ValueError, match="missing"):
        load_hf_trunk_params({k: v for k, v in fresh.state_dict().items() if "layernorm." not in k}, other)


def test_dense_stride_and_the_trainers_default_grid(tmp_path):
    """The dense map's stride is the HF config's patch (8), not the
    config's `patch_size` (16); the trainer's default `--downsample-factor`
    is that stride (the JAX trainer's `patch_size` puts `--val-data` masks
    on a 2x2 grid against the 4x4 dense map and fails in `mask_pool`); one
    `--no-lock-image` distill step trains every adapter parameter."""
    cfg = get_model_config(NAME)
    assert (dense_stride(cfg.vision), cfg.vision.patch_size) == (8, 16)
    run = train_main.main([
        "--device", "cpu", "--synthetic", "--model", NAME, "--no-lock-image", "--batch-size", "1",
        "--det-image-size", "32", "--max-boxes", "2", "--steps-per-epoch", "1", "--epochs", "1",
        "--lr", "1e-3", "--warmup", "1", "--logs", str(tmp_path), "--name", "hf",
    ])
    assert "downsample_factor: 8" in (tmp_path / "hf" / "params.txt").read_text()
    assert np.isfinite(run["history"][-1]["loss"])
    student, teacher = run["state"].model, run["teacher"].state_dict()
    moved = {n for n, p in student.named_parameters() if not torch.equal(p, teacher[n])}
    assert moved == {n for n, _ in student.named_parameters() if n.startswith("visual.")}


def test_trunk_takes_its_config_size_and_names_a_hub_trunk():
    """The position embeddings are never resized: another image size
    raises; a hub id raises OSError naming its config.json."""
    _, _, model = models("cls")
    with torch.no_grad(), pytest.raises(ValueError, match="never resized"):
        model.encode_image(torch.zeros(1, 48, 48, 3))
    hub = VisionConfig(image_size=224, hf_trunk_name="google/vit-base-patch16-224")
    with pytest.raises(OSError, match="config.json"):
        TrunkAdapter(hub, 16)


def test_grad_checkpointing_changes_nothing():
    """`grad_checkpointing` recomputes each trunk layer in the backward
    pass: the same dense map and the same gradients."""
    _, params, _ = models("mean")
    _, cfg = cfgs("mean")
    img = torch.from_numpy(inputs()[0])
    outs = []
    for recompute in (False, True):
        model = CLIP(cfg, torch.float32, grad_checkpointing=recompute)
        load_weights(model, state_dict_from_jax(params, cfg))
        dense = model.encode_dense(img, keep_shape=True)
        (dense * torch.linspace(-1, 1, dense.shape[-1])).sum().backward()
        outs.append((dense.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}))
    (d0, g0), (d1, g1) = outs
    assert torch.equal(d0, d1) and g0.keys() == g1.keys() and len(g0) > 0
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, rtol=0, atol=1e-6, msg=name)
