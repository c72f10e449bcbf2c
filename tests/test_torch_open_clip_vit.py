"""The port's plain OpenCLIP ViT tower (`clipself_tpu_torch/models/open_clip_vit.py`,
the ViT branches of `models/clip.py`, `models/torch_io.py`, `train/optim.py`,
`train/methods.py`, `eval/zero_shot.py` and the trainer's `--extract-type`
and `--force-quick-gelu`) against the JAX package on `ViT-Tiny-Test` (2
blocks, width 64, head width 32, 32^2 images, patch 8), float32 on the CPU.
Every flax leaf of one JAX init is replaced by seeded noise and carried over
with `state_dict_from_jax`.

Tolerances: whole-tower outputs, losses and gradients sum the same products
in another order through two blocks (and their backward): 1e-4 absolute
(gradients: 1e-4 of each tensor's largest entry, plus 1e-8 where one
vanishes); tables (state dicts, cell masks, lock and decay labels) EQUAL.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.eval.zero_shot import evaluate_zero_shot as jevaluate_zero_shot
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.models.open_clip_vit import OpenCLIPViT as JOpenCLIPViT
from clipself_tpu.ops.attention import multi_head_attention as jmulti_head_attention
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
from clipself_tpu_torch.models import torch_io
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.factory import create_model, model_class
from clipself_tpu_torch.models.open_clip_vit import OpenCLIPViT
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.ops.attention import multi_head_attention
from clipself_tpu_torch.train import main as train_main
from clipself_tpu_torch.train import methods, optim

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "ViT-Tiny-Test"
LAYERS = get_model_config(NAME).vision.layers
TOL = 1e-4
GRAD_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's cases on one torch thread, restored after: more threads
    only fight the other test workers for the cores, and the setting is the
    process's, so another module must not inherit it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cfgs(get):
    """The tiny config and its variants, from one package's registry."""
    cfg = get(NAME)
    vis = cfg.vision
    return {
        "base": cfg,
        "quick_gelu": dataclasses.replace(cfg, vision=dataclasses.replace(vis, quick_gelu=True)),
        "layer_scale": dataclasses.replace(cfg, vision=dataclasses.replace(vis, ls_init_value=0.5)),
    }


def _noisy(tree, rng):
    """Every leaf replaced by seeded noise of about its own spread (0.1 where
    the init is constant), around the init: no bias stays zero, no LayerNorm
    scale stays one."""
    def leaf(x):
        x = np.asarray(x, np.float32)
        return (x + rng.standard_normal(x.shape).astype(np.float32) * (float(x.std()) or 0.1)).astype(np.float32)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def towers():
    """variant -> (jax model, params as numpy, port CLIP with those weights),
    from ONE JAX init (the layer-scale variant adds its gammas)."""
    jcfgs, cfgs = _cfgs(jget_model_config), _cfgs(get_model_config)
    _, base = jax_create_model(jcfgs["base"], dtype=jnp.float32, seed=0)
    rng = np.random.default_rng(11)
    base = _noisy(jax.tree.map(np.asarray, base), rng)
    out = {}
    for key, jcfg in jcfgs.items():
        jmodel, _ = jax_create_model(jcfg, dtype=jnp.float32, init=False)
        params = base
        if key == "layer_scale":
            params = {**base, "visual": dict(base["visual"])}
            for i in range(LAYERS):
                blk = params["visual"][f"resblocks_{i}"] = dict(base["visual"][f"resblocks_{i}"])
                for ls in ("ls_1", "ls_2"):
                    blk[ls] = {"gamma": rng.uniform(0.2, 1.5, jcfg.vision.width).astype(np.float32)}
        model = CLIP(cfgs[key], torch.float32).eval()
        load_weights(model, state_dict_from_jax(params))
        out[key] = (jmodel, params, model)
    return out


def _inputs(size: int, seed: int = 0, m: int = 6):
    """Images, boxes [2, m, 4] (one zero-area box, one that covers no grid
    cell) and cell masks [2, m, g, g] (one all empty)."""
    rng = np.random.default_rng(seed + size)
    g = size // 8
    img = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.6, (2, m, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (2, m, 2))], -1).astype(np.float32)
    boxes[0, 1] = [0.3, 0.3, 0.3, 0.3]  # zero area
    boxes[1, 2] = [0.51, 0.51, 0.55, 0.55]  # floors to an empty cell range
    masks = (rng.uniform(size=(2, m, g, g)) < 0.3).astype(np.float32)
    masks[1, 0] = 0.0
    return img, boxes, masks


def _forward_tokens(m, x):
    return m.visual.forward_tokens(x)


def _forward_cases() -> dict:
    """name -> (variant, JAX method, its arguments) of every forward case the
    tests below compare."""
    cases = {}
    for size in (32, 48):  # 48^2 resizes the 4x4 pos-embed grid to 6x6
        img, _, _ = _inputs(size)
        cases[f"encode_image-{size}"] = ("base", "encode_image", (img, True))
        cases[f"encode_dense-{size}"] = ("base", "encode_dense", (img, False, True))
        cases[f"forward_tokens-{size}"] = ("base", _forward_tokens, (img,))
    img, boxes, masks = _inputs(48)
    for et in ("v1", "v2", "v3"):
        cases[f"rois-{et}"] = ("base", "encode_pseudo_boxes", (img, boxes, False, et))
    for mask_attn in (True, False):
        cases[f"masks-{mask_attn}"] = ("base", "encode_masks", (img, masks, True, mask_attn))
    img, boxes, _ = _inputs(32)
    cases["rois_and_image"] = ("base", "encode_rois_and_image", (img, boxes))
    img, boxes, masks = _inputs(48, seed=1)
    for et in ("v1", "v2"):  # as the evaluator calls it: mask-attention pooling with v1
        cases[f"rois_and_masks-{et}"] = (
            "base", "encode_rois_and_masks", (img, boxes, masks, True, et, et == "v1"))
    img, boxes, _ = _inputs(32, seed=2)
    for variant in ("quick_gelu", "layer_scale"):
        cases[f"{variant}-encode_image"] = (variant, "encode_image", (img, False))
        cases[f"{variant}-encode_dense"] = (variant, "encode_dense", (img, False, True))
        cases[f"{variant}-rois-v1"] = (variant, "encode_pseudo_boxes", (img, boxes, False, "v1"))
    return cases


@pytest.fixture(scope="module")
def jax_refs(towers):
    """name -> the JAX package's output of each of `_forward_cases`, all
    from ONE jitted call (traced under `jax.ensure_compile_time_eval`, as
    `_jit_loss` explains), with the weights and arrays as its arguments."""
    cases = _forward_cases()
    arrays = [[a for a in args if isinstance(a, np.ndarray)] for _, _, args in cases.values()]

    def run(params, arrays):
        out = {}
        with jax.ensure_compile_time_eval():
            for (name, (variant, method, args)), arrs in zip(cases.items(), arrays):
                it = iter(arrs)
                args = [next(it) if isinstance(a, np.ndarray) else a for a in args]
                out[name] = towers[variant][0].apply({"params": params[variant]}, *args, method=method)
        return out

    params = {key: towers[key][1] for key in ("base", "quick_gelu", "layer_scale")}
    return jax.tree.map(np.asarray, jax.jit(run)(params, arrays))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_state_dict_from_jax_equals_export_state_dict(towers):
    """Every key of the whole CLIP, with and without LayerScale, EQUAL to the
    JAX package's export; the port's module tree has exactly these keys."""
    for key in ("base", "layer_scale"):
        _, params, model = towers[key]
        ref = jtorch_io.export_state_dict(params, _cfgs(jget_model_config)[key])
        sd = state_dict_from_jax(params)
        assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
        assert "visual.transformer.resblocks.1.attn.in_proj_weight" in sd
        assert ("visual.transformer.resblocks.0.ls_1.gamma" in sd) == (key == "layer_scale")
        for k, v in sd.items():
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("size", [32, 48])  # 48^2 resizes the 4x4 pos-embed grid to 6x6
@pytest.mark.parametrize("method", ["encode_image", "encode_dense", "forward_tokens"])
def test_tower_matches_jax(towers, jax_refs, size, method):
    _, _, model = towers["base"]
    img, _, _ = _inputs(size)
    ti = torch.from_numpy(img)
    with torch.no_grad():
        if method == "encode_image":
            got = model.encode_image(ti, normalize=True)
        elif method == "encode_dense":
            got = model.encode_dense(ti, keep_shape=True)
        else:
            got = model.visual.forward_tokens(ti)
    _close(got, jax_refs[f"{method}-{size}"])


@pytest.mark.parametrize("extract_type", ["v1", "v2", "v3"])
def test_extract_roi_features_matches_jax(towers, jax_refs, extract_type):
    _, _, model = towers["base"]
    img, boxes, _ = _inputs(48)
    want = jax_refs[f"rois-{extract_type}"]
    with torch.no_grad():
        got = model.encode_pseudo_boxes(torch.from_numpy(img), torch.from_numpy(boxes),
                                        extract_type=extract_type)
    if extract_type == "v3":
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_boxes_to_grid_masks_equal_jax():
    rng = np.random.default_rng(3)
    boxes = np.sort(rng.uniform(0, 1, (3, 7, 2, 2)), axis=2).transpose(0, 1, 3, 2).reshape(3, 7, 4)
    boxes = boxes[..., [0, 2, 1, 3]].astype(np.float32)  # x0 y0 x1 y1
    boxes[0, 0] = [0.25, 0.25, 0.25, 0.75]
    boxes[0, 1] = [0.0, 0.0, 1.0, 1.0]
    to_masks = jax.jit(JOpenCLIPViT.boxes_to_grid_masks, static_argnums=(1, 2))
    for gh, gw in ((4, 4), (6, 5)):
        want = np.asarray(to_masks(jnp.asarray(boxes), gh, gw))
        got = OpenCLIPViT.boxes_to_grid_masks(torch.from_numpy(boxes), gh, gw).numpy()
        np.testing.assert_array_equal(got, want)
    assert not got[0, 0].any() and got[0, 1].all()


@pytest.mark.parametrize("mask_attn", [True, False], ids=["mask_attn", "mask_pool"])
def test_encode_masks_matches_jax(towers, jax_refs, mask_attn):
    _, _, model = towers["base"]
    img, _, masks = _inputs(48)
    with torch.no_grad():
        got = model.encode_masks(torch.from_numpy(img), torch.from_numpy(masks), mask_attn=mask_attn)
    _close(got, jax_refs[f"masks-{mask_attn}"])


def test_encode_rois_and_image_matches_jax(towers, jax_refs):
    _, _, model = towers["base"]
    img, boxes, _ = _inputs(32)
    with torch.no_grad():
        got = model.encode_rois_and_image(torch.from_numpy(img), torch.from_numpy(boxes))
    for g, w in zip(got, jax_refs["rois_and_image"]):
        _close(g, w)


@pytest.mark.parametrize("extract_type", ["v1", "v2"])
def test_encode_rois_and_masks_matches_jax(towers, jax_refs, extract_type):
    """As the evaluator calls it: mask-attention pooling with v1."""
    _, _, model = towers["base"]
    img, boxes, masks = _inputs(48, seed=1)
    mask_attn = extract_type == "v1"
    want = jax_refs[f"rois_and_masks-{extract_type}"]
    with torch.no_grad():
        got = model.encode_rois_and_masks(
            torch.from_numpy(img), torch.from_numpy(boxes), torch.from_numpy(masks),
            extract_type=extract_type, mask_attn=mask_attn,
        )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("variant", ["quick_gelu", "layer_scale"])
def test_variants_match_jax(towers, jax_refs, variant):
    _, _, model = towers[variant]
    img, boxes, _ = _inputs(32, seed=2)
    ti, tb = torch.from_numpy(img), torch.from_numpy(boxes)
    with torch.no_grad():
        _close(model.encode_image(ti), jax_refs[f"{variant}-encode_image"])
        _close(model.encode_dense(ti, keep_shape=True), jax_refs[f"{variant}-encode_dense"])
        _close(model.encode_pseudo_boxes(ti, tb, extract_type="v1"), jax_refs[f"{variant}-rois-v1"])
    if variant == "layer_scale":
        assert model.visual.blocks[0].ls_1.gamma.std() > 0.1  # not the init value


def test_multi_head_attention_dispatch_matches_jax():
    """With an additive mask both packages take the plain (XLA) attention;
    without one the JAX package's CPU path is XLA too, the port's the flash
    kernel's plain version: the same values."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 11, 2, 32)).astype(np.float32) for _ in range(3))
    mask = np.where(rng.uniform(size=(2, 1, 11, 11)) < 0.3, -1e9, 0.0).astype(np.float32)
    mask[..., 0] = 0.0  # every row sees a token
    for m in (mask, None):
        want = jmulti_head_attention(*(jnp.asarray(a) for a in (q, k, v)), 32 ** -0.5,
                                     mask=None if m is None else jnp.asarray(m))
        got = multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), 32 ** -0.5,
                                   None if m is None else torch.from_numpy(m))
        _close(got, want)


def test_grad_checkpointing_changes_nothing(towers):
    _, params, _ = towers["base"]
    img, boxes, _ = _inputs(32, seed=4)
    grads = []
    for ckpt in (False, True):
        model = CLIP(get_model_config(NAME), torch.float32, grad_checkpointing=ckpt)
        load_weights(model, state_dict_from_jax(params))
        model.encode_pseudo_boxes(torch.from_numpy(img), torch.from_numpy(boxes),
                                  extract_type="v1").sum().backward()
        model.encode_dense(torch.from_numpy(img)).sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=1e-6)


def test_load_pretrained_resizes_positional_embedding(towers, tmp_path):
    """`--pretrained` of a reference checkpoint whose positional embedding is
    on a 6x6 grid (the model's is 4x4) and which lacks `visual.proj`: the
    JAX `load_pretrained` of it, key for key EQUAL."""
    _, params, _ = towers["base"]
    cfg = jget_model_config(NAME)
    params1 = _noisy(params, np.random.default_rng(1))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jtorch_io.export_state_dict(params, cfg).items()}
    del sd["visual.proj"]
    sd["visual.positional_embedding"] = torch.from_numpy(
        np.random.default_rng(0).standard_normal((37, 64)).astype(np.float32))
    path = str(tmp_path / "ref.pt")
    torch.save({"state_dict": sd}, path)
    want = state_dict_from_jax(jtorch_io.load_pretrained(path, params1, cfg))
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params1))
    assert torch_io.load_pretrained(model, path) == ["visual.proj"]
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert got["visual.positional_embedding"].shape == (17, 64)


@pytest.mark.parametrize("unlocked", [0, 1, 2])
def test_lock_and_decay_labels_equal_jax(towers, unlocked):
    """`trainable_labels` and `no_decay_mask` over the whole ViT CLIP, key
    for key EQUAL to the JAX package's over its tree (through the key map);
    under lock the stem, embeddings, `ln_post` and `proj` stay frozen."""
    _, params, model = towers["base"]
    flat_labels = torch_io._flatten(joptim.trainable_labels(params, unlocked, LAYERS))
    flat_decay = torch_io._flatten(joptim.no_decay_mask(params))
    key_maps = {"visual": torch_io._vision_key_map, "text": torch_io._text_key_map}

    def tkey(path):
        return "logit_scale" if path == ("logit_scale",) else key_maps[path[0]](path[1:])[0]

    want_labels = {tkey(p): v for p, v in flat_labels.items()}
    want_decay = {tkey(p): bool(v) for p, v in flat_decay.items()}
    names = list(model.state_dict())
    assert optim.trainable_labels(names, unlocked, LAYERS) == want_labels
    assert optim.no_decay_mask(model.named_parameters()) == want_decay
    train = {k for k, v in want_labels.items() if v == "train"}
    assert len(train) == 12 * unlocked  # 12 tensors a block
    for k in ("visual.conv1.weight", "visual.class_embedding", "visual.positional_embedding",
              "visual.ln_post.weight", "visual.proj"):
        assert want_labels[k] == "freeze"
    assert want_decay["visual.proj"] and want_decay["visual.positional_embedding"]
    assert not want_decay["visual.class_embedding"]


def _distill_batch(seed=0, b=2, m=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.15, 0.5, (b, m, 2)), np.ones((b, m, 1))], -1)
    boxes[:, -1, 4] = 0.0  # an invalid row that keeps its box
    return {
        "images": rng.standard_normal((b, 48, 48, 3)).astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "crops": rng.standard_normal((b, m, 32, 32, 3)).astype(np.float32),
    }


def _region_batch(seed=0, b=2, m=4, classes=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    labels = rng.integers(0, classes, (b, m, 1)).astype(np.float64)
    boxes = np.concatenate([xy, xy + rng.uniform(0.15, 0.5, (b, m, 2)), labels, np.ones((b, m, 1))], -1)
    boxes[:, -1, 5] = 0.0
    return {"images": rng.standard_normal((b, 48, 48, 3)).astype(np.float32),
            "boxes": boxes.astype(np.float32)}


def _trainable(params, model):
    labels = joptim.trainable_labels(params, LAYERS, LAYERS)
    tlabels = optim.trainable_labels(model.state_dict().keys(), LAYERS, LAYERS)
    for name, p in model.named_parameters():
        p.requires_grad_(tlabels[name] == "train")
    return labels


def _check_grads(model, jgrads):
    """Every trainable gradient of the port within `GRAD_REL` of the largest
    entry of the JAX package's, carried to the torch layout."""
    key_maps = {"visual": torch_io._vision_key_map, "text": torch_io._text_key_map}
    want = {}
    for path, v in torch_io._flatten(jax.tree.map(np.asarray, jgrads)).items():
        if path[0] in key_maps:
            key, transform = key_maps[path[0]](path[1:])
            want[key] = v.T if transform == "linear" else v.transpose(3, 2, 0, 1) if transform == "conv" else v
    got = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert got and all(g is not None for g in got.values())
    for name, g in got.items():
        w = want[name]
        bar = GRAD_REL * float(np.abs(w).max()) + 1e-8
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=bar, err_msg=name)


def _jit_loss(loss_fn, labels):
    """One jitted value-and-grad of a JAX loss ``loss_fn(params, teacher
    params, batch)`` over the trainable leaves. Traced under
    `jax.ensure_compile_time_eval`: the JAX package's v1 mask takes
    ``neg.item()`` of a constant (`clipself_tpu/models/open_clip_vit.py:345`),
    which a plain `jax.jit` trace turns into a tracer and refuses; with the
    context the constant stays concrete (the weights and batch are
    arguments, so nothing else is evaluated at trace time)."""

    def loss(p, tp, batch):
        p = jax.tree.map(lambda x, l: x if l == "train" else jax.lax.stop_gradient(x), p, labels)
        with jax.ensure_compile_time_eval():
            return loss_fn(p, tp, batch)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("extract_type", ["v1", "v2"])
def test_clipself_loss_matches_jax(towers, extract_type):
    jmodel, params, _ = towers["base"]
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    teacher = CLIP(get_model_config(NAME), torch.float32).requires_grad_(False)
    load_weights(teacher, state_dict_from_jax(params))
    labels = _trainable(params, model)
    batch = _distill_batch(1)

    grad_fn = _jit_loss(partial(jmethods.clipself_loss, model=jmodel, extract_type=extract_type), labels)
    (jloss, _), jgrads = grad_fn(params, params, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, _ = methods.clipself_loss(model, teacher, tb, extract_type=extract_type)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL
    _check_grads(model, jgrads)


@pytest.mark.parametrize("extract_type", ["v1", "v2"])
def test_regionclip_loss_matches_jax(towers, extract_type):
    jmodel, params, _ = towers["base"]
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    labels = _trainable(params, model)
    batch = _region_batch(2)
    nouns = np.random.default_rng(7).standard_normal((64, 64)).astype(np.float32)
    nouns /= np.linalg.norm(nouns, axis=-1, keepdims=True) + 1e-12
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, (64,)))

    grad_fn = _jit_loss(
        lambda p, tp, b: jmethods.regionclip_loss(
            p, tp, b, jmodel, key, noun_embeddings=jnp.asarray(nouns), num_sample_cats=10,
            extract_type=extract_type,
        ),
        labels,
    )
    (jloss, _), jgrads = grad_fn(params, None, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, _ = methods.regionclip_loss(model, None, tb, noun_embeddings=torch.from_numpy(nouns),
                                       noise=torch.from_numpy(noise), num_sample_cats=10,
                                       extract_type=extract_type)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL * max(1.0, abs(float(jloss)))
    _check_grads(model, jgrads)


@pytest.mark.parametrize("extract_type", ["v1", "v2"])
def test_evaluate_zero_shot_matches_jax(towers, extract_type):
    jmodel, params, model = towers["base"]
    batches = [
        synthetic_panoptic_batch(i, batch=2, image_size=48, max_anns=8, valid_anns=5,
                                 crop_size=32, mask_hw=6, n_classes=7)
        for i in range(1)
    ]
    emb = class_embeddings(7, 64)
    with jax.ensure_compile_time_eval():  # see `_jit_loss`
        want = jevaluate_zero_shot(jmodel, params, batches, emb, extract_type=extract_type, ann_bucket=0)
    got = evaluate_zero_shot(model, batches, emb, device="cpu", ann_bucket=0, extract_type=extract_type)
    assert got.keys() == want.keys() and len(got) == 12
    for k, v in want.items():
        assert got[k] == pytest.approx(v, nan_ok=True), k


def test_trainer_cli_v1_quick_gelu(tmp_path):
    """`--model ViT-Tiny-Test --force-quick-gelu --extract-type v1` on the
    CPU: QuickGELU reaches both towers, the loss is finite and both blocks
    move (the labels reach `visual.transformer.resblocks`)."""
    run = train_main.main([
        "--device", "cpu", "--synthetic", "--model", NAME, "--force-quick-gelu", "--extract-type", "v1",
        "--batch-size", "2", "--det-image-size", "48", "--max-boxes", "3", "--steps-per-epoch", "2",
        "--epochs", "1", "--lr", "1e-3", "--warmup", "1", "--logs", str(tmp_path), "--name", "vit",
    ])
    model, teacher = run["state"].model, run["teacher"]
    assert model.cfg.vision.quick_gelu and model.cfg.text.quick_gelu
    assert model.visual.blocks[0].mlp.quick_gelu
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    moved = {n.split(".")[3] for n, p in model.named_parameters()
             if not torch.equal(p, teacher.state_dict()[n])}
    assert moved == {"0", "1"}
    assert "extract_type: v1" in (tmp_path / "vit" / "params.txt").read_text()


@pytest.mark.parametrize("name,error,match", [
    pytest.param("hf-vit-tiny-test", None, None, id="hf-vit-tiny-test-item 8.5"),
    pytest.param("roberta-ViT-B-32", OSError, "'roberta-base'.*config.json", id="roberta-ViT-B-32-item 8.5"),
    pytest.param("coca_roberta-ViT-B-32", OSError, "'roberta-base'.*config.json",
                 id="coca_roberta-ViT-B-32-item 8.5"),
])
def test_unported_towers_raise_naming_their_item(name, error, match):
    """The towers of ROADMAP.md item 8.5, which raised naming it before it
    was ported: the trunk adapter of a model-type config builds; a text
    tower named by a hub id raises naming the config.json that is not in the
    repository (nothing is fetched)."""
    cfg = get_model_config(name)
    if error is None:
        assert type(CLIP(cfg, torch.float32).visual).__name__ == "TrunkAdapter"
        return
    with pytest.raises(error, match=match):
        model_class(cfg)(cfg, torch.float32)


@pytest.mark.parametrize("name,tower", [
    ("RN50", "ModifiedResNet"), ("EVA01-CLIP-B-16", "EvaViT"), ("convnext_base", "ConvNeXtTower"),
    ("swin_base_patch4_window7_224", "SwinTower"), ("vit_relpos_medium_patch16_cls_224", "TimmViTTower"),
    ("coca_ViT-B-32", "OpenCLIPViT"),
])
def test_formerly_unported_towers_build(name, tower):
    """The towers of items 8.2, 8.3, 8.4 and 8.6 (a CoCa, built by
    `model_class`), which raised before they were ported, build (on the
    meta device: no memory)."""
    cfg = get_model_config(name)
    with torch.device("meta"):
        model = model_class(cfg)(cfg, torch.float32)
    assert type(model.visual).__name__ == tower
    assert type(model).__name__ == ("CoCa" if cfg.multimodal else "CLIP")


def test_create_model_builds_the_vit_tower():
    model = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    again = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    assert isinstance(model.visual, OpenCLIPViT)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    sd = model.state_dict()
    assert not sd["visual.transformer.resblocks.0.attn.in_proj_bias"].any()
    assert abs(sd["visual.proj"].std().item() * 8 - 1) < 0.2  # normal(width^-0.5)
    assert torch.equal(sd["visual.ln_pre.weight"], torch.ones(64))
    assert "visual.conv1.bias" not in sd
