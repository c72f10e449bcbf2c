"""The port's EVA01 / bigE variants of the EVA tower
(`clipself_tpu_torch/models/eva_vit.py`: the fused `qkv` projection, the GELU
`Mlp`, no RoPE, post-norm blocks, the per-block and the shared
relative-position bias, patch dropout) and the trainer's
`--force-patch-dropout`, against the JAX package on `EVA02-CLIP-Tiny-Test`
(2 blocks, width 64, head width 32, patch 8) with its flags replaced, float32
on the CPU. The weights are seeded noise on the shapes of each variant's
JAX param tree (kernels of spread fan_in^-0.5, norm scales around 1, every
other leaf, the zero-initialised rel-pos tables too, of spread 0.1),
carried over with `state_dict_from_jax`.

Tolerances: whole-tower outputs, losses and gradients sum the same products
in another order through two blocks (and their backward): 1e-4 absolute
(gradients: 1e-4 of each tensor's largest entry, plus 1e-8 where one
vanishes); state dicts EQUAL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.train import methods as jmethods
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.eva_vit import EvaViT
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.train import main as train_main
from clipself_tpu_torch.train import methods, optim

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
LAYERS = 2
TOL = 1e-4
GRAD_REL = 1e-4
# variant -> the vision flags it sets
VARIANTS = {
    "eva01": dict(subln=False, naiveswiglu=False, rope=False),  # EVA01-CLIP-B-16 / g-14
    "bige": dict(subln=False, naiveswiglu=False, rope=False, postnorm=True),  # EVA02-CLIP-bigE-14
    "rel_pos": dict(use_rel_pos_bias=True),
    "shared_rel_pos": dict(use_shared_rel_pos_bias=True),
    "patch_dropout": dict(patch_dropout=0.5),
}
# the variants with a rel-pos table are fixed-resolution (the config's 4x4 grid)
FIXED = ("rel_pos", "shared_rel_pos")
EVA_CONFIGS = ("EVA01-CLIP-B-16", "EVA01-CLIP-g-14", "EVA01-CLIP-g-14-plus",
               "EVA02-CLIP-bigE-14", "EVA02-CLIP-bigE-14-plus")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's cases on one torch thread, restored after (see
    `test_torch_open_clip_vit.py`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def variant_cfg(get, variant):
    cfg = get(NAME)
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **VARIANTS[variant]))


def _noise(shapes, rng):
    """Seeded float32 weights on a tree of shapes: a kernel of spread
    fan_in^-0.5, a norm scale 1 + 0.1 noise, any other leaf 0.1 noise."""
    def leaf(path, x):
        z = rng.standard_normal(x.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z * np.float32(np.prod(x.shape[:-1]) ** -0.5)
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def towers():
    """variant -> (jax model, params as numpy, port CLIP with those weights)."""
    out = {}
    for i, variant in enumerate(VARIANTS):
        jmodel, _ = jax_create_model(variant_cfg(jget_model_config, variant), dtype=jnp.float32, init=False)
        shapes = jax.eval_shape(
            lambda: jax_create_model(variant_cfg(jget_model_config, variant), dtype=jnp.float32, seed=0)[1])
        params = _noise(shapes, np.random.default_rng(20 + i))
        model = CLIP(variant_cfg(get_model_config, variant), torch.float32).eval()
        load_weights(model, state_dict_from_jax(params))
        out[variant] = (jmodel, params, model)
    return out


def _inputs(variant, seed=0, b=2, m=4):
    """Images (32^2 for the fixed-resolution variants, else 48^2, whose 6x6
    grid resizes the 4x4 pos-embed), boxes [b, m, 4], the distill batch's
    crops at 32^2 and a valid flag a box (the last row invalid)."""
    size = 32 if variant in FIXED else 48
    rng = np.random.default_rng(seed + size)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.15, 0.5, (b, m, 2))], -1).astype(np.float32)
    valid = np.ones((b, m, 1), np.float32)
    valid[:, -1] = 0.0
    return {
        "images": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "boxes": np.concatenate([boxes, valid], -1),
        "crops": rng.standard_normal((b, m, 32, 32, 3)).astype(np.float32),
    }


def _keep(b=2, n=36, seed=3):
    """Patch-dropout noise [b, n] and the keep indices the JAX tower takes
    from it: the first max(1, int(n * 0.5)) of its argsort."""
    noise = np.random.default_rng(seed).uniform(size=(b, n)).astype(np.float32)
    return noise, np.argsort(noise, axis=-1)[:, : max(1, int(n * 0.5))]


@pytest.fixture(scope="module")
def jax_refs(towers):
    """variant -> the JAX package's dense map, v2 RoI features, image
    embedding (for patch dropout: with the drop), the distill loss and its
    gradients over every visual block, from ONE jitted call a variant."""
    refs = {}
    real_uniform = jax.random.uniform
    noise, _ = _keep()

    def fake_uniform(key, shape=(), *args, **kw):  # the patch-dropout draw, fixed
        return jnp.asarray(noise) if tuple(shape) == noise.shape else real_uniform(key, shape, *args, **kw)

    for variant, (jmodel, params, _) in towers.items():
        batch = _inputs(variant)
        rngs = {"patch_dropout": jax.random.PRNGKey(0)} if variant == "patch_dropout" else {}

        def run(params, batch, jmodel=jmodel, rngs=rngs):
            v = {"params": params}
            out = {
                "dense": jmodel.apply(v, batch["images"], False, True, method="encode_dense"),
                "rois": jmodel.apply(v, batch["images"], batch["boxes"][..., :4], method="encode_pseudo_boxes"),
            }

            def image_sum(p):
                emb = jmodel.apply({"params": p}, batch["images"], method="encode_image", rngs=rngs)
                return (emb * jnp.arange(emb.shape[-1], dtype=emb.dtype)).sum(), emb

            if rngs:  # the dropped path's backward (the gathered RoPE)
                (_, out["image"]), out["image_grads"] = jax.value_and_grad(image_sum, has_aux=True)(params)
            else:
                out["image"] = image_sum(params)[1]
            (out["loss"], _), out["grads"] = jax.value_and_grad(
                lambda p: jmethods.clipself_loss(p, params, batch, jmodel), has_aux=True)(params)
            return out

        jax.random.uniform = fake_uniform
        try:
            refs[variant] = jax.tree.map(np.asarray, jax.jit(run)(params, batch))
        finally:
            jax.random.uniform = real_uniform
    return refs


def _close(got, want, tol=TOL):
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _check_grads(model, jgrads, only_visual=False):
    want = state_dict_from_jax(jgrads)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad or (only_visual and not name.startswith("visual.")):
            continue
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()  # outside the graph: zero in JAX
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + 1e-8, err_msg=name)
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_from_jax_equals_export_state_dict(towers, variant):
    _, params, model = towers[variant]
    ref = jtorch_io.export_state_dict(params, variant_cfg(jget_model_config, variant))
    sd = state_dict_from_jax(params)
    assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    keys = set(sd)
    fused = variant in ("eva01", "bige")
    assert ("visual.blocks.0.attn.qkv.weight" in keys) == fused
    assert ("visual.blocks.0.attn.q_proj.weight" in keys) != fused
    assert "visual.blocks.0.attn.q_bias" in keys and "visual.blocks.0.attn.v_bias" in keys
    assert ("visual.blocks.1.mlp.fc1.weight" in keys) == fused
    assert ("visual.blocks.0.attn.inner_attn_ln.weight" in keys) != fused
    assert ("visual.blocks.1.attn.relative_position_bias_table" in keys) == (variant == "rel_pos")
    assert ("visual.rel_pos_bias.relative_position_bias_table" in keys) == (variant == "shared_rel_pos")


@pytest.mark.parametrize("what", ["dense", "rois", "image"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(towers, jax_refs, variant, what):
    """The dense map, the v2 RoI features and the image embedding (with the
    patch-dropout variant: its tokens dropped at the JAX tower's keep
    indices, rotated by their grid positions)."""
    _, _, model = towers[variant]
    batch = {k: torch.from_numpy(v) for k, v in _inputs(variant).items()}
    keep = torch.from_numpy(_keep()[1]) if variant == "patch_dropout" else None
    with torch.no_grad():
        if what == "dense":
            got = model.encode_dense(batch["images"], keep_shape=True)
        elif what == "rois":
            got = model.encode_pseudo_boxes(batch["images"], batch["boxes"][..., :4])
        else:
            got = model.visual(batch["images"], patch_keep=keep)
    _close(got, jax_refs[variant][what])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gradients_match_jax(towers, jax_refs, variant):
    """One distill step's loss and the gradients of every visual block
    (the text tower frozen); with patch dropout also the gradients of a
    weighted sum of the image embedding, through the dropped tokens and the
    gathered RoPE."""
    _, params, _ = towers[variant]
    cfg = variant_cfg(get_model_config, variant)
    batch = {k: torch.from_numpy(v) for k, v in _inputs(variant).items()}
    model = CLIP(cfg, torch.float32)
    load_weights(model, state_dict_from_jax(params))
    teacher = CLIP(cfg, torch.float32).requires_grad_(False)
    load_weights(teacher, state_dict_from_jax(params))
    labels = optim.trainable_labels(list(model.state_dict()), LAYERS, LAYERS, lock_image=False)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    loss, _ = methods.clipself_loss(model, teacher, batch)
    loss.backward()
    ref = jax_refs[variant]
    assert abs(loss.item() - float(ref["loss"])) <= TOL
    _check_grads(model, ref["grads"], only_visual=True)
    if variant != "patch_dropout":
        return
    model.zero_grad(set_to_none=True)
    emb = model.visual(batch["images"], patch_keep=torch.from_numpy(_keep()[1]))
    (emb * torch.arange(emb.shape[-1], dtype=emb.dtype)).sum().backward()
    _check_grads(model, ref["image_grads"], only_visual=True)


def test_patch_dropout_takes_a_generator_and_only_when_asked():
    """Without keep indices or a generator the variant drops nothing (the
    trainer's path, as in the JAX package); a generator draws the keep
    indices as the JAX tower does (the first half of an argsort of uniform
    noise): the same generator state gives the same embedding."""
    model = CLIP(variant_cfg(get_model_config, "patch_dropout"), torch.float32)
    model.visual.init_weights(torch.Generator().manual_seed(0))
    base = CLIP(get_model_config(NAME), torch.float32)
    base.load_state_dict(model.state_dict())
    img = torch.randn(2, 48, 48, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(model.visual(img), base.visual(img))
        a = model.visual(img, patch_keep=torch.Generator().manual_seed(5))
        b = model.visual(img, patch_keep=torch.Generator().manual_seed(5))
        noise = torch.rand((2, 36), generator=torch.Generator().manual_seed(5))
        c = model.visual(img, patch_keep=torch.argsort(noise, dim=-1)[:, :18])
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.allclose(a, base.visual(img))


@pytest.mark.parametrize("variant", FIXED)
def test_rel_pos_models_are_fixed_resolution(towers, variant):
    """A grid other than the table's raises the JAX package's ValueError
    (the JAX per-block table raises it too)."""
    jmodel, params, model = towers[variant]
    img = np.zeros((1, 48, 48, 3), np.float32)
    with pytest.raises(ValueError, match="fixed-resolution"):
        model.encode_dense(torch.from_numpy(img))
    if variant == "rel_pos":
        with pytest.raises(ValueError, match="fixed-resolution"):
            jax.eval_shape(lambda p: jmodel.apply({"params": p}, img, method="encode_dense"), params)


@pytest.mark.parametrize("name", EVA_CONFIGS)
def test_every_eva_variant_config_builds(name):
    """`CLIP(get_model_config(n))` builds the EVA tower for every EVA01 and
    bigE config (on the meta device: no memory), with the fused `qkv`, the
    GELU MLP and, for bigE, post-norm blocks."""
    cfg = get_model_config(name)
    with torch.device("meta"):
        model = CLIP(cfg, torch.bfloat16)
    blk = model.visual.blocks[0]
    assert isinstance(model.visual, EvaViT) and blk.postnorm == cfg.vision.postnorm
    assert hasattr(blk.attn, "qkv") and hasattr(blk.mlp, "fc1") and blk.attn.inner_attn_ln is None
    assert blk.attn.q_bias is not None and cfg.vision.head_width in (64, 88, 112)


def test_trainer_cli_eva01_style_and_force_patch_dropout(tmp_path, monkeypatch):
    """The trainer on the EVA01-style tiny tower (`train.main`'s
    `get_model_config` swapped for the variant): it takes steps, every block
    moves, and `--force-patch-dropout` reaches the config and, as in the
    JAX trainer, changes no loss."""
    monkeypatch.setattr(train_main, "get_model_config", lambda name: variant_cfg(get_model_config, "eva01"))
    argv = ["--device", "cpu", "--synthetic", "--model", "EVA01-style", "--batch-size", "2",
            "--det-image-size", "48", "--max-boxes", "3", "--steps-per-epoch", "2", "--epochs", "1",
            "--lr", "1e-3", "--warmup", "1", "--logs", str(tmp_path)]
    runs = [train_main.main(argv + ["--name", "a"]),
            train_main.main(argv + ["--name", "b", "--force-patch-dropout", "0.3"])]
    losses = [[h["loss"] for h in run["history"]] for run in runs]
    assert all(np.isfinite(x) for x in losses[0]) and losses[0] == losses[1]
    assert runs[1]["state"].model.cfg.vision.patch_dropout == 0.3
    model, teacher = runs[0]["state"].model, runs[0]["teacher"]
    assert hasattr(model.visual.blocks[0].attn, "qkv")
    moved = {n.split(".")[2] for n, p in model.named_parameters()
             if n.startswith("visual.blocks.") and not torch.equal(p, teacher.state_dict()[n])}
    assert moved == {"0", "1"}
