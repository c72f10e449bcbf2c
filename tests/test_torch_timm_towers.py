"""The port's timm-family towers (`clipself_tpu_torch/models/{convnext,swin,timm_vit}.py`,
their branches of `models/clip.py`, `models/torch_io.py` and `train/optim.py`)
against the JAX package, float32 on the CPU.

Tiny arch entries are patched into BOTH packages' tables for the module's
run (and taken out after): a ConvNeXt of widths 8-32 with a linear and with
an MLP head, a Swin of window 4 whose two stages run 4x4 and 2x2 windows
with the cyclic shift (so an off-by-one in the shift, its mask or the table
index shows, which a single window hides), a Swin whose 4x4 grid is below
its window 7 (the one-window clamp: a 7x7-row table), and the rel-pos and
GAP plain ViTs of `tests/test_timm_towers.py`. Every flax leaf is seeded
noise (kernels of spread fan_in^-0.5, norm scales around 1, the ConvNeXt
layer scale `gamma` around 0.5 so that the blocks matter, every other leaf
of spread 0.1), carried over with `state_dict_from_jax(params, cfg)`.

Tolerances: whole-tower outputs, losses and gradients sum the same float32
products in another order: 1e-4 absolute (gradients 1e-4 of each tensor's
largest entry plus 1e-6, the bar of `test_torch_modified_resnet.py`).
Tables (state dicts, lock and decay labels, arch tables) EQUAL.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import clipself_tpu.models.convnext as jconvnext
import clipself_tpu.models.swin as jswin
import clipself_tpu.models.timm_vit as jtimm_vit
from clipself_tpu.core.config import config_from_dict as jconfig_from_dict
from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu_torch.core.config import config_from_dict, get_model_config, list_models
from clipself_tpu_torch.models import convnext, swin, timm_vit, torch_io
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.common import l2_normalize
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.ops.mask_pool import mask_pool
from clipself_tpu_torch.train import methods, optim

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-4
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6

CONVNEXT_TINY = {"convnext_port_tiny": ((1, 2, 1, 1), (8, 16, 24, 32))}
SWIN_TINY = {
    "swin_port_tiny": (8, (2, 2), (2, 4), 4),
    "swin_port_clamp": (8, (2,), (2,), 7),
}
VIT_TINY = {
    "vit_port_relpos": dict(
        width=32, depth=2, heads=2, patch=8, cls_token=True, pool="token",
        rel_pos=True, rel_pos_dim=16, qkv_bias=False, fc_norm=False, abs_pos=False,
    ),
    "vit_port_gap": dict(
        width=32, depth=2, heads=2, patch=8, cls_token=False, pool="avg",
        rel_pos=False, rel_pos_dim=0, qkv_bias=False, fc_norm=True, abs_pos=True,
    ),
}
TABLES = (
    (jconvnext.CONVNEXT_ARCHS, convnext.CONVNEXT_ARCHS, CONVNEXT_TINY),
    (jswin.SWIN_ARCHS, swin.SWIN_ARCHS, SWIN_TINY),
    (jtimm_vit.TIMM_VIT_ARCHS, timm_vit.TIMM_VIT_ARCHS, VIT_TINY),
)

TEXT = dict(context_length=8, vocab_size=64, width=32, heads=2, layers=1)
# family -> (timm trunk, head, config image size, evaluator image size,
# dense grid at that size); the GAP ViT keeps its pos_embed's size, the
# clamped Swin the size its table was made for
FAMILIES = {
    "convnext": ("convnext_port_tiny", "linear", 64, 128, 4),
    "convnext_mlp": ("convnext_port_tiny", "mlp", 64, 128, 4),
    "swin": ("swin_port_tiny", "linear", 64, 128, 16),
    "swin_clamp": ("swin_port_clamp", "linear", 16, 16, 4),
    "vit_relpos": ("vit_port_relpos", "linear", 32, 48, 6),
    "vit_gap": ("vit_port_gap", "linear", 32, 32, 4),
}
TIMM_CONFIGS = tuple(n for n in list_models() if get_model_config(n).vision.timm_model_name)


def _cfg_dict(family: str) -> dict:
    trunk, head, size, _, _ = FAMILIES[family]
    vision = dict(timm_model_name=trunk, timm_proj=head, image_size=size)
    return dict(embed_dim=24, vision_cfg=vision, text_cfg=TEXT)


def jcfg(family):
    return jconfig_from_dict(_cfg_dict(family), name=f"tiny-{family}")


def tcfg(family):
    return config_from_dict(_cfg_dict(family), name=f"tiny-{family}")


@pytest.fixture(scope="module", autouse=True)
def tiny_archs():
    """The tiny arch entries in both packages' tables, on one torch thread
    (see `test_torch_open_clip_vit.py`); both restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for jtable, ttable, tiny in TABLES:
        jtable.update(tiny)
        ttable.update(tiny)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        for jtable, ttable, tiny in TABLES:
            for name in tiny:
                jtable.pop(name, None)
                ttable.pop(name, None)


def _noise(shapes, rng):
    """Seeded float32 weights on a tree of shapes: a kernel of spread
    fan_in^-0.5, a norm scale 1 + 0.1 noise, a layer scale 0.5 + 0.1 noise,
    any other leaf 0.1 noise."""
    def leaf(path, x):
        z = rng.standard_normal(x.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z * np.float32(np.prod(x.shape[:-1]) ** -0.5)
        if name == "gamma":
            return 0.5 + 0.1 * z
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_TOWERS: dict = {}


def tower(family):
    """(jax model, params as numpy, port CLIP with those weights), made once
    a family."""
    if family not in _TOWERS:
        cfg = jcfg(family)
        jmodel, _ = jax_create_model(cfg, dtype=jnp.float32, init=False)
        shapes = jax.eval_shape(lambda: jax_create_model(cfg, dtype=jnp.float32, seed=0)[1])
        params = _noise(shapes, np.random.default_rng(sum(map(ord, family))))
        model = CLIP(tcfg(family), torch.float32).eval()
        load_weights(model, state_dict_from_jax(params, tcfg(family)))
        _TOWERS[family] = (jmodel, params, model)
    return _TOWERS[family]


def _inputs(family: str, seed: int = 0, m: int = 5):
    """Images at the family's evaluator size, boxes [2, m, 4] (one
    zero-area box) and cell masks [2, m, g, g] (one all empty) on its dense
    grid."""
    _, _, _, size, g = FAMILIES[family]
    rng = np.random.default_rng(seed + size)
    img = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.6, (2, m, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (2, m, 2))], -1).astype(np.float32)
    boxes[0, 1] = [0.3, 0.3, 0.3, 0.3]
    masks = (rng.uniform(size=(2, m, g, g)) < 0.5).astype(np.float32)
    masks[1, 0] = 0.0
    return img, boxes, masks


def _visual_mask_pool(module, image, masks):
    return module.visual.mask_pool(image, masks)


def _cases(family: str) -> dict:
    """name -> (JAX method, its arguments, the port's call on the port CLIP)."""
    img, boxes, masks = _inputs(family)
    ti, tb, tm = (torch.from_numpy(a) for a in (img, boxes, masks))
    cases = {
        "encode_image": ("encode_image", (img, True), lambda m: m.encode_image(ti, True)),
        "encode_dense": ("encode_dense", (img, False, True), lambda m: m.encode_dense(ti, keep_shape=True)),
        "mask_pool": (_visual_mask_pool, (img, masks), lambda m: m.visual.mask_pool(ti, tm)),
        "rois_and_image": ("encode_rois_and_image", (img, boxes), lambda m: m.encode_rois_and_image(ti, tb)),
    }
    for et in ("v1", "v2"):
        cases[f"rois-{et}"] = (
            "encode_pseudo_boxes", (img, boxes, False, et),
            lambda m, et=et: m.encode_pseudo_boxes(ti, tb, extract_type=et))
        # as the evaluator calls it: mask-attention pooling with v1
        cases[f"rois_and_masks-{et}"] = (
            "encode_rois_and_masks", (img, boxes, masks, True, et, et == "v1"),
            lambda m, et=et: m.encode_rois_and_masks(ti, tb, tm, extract_type=et, mask_attn=et == "v1"))
    for mask_attn in (False, True):  # no timm tower has mask-attention pooling
        cases[f"masks-{mask_attn}"] = (
            "encode_masks", (img, masks, True, mask_attn),
            lambda m, a=mask_attn: m.encode_masks(ti, tm, mask_attn=a))
    if family in VARIANTS:
        cases = {k: v for k, v in cases.items() if k in VARIANT_CASES}
    return cases


# a variant of a family (the MLP head, the clamped window) differs from it
# in the head or one stage: the paths through it (the JAX side compiles
# every case of a family in one call, seconds each)
VARIANTS = ("convnext_mlp", "swin_clamp")
VARIANT_CASES = ("encode_image", "encode_dense", "rois-v1", "rois-v2", "rois_and_image")
CASES = {family: _cases(family) for family in FAMILIES}
# the JAX wrapper's mask-attention flag takes the tower's `mask_pool` where
# the tower has no `mask_attn_pool` (no timm tower has one): one call,
# compiled once
SAME_JAX_CALL = {"masks-True": "masks-False"}
_REFS: dict = {}


def jax_refs(family):
    """name -> the JAX package's output of every case of ``family``, from
    ONE jitted call with the weights and arrays as its arguments."""
    if family not in _REFS:
        jmodel, params, _ = tower(family)
        cases = CASES[family]
        arrays = [[a for a in args if isinstance(a, np.ndarray)] for _, args, _ in cases.values()]

        def run(params, arrays):
            out = {}
            for (name, (method, args, _)), arrs in zip(cases.items(), arrays):
                if name in SAME_JAX_CALL:
                    continue
                it = iter(arrs)
                args = [next(it) if isinstance(a, np.ndarray) else a for a in args]
                out[name] = jmodel.apply({"params": params}, *args, method=method)
            return out

        refs = jax.tree.map(np.asarray, jax.jit(run)(params, arrays))
        _REFS[family] = {**refs, **{k: refs[v] for k, v in SAME_JAX_CALL.items() if k in cases}}
    return _REFS[family]


def _close(got, want, tol=TOL):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("family,case", [(f, c) for f, cases in CASES.items() for c in cases])
def test_tower_matches_jax(family, case):
    _, _, model = tower(family)
    with torch.no_grad():
        got = CASES[family][case][2](model)
    _close(got, jax_refs(family)[case])


@pytest.mark.parametrize("family", ["convnext", "swin", "vit_relpos"])
def test_wrapper_mask_path_takes_the_towers_mask_pool(family):
    """`CLIP.encode_masks` routes through the tower's own `mask_pool`, which
    normalizes the dense map before pooling, as the JAX wrapper calls
    `visual.mask_pool`; the masked mean of the raw map (what the wrapper
    computed before) gives other features, off the JAX ones by far more
    than the tolerance."""
    _, _, model = tower(family)
    img, _, masks = _inputs(family)
    ti, tm = torch.from_numpy(img), torch.from_numpy(masks)
    want = jax_refs(family)["masks-False"]
    with torch.no_grad():
        got = model.encode_masks(ti, tm)
        raw = l2_normalize(mask_pool(model.visual.encode_dense(ti, keep_shape=True), tm))
    _close(got, want)
    assert np.abs(raw.numpy() - want).max() > 100 * TOL


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_from_jax_equals_export_state_dict(family):
    """Every key of the whole CLIP EQUAL to the JAX package's export under
    the tower's config; the port's module tree has exactly these keys;
    `import_state_dict` and `load_weights` take them back."""
    _, params, model = tower(family)
    ref = jtorch_io.export_state_dict(params, jcfg(family))
    sd = state_dict_from_jax(params, tcfg(family))
    assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    other = CLIP(tcfg(family), torch.float32)
    assert torch_io.import_state_dict(other, ref) == []
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k
    again = CLIP(tcfg(family), torch.float32)
    load_weights(again, {k: v.clone() for k, v in sd.items()})
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_import_state_dict_does_not_resize_timm_tables():
    """A GAP ViT's `visual.trunk.pos_embed` or a Swin table of another size
    raises, as no registry config needs a resize."""
    for family, key in (("vit_gap", "visual.trunk.pos_embed"),
                        ("swin", "visual.trunk.layers.0.blocks.0.attn.relative_position_bias_table")):
        sd = dict(tower(family)[2].state_dict())
        sd[key] = torch.zeros(sd[key].shape[0] + 1, *sd[key].shape[1:]) if key.endswith("table") \
            else torch.zeros(1, sd[key].shape[1] + 3, sd[key].shape[2])
        with pytest.raises(ValueError, match="shape mismatch"):
            torch_io.import_state_dict(CLIP(tcfg(family), torch.float32), sd)


def _tkey(path, family) -> str:
    return torch_io.flax_to_torch_key(path, tcfg(family))[0]


@pytest.mark.parametrize("lock_image", [True, False], ids=["locked", "unlocked"])
@pytest.mark.parametrize("family", ["convnext_mlp", "swin", "vit_relpos", "vit_gap"])
def test_lock_and_decay_labels_equal_jax(family, lock_image):
    """`trainable_labels` (2 groups unlocked) over the whole CLIP, key for
    key EQUAL to the JAX package's over its tree: under the lock every
    parameter freezes, without it all of `visual` trains; and the decay
    mask (`gamma`, the rel-pos tables and MLP, `cls_token`, `pos_embed`)."""
    _, params, model = tower(family)
    labels = joptim.trainable_labels(params, 2, 12, lock_image=lock_image)
    want = {_tkey(p, family): v for p, v in torch_io._flatten(labels).items()}
    got = optim.trainable_labels(list(model.state_dict()), 2, 12, lock_image=lock_image)
    assert got == want
    visual = {k for k in got if k.startswith("visual.")}
    assert {k for k, v in got.items() if v == "train"} == (set() if lock_image else visual)
    decay = {_tkey(p, family): bool(v) for p, v in torch_io._flatten(joptim.no_decay_mask(params)).items()}
    assert optim.no_decay_mask(model.named_parameters()) == decay


def _distill_batch(family, seed=0, b=2, m=3):
    _, _, size, det, _ = FAMILIES[family]
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.2, 0.5, (b, m, 2)), np.ones((b, m, 1))], -1)
    boxes[:, -1, 4] = 0.0  # an invalid row that keeps its box
    return {
        "images": rng.standard_normal((b, det, det, 3)).astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "crops": rng.standard_normal((b, m, size, size, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("family,extract_type", [
    ("convnext", "v1"), ("swin", "v2"), ("vit_relpos", "v2"), ("vit_gap", "v2"),
])
def test_clipself_loss_and_grads_match_jax(family, extract_type):
    """The distill loss with the image tower unlocked (`--no-lock-image`,
    the only way a timm tower trains), and every trainable gradient,
    against JAX."""
    jmodel, params, _ = tower(family)
    batch = _distill_batch(family, 1)
    jlabels = joptim.trainable_labels(params, 0, 12, lock_image=False)
    # the teacher's weights as JAX arrays: a NumPy table indexed by a traced
    # index (Swin's) fails under jit
    jteacher = jax.tree.map(jnp.asarray, params)

    def loss(p):
        p = jax.tree.map(lambda x, lab: x if lab == "train" else jax.lax.stop_gradient(x), p, jlabels)
        return jmethods.clipself_loss(p, jteacher, batch, jmodel, extract_type=extract_type)[0]

    jloss, jgrads = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(loss))(params))
    model = CLIP(tcfg(family), torch.float32)
    load_weights(model, state_dict_from_jax(params, tcfg(family)))
    teacher = CLIP(tcfg(family), torch.float32).requires_grad_(False)
    load_weights(teacher, state_dict_from_jax(params, tcfg(family)))
    labels = optim.trainable_labels(list(model.state_dict()), 0, 12, lock_image=False)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    tloss, _ = methods.clipself_loss(
        model, teacher, {k: torch.from_numpy(v) for k, v in batch.items()}, extract_type=extract_type)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL
    want = state_dict_from_jax(jgrads, tcfg(family))
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + GRAD_FLOOR, err_msg=name)
        checked += 1
    assert checked == sum(k.startswith("visual.") for k in labels) > 0


@pytest.mark.parametrize("which", range(len(TABLES)), ids=["convnext", "swin", "timm_vit"])
def test_arch_tables_equal_jax(which):
    jtable, ttable, tiny = TABLES[which]
    assert ttable == jtable
    assert set(tiny) <= set(ttable)


def test_swin_grid_not_divisible_by_the_window_raises():
    """The tiny Swin at 48^2 (a 6x6 second stage, window 4) fails in the JAX
    tower's reshape and raises a ValueError in the port; so does Swin-B at
    1024^2 (a 256x256 first stage, window 7)."""
    jmodel, params, model = tower("swin")
    img = np.zeros((1, 48, 48, 3), np.float32)
    with pytest.raises(TypeError):  # traced only: the reshape fails at trace time
        jax.eval_shape(lambda p, x: jmodel.apply({"params": p}, x, method="encode_image"), params, img)
    with pytest.raises(ValueError, match="divide"):
        model.encode_image(torch.from_numpy(img))
    cfg = get_model_config("swin_base_patch4_window7_224")
    big = swin.SwinTower(cfg.vision, cfg.embed_dim)
    with torch.no_grad(), pytest.raises(ValueError, match="896"):
        big(torch.zeros(1, 1024, 1024, 3))


@pytest.mark.parametrize("name", TIMM_CONFIGS)
def test_every_timm_config_builds_its_tower(name):
    """`CLIP(get_model_config(n))` builds the JAX package's tower family for
    every timm config (on the meta device: no memory), at the arch's widths,
    with the config's head."""
    cfg = get_model_config(name)
    with torch.device("meta"):
        model = CLIP(cfg, torch.bfloat16)
    v, trunk = model.visual, cfg.vision.timm_model_name
    if trunk.startswith("convnext"):
        depths, dims = convnext.CONVNEXT_ARCHS[trunk]
        assert isinstance(v, convnext.ConvNeXtTower)
        assert [len(s.blocks) for s in v.trunk.stages] == list(depths)
        assert v.trunk.head.norm.weight.shape == (dims[-1],)
        assert hasattr(v.head, "mlp") == (cfg.vision.timm_proj == "mlp")
    elif trunk.startswith("swin"):
        assert isinstance(v, swin.SwinTower)
        embed, depths, heads, window = swin.SWIN_ARCHS[trunk]
        assert [len(s.blocks) for s in v.trunk.layers] == list(depths)
        tables = {blk.attn.relative_position_bias_table.shape for s in v.trunk.layers for blk in s.blocks}
        assert {t[0] for t in tables} == {(2 * window - 1) ** 2}
    else:
        assert isinstance(v, timm_vit.TimmViTTower)
        assert len(v.trunk.blocks) == timm_vit.TIMM_VIT_ARCHS[trunk]["depth"]
    out = v.head.proj.out_features if hasattr(v.head, "proj") else v.head.mlp.fc2.out_features
    assert out == cfg.embed_dim
    assert jget_model_config(name).vision.timm_model_name == trunk


@pytest.mark.parametrize("family", ["convnext", "swin", "vit_relpos"])
def test_grad_checkpointing_changes_nothing(family):
    """Recomputing each block in the backward pass (the JAX towers take
    `remat` and do not apply it) gives the same loss and gradients."""
    _, params, _ = tower(family)
    batch = {k: torch.from_numpy(v) for k, v in _distill_batch(family, 2).items()}
    grads = []
    for recompute in (False, True):
        model = CLIP(tcfg(family), torch.float32, grad_checkpointing=recompute)
        load_weights(model, state_dict_from_jax(params, tcfg(family)))
        teacher = CLIP(tcfg(family), torch.float32).requires_grad_(False)
        load_weights(teacher, state_dict_from_jax(params, tcfg(family)))
        loss, _ = methods.clipself_loss(model, teacher, batch)
        loss.backward()
        assert model.visual.grad_checkpointing == recompute
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-6, msg=name)
