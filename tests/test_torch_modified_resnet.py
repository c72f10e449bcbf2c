"""The port's ModifiedResNet tower (`clipself_tpu_torch/models/modified_resnet.py`,
the ResNet branches of `models/clip.py`, `models/torch_io.py`,
`train/optim.py` and the trainer's `--lock-image-freeze-bn-stats`) against
the JAX package on `RN-Tiny-Test` (stem width 8, one bottleneck a stage,
64^2 images, a 2x2 attention-pool grid), float32 on the CPU. The weights are
seeded noise on the shapes of the JAX param tree (kernels of spread
fan_in^-0.5, BatchNorm and LayerNorm scales around 1, BatchNorm variances
in [0.5, 1.5), every other leaf of spread 0.1), carried over with
`state_dict_from_jax`.

Tolerances: whole-tower outputs, losses and gradients sum the same products
in another order through five conv stages (and their backward): 1e-4
absolute (gradients: 1e-4 of each tensor's largest entry, plus 1e-6: the
attention pool's q and k projections get their v1 gradient through the
softmax's dP - di, a difference of near-equal terms, whose float32 noise
against a float64 run of the port measured 5.0e-7 in the JAX package's
gradient and 2.7e-7 in the port's, with 3e-3 the largest entry). After one AdamW step at lr 1e-3 each parameter has moved by
about the learning rate; Adam divides by sqrt(v) + eps, so a gradient entry
near zero turns its last-digit noise into a visible difference in that one
entry's update: at most 0.1% of all the parameters' entries may differ by
more than 2e-6, and no BatchNorm statistic by more than 5e-5 (the bars of
`test_torch_train_step.py`; a weight of ~1e3 entries can hold one such
entry, so the share is taken over the whole tower).
Tables (state dicts, lock and decay labels) EQUAL; a frozen statistic must
keep its bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu.train import step as jstep
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models import torch_io
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.modified_resnet import ModifiedResNet
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.train import main as train_main
from clipself_tpu_torch.train import methods, optim, step

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "RN-Tiny-Test"
GROUPS = 5  # stem, layer1 .. layer4
TOL = 1e-4
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6
PARAM_BULK, PARAM_BULK_SHARE, PARAM_MAX = 2e-6, 1e-3, 5e-5
RN_CONFIGS = ("RN50", "RN50-quickgelu", "RN101", "RN101-quickgelu", "RN50x4", "RN50x16",
              "RN50x64", "RN-Tiny-Test")


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


def _noise(shapes, rng):
    """Seeded float32 weights on a tree of shapes: a kernel of spread
    fan_in^-0.5, a norm scale 1 + 0.1 noise, a BatchNorm variance in
    [0.5, 1.5), any other leaf 0.1 noise."""
    def leaf(path, x):
        z = rng.standard_normal(x.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z * np.float32(np.prod(x.shape[:-1]) ** -0.5)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tower():
    """(jax model, params as numpy, port CLIP with those weights)."""
    cfg = jget_model_config(NAME)
    jmodel, _ = jax_create_model(cfg, dtype=jnp.float32, init=False)
    shapes = jax.eval_shape(lambda: jax_create_model(cfg, dtype=jnp.float32, seed=0)[1])
    params = _noise(shapes, np.random.default_rng(13))
    model = CLIP(get_model_config(NAME), torch.float32).eval()
    load_weights(model, state_dict_from_jax(params))
    return jmodel, params, model


def _inputs(size: int, seed: int = 0, m: int = 5):
    """Images, boxes [2, m, 4] (one zero-area box) and cell masks
    [2, m, g, g] (one all empty) on the size / 32 grid."""
    rng = np.random.default_rng(seed + size)
    g = size // 32
    img = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.6, (2, m, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (2, m, 2))], -1).astype(np.float32)
    boxes[0, 1] = [0.3, 0.3, 0.3, 0.3]
    masks = (rng.uniform(size=(2, m, g, g)) < 0.5).astype(np.float32)
    masks[1, 0] = 0.0
    return img, boxes, masks


def _cases() -> dict:
    """name -> (JAX method, its arguments, the port's call on the port CLIP)."""
    cases = {}
    for size in (64, 96):  # 96^2 resizes the 2x2 attention-pool grid to 3x3
        img, _, _ = _inputs(size)
        ti = torch.from_numpy(img)
        cases[f"encode_image-{size}"] = ("encode_image", (img, True), lambda m, ti=ti: m.encode_image(ti, True))
        cases[f"encode_dense-{size}"] = (
            "encode_dense", (img, False, True), lambda m, ti=ti: m.encode_dense(ti, keep_shape=True))
    img, boxes, masks = _inputs(96, seed=1)
    ti, tb, tm = (torch.from_numpy(a) for a in (img, boxes, masks))
    for et in ("v1", "v2"):
        cases[f"rois-{et}"] = (
            "encode_pseudo_boxes", (img, boxes, False, et),
            lambda m, et=et: m.encode_pseudo_boxes(ti, tb, extract_type=et))
    for mask_attn in (True, False):  # mask_attn_pool is mask_pool on this tower
        cases[f"masks-{mask_attn}"] = (
            "encode_masks", (img, masks, True, mask_attn),
            lambda m, a=mask_attn: m.encode_masks(ti, tm, mask_attn=a))
    for et in ("v1", "v2"):  # as the evaluator calls it: mask-attention pooling with v1
        cases[f"rois_and_masks-{et}"] = (
            "encode_rois_and_masks", (img, boxes, masks, True, et, et == "v1"),
            lambda m, et=et: m.encode_rois_and_masks(ti, tb, tm, extract_type=et, mask_attn=et == "v1"))
    cases["rois_and_image"] = (
        "encode_rois_and_image", (img, boxes), lambda m: m.encode_rois_and_image(ti, tb))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def jax_refs(tower):
    """name -> the JAX package's output of every case, from ONE jitted call
    with the weights and arrays as its arguments."""
    jmodel, params, _ = tower
    arrays = [[a for a in args if isinstance(a, np.ndarray)] for _, args, _ in CASES.values()]

    def run(params, arrays):
        out = {}
        for (name, (method, args, _)), arrs in zip(CASES.items(), arrays):
            it = iter(arrs)
            args = [next(it) if isinstance(a, np.ndarray) else a for a in args]
            out[name] = jmodel.apply({"params": params}, *args, method=method)
        return out

    return jax.tree.map(np.asarray, jax.jit(run)(params, arrays))


def _close(got, want, tol=TOL):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_tower_matches_jax(tower, jax_refs, case):
    _, _, model = tower
    with torch.no_grad():
        got = CASES[case][2](model)
    _close(got, jax_refs[case])


def test_state_dict_from_jax_equals_export_state_dict(tower):
    """Every key of the whole CLIP EQUAL to the JAX package's export, the
    BatchNorm statistics as the reference's running_mean / running_var
    PARAMETERS; the port's module tree has exactly these keys, strict and
    non-strict, and a reference checkpoint's `num_batches_tracked` buffers
    load strictly too."""
    _, params, model = tower
    ref = jtorch_io.export_state_dict(params, jget_model_config(NAME))
    sd = state_dict_from_jax(params)
    assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    names = dict(model.named_parameters())
    for key in ("visual.bn1.running_mean", "visual.layer1.0.downsample.1.running_var",
                "visual.layer2.0.downsample.0.weight", "visual.attnpool.positional_embedding"):
        assert key in names and key in sd
    other = CLIP(get_model_config(NAME), torch.float32)
    assert torch_io.import_state_dict(other, ref) == []
    counted = dict(sd, **{"visual.bn1.num_batches_tracked": torch.tensor(7)})
    load_weights(other, counted)
    for k, v in other.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("freeze_bn_stats", [False, True], ids=["stats_train", "stats_frozen"])
@pytest.mark.parametrize("unlocked", range(GROUPS + 1))
def test_lock_labels_equal_jax(tower, unlocked, freeze_bn_stats):
    """`trainable_labels` over the whole ResNet CLIP, key for key EQUAL to
    the JAX package's over its tree; and the decay mask (BN statistics and
    every 1-D or `bn` name undecayed)."""
    _, params, model = tower
    labels = joptim.trainable_labels(params, unlocked, 4, freeze_bn_stats=freeze_bn_stats)
    want = {_tkey(p): v for p, v in torch_io._flatten(labels).items()}
    got = optim.trainable_labels(list(model.state_dict()), unlocked, 4, freeze_bn_stats=freeze_bn_stats)
    assert got == want
    train = {k for k, v in got.items() if v == "train"}
    assert any(k.startswith("visual.attnpool.") for k in train)
    assert ("visual.conv1.weight" in train) == (unlocked >= GROUPS)
    assert any(k.endswith("running_mean") for k in train) == (unlocked >= 1 and not freeze_bn_stats)
    decay = {_tkey(p): bool(v) for p, v in torch_io._flatten(joptim.no_decay_mask(params)).items()}
    assert optim.no_decay_mask(model.named_parameters()) == decay


def _tkey(path) -> str:
    if path == ("logit_scale",):
        return "logit_scale"
    key_map = torch_io._vision_key_map if path[0] == "visual" else torch_io._text_key_map
    return key_map(path[1:])[0]


def _distill_batch(seed=0, b=2, m=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (b, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.2, 0.5, (b, m, 2)), np.ones((b, m, 1))], -1)
    boxes[:, -1, 4] = 0.0  # an invalid row that keeps its box
    return {
        "images": rng.standard_normal((b, 96, 96, 3)).astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "crops": rng.standard_normal((b, m, 64, 64, 3)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_grads(tower):
    """extract type -> (the JAX distill loss with every group unlocked, its
    gradients), both types from ONE jitted call."""
    jmodel, params, _ = tower
    labels = joptim.trainable_labels(params, GROUPS, 4)
    batch = _distill_batch(1)

    def losses(p):
        p = jax.tree.map(lambda x, lab: x if lab == "train" else jax.lax.stop_gradient(x), p, labels)
        out = {}
        for et in ("v1", "v2"):
            (loss, _), grads = jax.value_and_grad(
                lambda q: jmethods.clipself_loss(q, params, batch, jmodel, extract_type=et), has_aux=True)(p)
            out[et] = (loss, grads)
        return out

    return jax.tree.map(np.asarray, jax.jit(losses)(params))


@pytest.mark.parametrize("extract_type", ["v1", "v2"])
def test_clipself_loss_and_grads_match_jax(tower, jax_grads, extract_type):
    """The distill loss with every group unlocked, and every trainable
    gradient (the BatchNorm statistics' included) against JAX."""
    _, params, _ = tower
    batch = _distill_batch(1)
    jloss, jgrads = jax_grads[extract_type]
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    teacher = CLIP(get_model_config(NAME), torch.float32).requires_grad_(False)
    load_weights(teacher, state_dict_from_jax(params))
    tlabels = optim.trainable_labels(list(model.state_dict()), GROUPS, 4)
    for name, p in model.named_parameters():
        p.requires_grad_(tlabels[name] == "train")
    tloss, _ = methods.clipself_loss(
        model, teacher, {k: torch.from_numpy(v) for k, v in batch.items()}, extract_type=extract_type)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL
    want = state_dict_from_jax(jgrads)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + GRAD_FLOOR, err_msg=name)
        checked += 1
    assert checked == sum(v == "train" for v in tlabels.values())
    assert model.visual.bn1.running_var.grad.abs().max() > 0  # the statistics get gradients


SCHED = dict(base_lr=1e-3, warmup=1, total_steps=10)


@pytest.fixture(scope="module")
def jax_step(tower):
    """(loss, parameters after it) of one step of the JAX
    `make_train_step`, AdamW over every group, the statistics included."""
    jmodel, params, _ = tower
    tx = joptim.build_optimizer(
        params, joptim.make_schedule("cosine", **SCHED), wd=0.1, unlocked_groups=GROUPS, num_layers=4)
    jstep_fn = jstep.make_train_step(
        jmodel, tx, jmethods.clipself_loss, mesh=None, donate=False,
        trainable=joptim.trainable_labels(params, GROUPS, 4),
    )
    batch = {k: jnp.asarray(v) for k, v in _distill_batch(2).items()}
    jstate, jmetrics = jstep_fn(
        jstep.TrainState.create(jax.tree.map(jnp.asarray, params), tx), params, batch, jax.random.PRNGKey(0))
    return float(jmetrics["loss"]), state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))


@pytest.mark.parametrize("freeze_bn_stats", [False, True], ids=["stats_train", "stats_frozen"])
def test_adamw_step_moves_bn_stats_as_jax(tower, jax_step, freeze_bn_stats):
    """One step of the port's AdamW over every group against the JAX
    step's: the loss, the BatchNorm statistics after the update and the
    other parameters. With `freeze_bn_stats` the statistics keep their
    bits, and every other parameter takes the JAX step's update all the
    same (AdamW updates each entry from its own gradient, and freezing the
    statistics changes no other gradient)."""
    _, params, _ = tower
    kw = dict(wd=0.1, unlocked_groups=GROUPS, num_layers=4, freeze_bn_stats=freeze_bn_stats)
    batch = _distill_batch(2)
    jloss, want = jax_step
    model = CLIP(get_model_config(NAME), torch.float32)
    load_weights(model, state_dict_from_jax(params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    teacher = CLIP(get_model_config(NAME), torch.float32).requires_grad_(False)
    load_weights(teacher, state_dict_from_jax(params))
    state = step.TrainState(model, optim.build_optimizer(model, optim.make_schedule("cosine", **SCHED), **kw))
    metrics = step.make_train_step(methods.clipself_loss, teacher)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(metrics["loss"].item() - jloss) <= TOL
    stats, diffs = 0, []
    for name, p in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            stats += 1
            assert torch.equal(p, before[name]) == freeze_bn_stats, name
            if freeze_bn_stats:
                continue
            assert (p - want[name]).abs().max().item() <= PARAM_MAX, name
        diffs.append((p - want[name]).abs().flatten())
    assert stats == 2 * (3 + 4 * 4)  # the stem's 3 BatchNorms, 3 a bottleneck and its downsample's
    # the other parameters as one population: a tensor of a few hundred
    # entries holds one near-zero gradient or none
    assert (torch.cat(diffs) > PARAM_BULK).float().mean().item() <= PARAM_BULK_SHARE


@pytest.mark.parametrize("name", RN_CONFIGS)
def test_every_resnet_config_builds_the_tower(name):
    """`CLIP(get_model_config(n))` builds a ModifiedResNet for every RN
    config (on the meta device: no memory), with the config's stage depths,
    a pool grid of image_size / 32 and width * 32 / head_width heads."""
    cfg = get_model_config(name)
    with torch.device("meta"):
        model = CLIP(cfg, torch.bfloat16)
    v = model.visual
    assert isinstance(v, ModifiedResNet)
    assert tuple(len(stage) for stage in v.stages) == cfg.vision.resnet_layers
    side = cfg.vision.image_size // 32
    assert v.attnpool.positional_embedding.shape == (side * side + 1, cfg.vision.width * 32)
    assert v.attnpool.num_heads == cfg.vision.width * 32 // cfg.vision.head_width
    assert v.attnpool.c_proj.out_features == cfg.embed_dim


def test_create_model_builds_the_resnet_tower():
    model = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    again = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    sd = model.state_dict()
    assert torch.equal(sd["visual.bn1.running_var"], torch.ones(4))
    assert not sd["visual.layer1.0.bn3.running_mean"].any()
    assert not sd["visual.attnpool.q_proj.bias"].any()
    assert sd["visual.layer1.0.conv2.weight"].std() > 0


def test_trainer_cli_freeze_bn_stats(tmp_path):
    """`--model RN-Tiny-Test --lock-image-freeze-bn-stats` with every group
    unlocked on the CPU: finite losses, every stage and the pool move, no
    BatchNorm statistic does; the flag reaches params.txt."""
    run = train_main.main([
        "--device", "cpu", "--synthetic", "--model", NAME, "--lock-image-unlocked-groups", "5",
        "--lock-image-freeze-bn-stats", "--batch-size", "2", "--det-image-size", "96",
        "--max-boxes", "3", "--steps-per-epoch", "2", "--epochs", "1", "--lr", "1e-3",
        "--warmup", "1", "--logs", str(tmp_path), "--name", "rn",
    ])
    model, teacher = run["state"].model, run["teacher"]
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    init = teacher.state_dict()
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, init[n])}
    assert {n.split(".")[1] for n in moved} == {
        "conv1", "conv2", "conv3", "bn1", "bn2", "bn3", "layer1", "layer2", "layer3", "layer4", "attnpool"}
    assert not any(n.endswith(("running_mean", "running_var")) for n in moved)
    assert "lock_image_freeze_bn_stats: True" in (tmp_path / "rn" / "params.txt").read_text()


def _scripted(sd: dict) -> torch.jit.ScriptModule:
    """A TorchScript module holding ``sd`` under its dotted names, as an
    OpenAI release's archive holds its weights (`test_torch_openai_pretrained.py`)."""
    class Node(torch.nn.Module):
        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return x

    root = Node()
    for key, val in sd.items():
        *path, leaf = key.split(".")
        node = root
        for name in path:
            if not hasattr(node, name):
                node.add_module(name, Node())
            node = getattr(node, name)
        node.register_buffer(leaf, val.clone())
    return torch.jit.script(root)


@pytest.mark.parametrize("which", ["jit", "plain"])
def test_openai_resnet_archive_builds_the_tower(tower, tmp_path, which):
    """An OpenAI-layout ResNet checkpoint (the tiny tower's noisy weights,
    text keys unprefixed, BatchNorm's `num_batches_tracked` beside them), as
    a `torch.jit` archive and as a plain state dict, builds a ModifiedResNet
    through `load_openai_model` with every visual tensor EQUAL to the file's
    and a finite image embedding."""
    from clipself_tpu_torch.models.openai import load_openai_model

    _, params, _ = tower
    sd = state_dict_from_jax(params)
    flat = {(k[len("text."):] if k.startswith("text.") else k): v for k, v in sd.items()}
    flat.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(3)
                 for k in sd if k.endswith("running_mean")})
    path = str(tmp_path / "rn.pt")
    if which == "jit":
        torch.jit.save(_scripted(flat), path)
    else:
        torch.save({"state_dict": flat}, path)
    model = load_openai_model(path, device="cpu", dtype=torch.float32)
    assert isinstance(model.visual, ModifiedResNet) and model.cfg.vision.resnet_layers == (1, 1, 1, 1)
    got = model.state_dict()
    for k, v in sd.items():
        if k.startswith("visual."):
            assert torch.equal(got[k], v), k
    with torch.no_grad():
        assert torch.isfinite(model.encode_image(torch.randn(1, 64, 64, 3))).all()
