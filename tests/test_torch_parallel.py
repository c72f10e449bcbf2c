"""The port's multi-process training (`clipself_tpu_torch/parallel/`, the
mesh paths of `train/{methods,optim,step,checkpoint,contrastive,main}.py`
and `eval/zero_shot.py`) on the CPU: one 8-rank gloo group, spawned once for
the module (`tests/torch_parallel_cases.py`), runs every case on
`EVA02-CLIP-Tiny-Test` with the JAX package's seed-0 weights, while this
process computes the JAX references:

  - two clipself steps on dp 8, dp4 x fsdp2, dp4 x tp2 and dp2 x fsdp2 x tp2
    against one jitted JAX single-device step and the JAX (2, 2, 2) hybrid
    loss, on `tests/test_train_step.py::_batch(rng 0)`;
  - the RegionCLIP loss on 4 batch shards (each a tensor-parallel pair)
    whose ranks hold different numbers of valid boxes and different
    classes, against the JAX single-device loss with the same noise;
  - `local_clip_loss` over the 8 ranks against JAX's `clip_loss`;
  - the evaluator on (2, 2, 2) against the single-process evaluator, fed
    whole batches and fed by the trainer's reader (each rank reads only
    its rows of a batch that divides over the batch shards);
  - one F-ViT train step of preset `tiny_test` on an 8-rank `data` mesh
    against the JAX single-device step and the port's single-process step
    on the same 8 images of 64^2 with 5 boxes each
    (`tests/test_detector_model.py:195-231`) and the JAX key-split noise of
    the global batch (`tests/test_torch_detector_train.py::_loss_noise`),
    then `detector.train.main` on the mesh against one process;
  - `train.main` on (2, 2, 2) under the launcher's variables, its checkpoint
    resumed in this process;
  - FSDP2's share of the state on each rank, the EVA variants' tensor
    parallelism against the unsharded tower, and the kernel wrappers'
    refusal of a DTensor;
  - the OpenCLIP ViT and CLIP text towers tensor-parallel (`ViT-Tiny-Test`,
    seeded weights on the JAX init's shapes): two clipself steps on dp4 x
    tp2 and dp2 x fsdp2 x tp2 against the JAX single-device step and the
    JAX (2, 2, 2) hybrid loss; on (4, 1, 2) against the unsharded model
    (image, v2 dense map, v1 RoIs, text, every sharded leaf's gradient) and
    the checkpoint's round trip; the evaluator at v1 on (2, 1, 2) over four
    of the ranks against one process; `RN-Tiny-Test`'s replicated ResNet
    with its text tower sharded against one process;
  - with no ranks, the plan of every tower family the port builds against
    the leaves JAX's `tp_shardings` shards, and a tree that matches nothing.

Tolerances, with their reasons: the mesh sums the same float32 products in
other groupings (row-parallel partial sums, per-rank box sums, FSDP2's
gradient average): losses rtol 1e-5 and block 1's w3 after two AdamW steps
atol 1e-5 (the bars of `tests/test_train_step.py`'s JAX mesh cases); the
RegionCLIP loss 1e-5 of its value (`tests/test_torch_regionclip.py`); the
local loss and its feature gradients 1e-6 (a [16, 16] logit matrix); the
evaluator's metrics, the checkpoint's tensors and the trainer's resumed
state are EQUAL (top-k decisions and copies); the trainer's losses on the
mesh against its single-process losses rtol 1e-5; the tensor-parallel ViT
against the unsharded model: outputs 1e-5, gradients 1e-4 of each
tensor's largest entry (the EVA variants' bars). The detector: the loss
and every metric within 1e-4 relative of the JAX step (the whole-loss bar
of `tests/test_torch_detector_train.py`: convolutions summed in another
order than XLA's), the loss rtol 1e-5 and the heads after one AdamW step
atol 1e-5 against the port's single-process step (the mesh bars above: the
same products, the counts and the gradients summed over the ranks), the
trainer's logged metrics rtol 1e-5 against one process. The items a rank
reads (the distill loaders, the detector's file route, the evaluator's
reader): exactly its rows' indices, and its rows EQUAL to the whole
batch's cut to them.
"""

import contextlib
import copy
import dataclasses
import logging
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_cases as cases
import torch_coca_cases
import test_torch_timm_towers as timm_cases
from jax.sharding import PartitionSpec
from test_train_step import _batch
from clipself_tpu.core import config as jconfig
from clipself_tpu.detector import config as jdconfig
from clipself_tpu.detector import train as jdtrain
from clipself_tpu.detector.fvit import FViTDetector as JDetector
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.parallel.mesh import create_mesh as jax_create_mesh
from clipself_tpu.parallel.mesh import hybrid_shardings, shard_batch as jax_shard_batch, tp_shardings
from clipself_tpu.train import contrastive as jcontrastive
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu.train import step as jstep
from clipself_tpu_torch.core import config as pmodel_config
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data import loader as dloader
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.detector import classes as dclasses
from clipself_tpu_torch.detector import config as dconfig
from clipself_tpu_torch.detector import fvit as dfvit
from clipself_tpu_torch.detector import rpn as drpn
from clipself_tpu_torch.detector import train as dtrain
from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
from clipself_tpu_torch.models import torch_io
from clipself_tpu_torch.models.factory import create_model, model_class
from clipself_tpu_torch.models.torch_io import detector_state_dict_from_jax, state_dict_from_jax
from clipself_tpu_torch.parallel import mesh as pmesh
from clipself_tpu_torch.parallel import tensor_parallel as tpar
from clipself_tpu_torch.train import checkpoint as ckpt
from clipself_tpu_torch.train import main as train_main
from clipself_tpu_torch.train.optim import Optimizer, make_schedule
from clipself_tpu_torch.train.step import TrainState
from test_torch_detector_train import _loss_noise

from torch_threads import capped_threads  # noqa: F401  (module fixture)

WORLD = 8
LAYERS = get_model_config(cases.NAME).vision.layers
EMBED = get_model_config(cases.NAME).embed_dim
REGION_C, REGION_SAMPLE = 32, 10
LOSS_RTOL, W3_ATOL, REGION_REL, CLIP_TOL, TRAINER_RTOL = 1e-5, 1e-5, 1e-5, 1e-6, 1e-5
DET_JAX_REL, DET_HEADS_ATOL = 1e-4, 1e-5
DET_ARGV = ["--synthetic", "--preset", "tiny_test", "--device", "cpu", "--precision", "fp32",
            "--batch-size", "8", "--epochs", "1", "--steps-per-epoch", "2", "--log-every", "1"]


def _region_batch():
    """[8, 4, 6] region boxes over 32^2 images: image i has i % 4 + 1 valid
    boxes, so the 4 batch shards (2 images each) hold 3, 7, 3 and 7 valid
    boxes, with classes drawn apart. The invalid rows keep a box (the JAX
    package's gradient is NaN at a zero row)."""
    rng = np.random.default_rng(11)
    b, m = 8, 4
    xy = rng.uniform(0, 0.5, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    labels = rng.integers(0, REGION_C, (b, m, 1))
    valid = (np.arange(m)[None, :] < (np.arange(b) % 4 + 1)[:, None])[..., None]
    boxes = np.concatenate([xy, xy + wh, labels, valid], -1).astype(np.float32)
    return {"images": rng.standard_normal((b, 32, 32, 3)).astype(np.float32), "boxes": boxes}


def _eval_batches():
    """Three evaluator batches of 4 images (they split over the 4 batch
    shards) and a tail of 3 (every rank encodes all of it)."""
    kw = dict(image_size=32, max_anns=6, valid_anns=5, crop_size=32, mask_hw=4, n_classes=8)
    return [synthetic_panoptic_batch(i, batch=4, **kw) for i in range(3)] + [
        synthetic_panoptic_batch(3, batch=3, **kw)
    ]


def _seeded_weights(shapes, rng):
    """Seeded float32 weights on a tree of shapes: a kernel of spread
    fan_in^-0.5, a norm scale 1 + 0.1 noise, the learned temperature 37,
    any other leaf 0.1 noise."""
    def leaf(path, x):
        z = rng.standard_normal(x.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z * np.float32(np.prod(x.shape[:-1]) ** -0.5)
        if name == "temperature":
            return np.full(x.shape, 37.0, np.float32)
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _det_case():
    """The detector step's inputs: preset `tiny_test` with seeded weights on
    the shapes of the JAX inits (no init compiled), the 8 images of 64^2
    with 5 boxes each of `tests/test_detector_model.py:195-231`, the coco
    class weights, and the JAX step's key (4)."""
    jcfg = jdconfig.PRESETS["tiny_test"]
    jclip, _ = jax_create_model(jcfg.clip_model, dtype=jnp.float32, init=False)
    rng = np.random.default_rng(21)
    clip_params = _seeded_weights(
        jax.eval_shape(lambda: jax_create_model(jcfg.clip_model, dtype=jnp.float32, seed=0)[1]), rng,
    )
    ce = rng.standard_normal((jcfg.num_classes + 1, jcfg.embed_dim)).astype(np.float32)
    ce /= np.linalg.norm(ce, axis=-1, keepdims=True)
    jdet = JDetector(jcfg, dtype=jnp.float32)
    taps = [jax.ShapeDtypeStruct((1, 8, 8, jcfg.backbone_width), jnp.float32)] * len(jcfg.out_indices)
    heads = _seeded_weights(jax.eval_shape(
        lambda t: jdet.init(jax.random.PRNGKey(1), t, jnp.ones((1, 1, 4)), jnp.asarray(ce))["params"], taps,
    ), rng)
    rng = np.random.default_rng(11)
    b = 8
    images = rng.normal(size=(b, 64, 64, 3)).astype(np.float32)
    xy = rng.uniform(0, 30, size=(b, 5, 2)).astype(np.float32)
    wh = rng.uniform(8, 30, size=(b, 5, 2)).astype(np.float32)
    batch = {
        "images": images,
        "gt_boxes": np.concatenate([xy, np.clip(xy + wh, None, 64)], -1),
        "gt_labels": rng.integers(0, 6, size=(b, 5)).astype(np.int32),
        "gt_valid": np.ones((b, 5), bool),
    }
    cw = dclasses.class_weights("coco", jcfg.bg_weight).astype(np.float32)
    cfg = dconfig.PRESETS["tiny_test"]
    key = jax.random.PRNGKey(4)
    # the JAX step folds its step count (0) into the key before the loss
    noise = _loss_noise(jax.random.fold_in(key, 0), b, drpn.num_anchors(cfg),
                        cfg.train_proposals.max_per_img + cfg.max_gt)
    return {
        "jcfg": jcfg, "jclip": jclip, "clip_params": clip_params, "jdet": jdet, "heads": heads,
        "batch": batch, "ce": ce, "cw": cw, "key": key, "noise": noise,
        "clip_sd": state_dict_from_jax(clip_params), "heads_sd": detector_state_dict_from_jax(heads),
    }


def _det_references(c: dict) -> dict:
    """The JAX single-device step (its metrics) and the port's
    single-process step on the same weights, batch and noise (its metrics
    and heads after the update)."""
    tx = jdtrain.build_det_optimizer()
    step = jdtrain.make_det_train_step(
        c["jdet"], c["jclip"], tx, c["jcfg"], jnp.asarray(c["ce"]), jnp.asarray(c["cw"]), mesh=None,
    )
    jbatch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    _, jm = step(jdtrain.DetTrainState.create(c["heads"], tx), c["clip_params"], jbatch, c["key"])

    cfg = dconfig.PRESETS["tiny_test"]
    det = dfvit.FViTDetector(cfg)
    det.load_state_dict(c["heads_sd"], strict=True)
    clip = cases.tiny_model(c["clip_sd"], cfg.clip_model).requires_grad_(False)
    state = dtrain.DetTrainState(det, dtrain.build_det_optimizer(det))
    drawn, dtrain.draw_noise = dtrain.draw_noise, lambda *_: c["noise"]
    try:
        step = dtrain.make_det_train_step(
            clip, cfg, torch.from_numpy(c["ce"]), torch.from_numpy(c["cw"]), torch.Generator(),
        )
        pm = step(state, {k: torch.from_numpy(v) for k, v in c["batch"].items()})
    finally:
        dtrain.draw_noise = drawn
    return {
        "jax": {k: float(v) for k, v in jm.items()},
        "port": {k: float(v) for k, v in pm.items()},
        "heads": {k: v.clone() for k, v in det.state_dict().items()},
    }


def _trainer_argv(logs, name, epochs, *flags):
    return [
        "--device", "cpu", "--synthetic", "--model", cases.NAME, "--precision", "fp32",
        "--batch-size", "8", "--det-image-size", "32", "--max-boxes", "3",
        "--steps-per-epoch", "2", "--epochs", str(epochs), "--lr", "1e-3", "--warmup", "1",
        "--log-every-n-steps", "1", "--lock-image-unlocked-groups", "1", "--accum-freq", "2",
        "--grad-clip-norm", "0.5", "--workers", "0", "--logs", str(logs), "--name", name,
        *flags,
    ]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and this process's references."""
    jmodel, params = jax_create_model(cases.NAME, dtype=jnp.float32, seed=0)
    params = jax.tree.map(np.asarray, params)
    batch = {k: np.asarray(v) for k, v in _batch(np.random.default_rng(0)).items()}
    rng = np.random.default_rng(5)
    nouns = rng.standard_normal((REGION_C, EMBED)).astype(np.float32)
    nouns /= np.linalg.norm(nouns, axis=-1, keepdims=True)
    region_key = jax.random.PRNGKey(5)
    logs = tmp_path_factory.mktemp("parallel_logs")
    det_case = _det_case()
    det_out = tmp_path_factory.mktemp("detector_out")
    vit_model, _ = jax_create_model(cases.VIT, dtype=jnp.float32, init=False)
    vit_params = _seeded_weights(jax.eval_shape(
        lambda: jax_create_model(cases.VIT, dtype=jnp.float32, seed=0)[1]), np.random.default_rng(3),
    )
    rn = create_model(cases.RN, device="cpu", dtype=torch.float32, seed=0)
    _, _, coca, coca_cfg, _ = torch_coca_cases.build("vit")
    coca_image, coca_text = torch_coca_cases.inputs()
    payload = {
        "state_dict": state_dict_from_jax(params),
        "vit_state_dict": state_dict_from_jax(vit_params),
        "rn_state_dict": {k: v.clone() for k, v in rn.state_dict().items()},
        "batch": batch,
        "rn_batch": {k: np.asarray(v) for k, v in _batch(np.random.default_rng(1), s=64, crop=64).items()},
        "tp_text": np.random.default_rng(6).integers(1, 512, (2, 16)).astype(np.int64),
        "coca_cfg": coca_cfg,
        "coca_state_dict": {k: v.clone() for k, v in coca.state_dict().items()},
        "coca_image": coca_image,
        "coca_text": coca_text,
        "region_batch": _region_batch(),
        "nouns": nouns,
        "region_noise": np.asarray(jax.random.uniform(region_key, (REGION_C,))),
        "region_sample": REGION_SAMPLE,
        "clip_image": rng.standard_normal((16, 12)).astype(np.float32),
        "clip_text": rng.standard_normal((16, 12)).astype(np.float32),
        "clip_scale": 3.5,
        "eval_batches": _eval_batches(),
        "eval_embeddings": class_embeddings(8, EMBED, seed=2),
        "eval_bucket": 4,
        "trainer_argv": _trainer_argv(logs, "mesh", 1, "--fsdp-size", "2", "--tp-size", "2"),
        "trainer_resume_argv": _trainer_argv(
            logs, "mesh", 2, "--fsdp-size", "2", "--tp-size", "2", "--resume", "auto",
        ),
        "det_clip": det_case["clip_sd"],
        "det_heads": det_case["heads_sd"],
        "det_batch": det_case["batch"],
        "det_ce": det_case["ce"],
        "det_cw": det_case["cw"],
        "det_noise": {k: t.numpy() for k, t in det_case["noise"]._asdict().items()},
        "det_argv": DET_ARGV,
        "det_out": str(det_out),
    }
    group = cases.Group(WORLD, payload)

    # the JAX references, while the ranks run
    ref = {}
    sched = joptim.make_schedule("cosine", cases.LR, warmup=cases.WARMUP, total_steps=cases.TOTAL)

    def jax_run(mesh, shard, jm=jmodel, p=params):
        tx = joptim.build_optimizer(p, sched, wd=cases.WD, unlocked_groups=LAYERS, num_layers=LAYERS)
        state = jstep.TrainState.create(jax.tree.map(jnp.array, p), tx)
        teacher = jax.tree.map(jnp.array, p)
        state_sh = teacher_sh = None
        if shard:
            state_sh = hybrid_shardings(mesh, state, min_size=128)
            teacher_sh = hybrid_shardings(mesh, teacher, min_size=128)
            state = jax.tree.map(jax.device_put, state, state_sh)
            teacher = jax.tree.map(jax.device_put, teacher, teacher_sh)
        step = jstep.make_train_step(
            jm, tx, jmethods.clipself_loss, mesh=mesh,
            state_sharding=state_sh, teacher_sharding=teacher_sh,
        )
        jb = jax_shard_batch(mesh, batch) if mesh is not None else {k: jnp.asarray(v) for k, v in batch.items()}
        return step, state, teacher, jb

    def distill_refs(jm, p, weight):
        """Two single-device steps (the losses, ``weight`` after them) and
        the first (2, 2, 2) hybrid step's loss."""
        step, state, teacher, jb = jax_run(None, False, jm, p)
        out = {"losses": []}
        for _ in range(2):
            state, metrics = step(state, teacher, jb, jax.random.PRNGKey(0))
            out["losses"].append(float(metrics["loss"]))
        out["weight"] = np.asarray(weight(state.params)).T
        hy_mesh = jax_create_mesh(8, axis_names=("data", "fsdp", "model"), shape=(2, 2, 2))
        step, state, teacher, jb = jax_run(hy_mesh, True, jm, p)
        out["hybrid_loss"] = float(step(state, teacher, jb, jax.random.PRNGKey(0))[1]["loss"])
        return out

    ref["eva"] = distill_refs(jmodel, params, lambda p: p["visual"]["blocks_1"]["mlp"]["w3"]["kernel"])
    ref["vit"] = distill_refs(vit_model, vit_params, lambda p: p["visual"]["resblocks_1"]["c_proj"]["kernel"])

    rb = {k: jnp.asarray(v) for k, v in payload["region_batch"].items()}
    ref["region_loss"] = float(jax.jit(
        lambda p, b: jmethods.regionclip_loss(
            p, None, b, jmodel, region_key, noun_embeddings=jnp.asarray(nouns),
            num_sample_cats=REGION_SAMPLE,
        )[0]
    )(params, rb))
    img, txt = (jnp.asarray(payload[k]) for k in ("clip_image", "clip_text"))
    ref["clip_loss"], (ref["d_image"], ref["d_text"]) = jax.value_and_grad(
        lambda i, t: jcontrastive.clip_loss(i, t, payload["clip_scale"]), argnums=(0, 1)
    )(img, txt)

    model = cases.tiny_model(payload["state_dict"]).requires_grad_(False)
    ref["eval"] = evaluate_zero_shot(
        model, payload["eval_batches"], payload["eval_embeddings"], device="cpu",
        ann_bucket=payload["eval_bucket"],
    )
    vit = cases.tiny_model(payload["vit_state_dict"], cases.VIT).requires_grad_(False)
    ref["vit_eval"] = evaluate_zero_shot(
        vit, payload["eval_batches"], payload["eval_embeddings"], device="cpu",
        ann_bucket=payload["eval_bucket"], extract_type="v1",
    )
    ref["trainer"] = train_main.main(_trainer_argv(logs, "single", 2))
    ref["detector"] = _det_references(det_case)
    ref["detector_main"] = dtrain.main(DET_ARGV + ["--output", str(det_out / "single")])
    ranks = group.results()
    return {"ranks": ranks, "ref": ref, "payload": payload, "logs": logs}


@pytest.mark.parametrize("mesh", list(cases.DISTILL_MESHES))
def test_distill_steps_on_a_mesh_match_the_jax_single_device_step(run, mesh):
    ref = run["ref"]["eva"]
    got = run["ranks"][0][mesh]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][0], ref["hybrid_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["w3"], ref["weight"], rtol=0, atol=W3_ATOL)
    assert got["losses"][1] < got["losses"][0]
    for r in run["ranks"][1:]:  # every rank logs the global loss
        assert r[mesh]["losses"] == got["losses"]
    # the tensor-parallel meshes shard both branches of both blocks
    if cases.DISTILL_MESHES[mesh][2] > 1:
        assert "visual.blocks.1.attn.q_proj.weight" in got["plan"] and f"{cases.W3}" in got["plan"]
    else:
        assert got["plan"] == []


def test_fsdp2_holds_half_the_state_on_each_rank(run):
    """On dp4 x fsdp2 each rank holds at most half of the student's
    parameters, of its AdamW moments and of the teacher, plus the rows that
    FSDP2 cannot split evenly (a leaf whose first axis is odd) and the
    scalar it leaves whole (`logit_scale`)."""
    model = cases.tiny_model(run["payload"]["state_dict"])
    params = list(model.parameters())
    total = sum(p.numel() for p in params)
    uneven = sum(p.numel() // p.shape[0] * (p.shape[0] % 2) for p in params if p.dim())
    scalars = sum(p.numel() for p in params if p.dim() == 0)
    trainable_total = sum(p.numel() for n, p in model.named_parameters()
                          if n.startswith("visual.") and ".blocks." in n)
    bound = total / 2 + uneven + scalars
    for r in run["ranks"]:
        got = r["dp4_fsdp2"]
        assert got["student_numel"] <= bound and got["teacher_numel"] <= bound
        # two moments for each trainable leaf (the blocks, all unlocked)
        assert got["adam_numel"] <= trainable_total + 2 * uneven
        assert got["student_numel"] < 0.6 * total
    # the two fsdp ranks of a data replica hold the whole model between them
    pair = [run["ranks"][r]["dp4_fsdp2"]["student_numel"] for r in (0, 1)]
    assert sum(pair) == total + scalars


def test_regionclip_loss_on_a_mesh_matches_jax(run):
    got = [r["region"] for r in run["ranks"]]
    assert abs(got[0]["loss"] - run["ref"]["region_loss"]) <= REGION_REL * abs(run["ref"]["region_loss"])
    # the batch shards (ranks 0, 2, 4, 6) held different boxes and classes
    shards = [got[r] for r in (0, 2, 4, 6)]
    assert len({s["boxes"] for s in shards}) > 1
    assert len({tuple(s["classes"]) for s in shards}) == 4
    assert all(g["loss"] == got[0]["loss"] for g in got)


def test_local_clip_loss_matches_jax_clip_loss(run):
    ref = run["ref"]
    got = [r["local_clip"] for r in run["ranks"]]
    for g in got:
        assert abs(g["loss"] - float(ref["clip_loss"])) <= CLIP_TOL
    np.testing.assert_allclose(np.concatenate([g["d_image"] for g in got]), ref["d_image"], atol=CLIP_TOL)
    np.testing.assert_allclose(np.concatenate([g["d_text"] for g in got]), ref["d_text"], atol=CLIP_TOL)


def test_sharded_evaluator_equals_the_single_process_one(run):
    ref = run["ref"]["eval"]
    assert ref and set(ref) == set(run["ranks"][0]["eval"])
    for r in run["ranks"]:
        assert r["eval"] == pytest.approx(ref, rel=0, abs=0, nan_ok=True)


def test_sharded_evaluator_reads_only_its_rows_and_equals_the_single_process_one(run):
    """The trainer's reader on (2, 2, 2): batch shard i reads image i of
    each batch of 4 and the whole tail of 3 (3 does not divide over 4
    shards); the metrics are the single-process ones, EQUAL."""
    ref = run["ref"]["eval"]
    for r in run["ranks"]:
        got = r["eval_reader"]
        assert got["metrics"] == pytest.approx(ref, rel=0, abs=0, nan_ok=True)
        i = got["batch_index"]
        assert got["read"] == [i, 4 + i, 8 + i, 12, 13, 14]


def test_detector_step_on_a_data_mesh_matches_jax_and_one_process(run):
    """One `tiny_test` step over 8 ranks of one image each: every rank logs
    the global metrics; they match the JAX single-device step (1e-4
    relative) and the port's single-process step (loss rtol 1e-5), and the
    heads after the AdamW update match the single-process heads (atol
    1e-5)."""
    ref = run["ref"]["detector"]
    got = run["ranks"][0]["detector"]
    assert got["metrics"].keys() == ref["jax"].keys() == ref["port"].keys()
    for k, want in ref["jax"].items():
        assert abs(got["metrics"][k] - want) <= DET_JAX_REL * abs(want), (k, got["metrics"][k], want)
    np.testing.assert_allclose(got["metrics"]["loss"], ref["port"]["loss"], rtol=LOSS_RTOL)
    assert got["metrics"]["num_pos_roi"] > 0 and got["metrics"]["rpn_num_pos"] > 0
    for r in run["ranks"][1:]:
        assert r["detector"]["metrics"] == got["metrics"]
    assert got["heads"].keys() == ref["heads"].keys()
    for name, want in ref["heads"].items():
        torch.testing.assert_close(got["heads"][name], want, rtol=0, atol=DET_HEADS_ATOL, msg=name)


def test_detector_trainer_on_a_data_mesh_matches_one_process_and_rank_0_alone_writes(run):
    """`detector.train.main` under the launcher's variables: an (8, 1, 1)
    mesh with no flag, its logged global metrics within rtol 1e-5 of the
    single-process run's, and the checkpoint written by rank 0 alone."""
    single = run["ref"]["detector_main"]
    assert single["mesh"] is None
    want = [h["metrics"] for h in single["history"]]
    for rank, r in enumerate(run["ranks"]):
        got = r["detector"]
        assert got["mesh"] == (WORLD, 1, 1)
        assert got["files"] == (["detector_epoch0.pkl"] if rank == 0 else [])
        assert len(got["main"]) == len(want) == 2
        for g, w in zip(got["main"], want):
            assert g.keys() == w.keys()
            np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=TRAINER_RTOL)


def test_trainer_on_a_mesh_matches_one_process_and_its_checkpoint_resumes_in_one(run):
    """`train.main` on (2, 2, 2) with gradient accumulation and clipping,
    one epoch, then a second resumed on the mesh from its checkpoint, against
    two epochs in one process; then the last checkpoint (written by rank 0
    alone, in the single-process format) restored into a single-process
    state: the weights and the optimizer state are those the mesh ended
    with."""
    got = run["ranks"][0]["trainer"]
    single = run["ref"]["trainer"]
    assert got["shape"] == (2, 2, 2)
    np.testing.assert_allclose(
        [h["loss"] for h in got["history"]], [h["loss"] for h in single["history"]], rtol=TRAINER_RTOL,
    )
    run_dir = os.path.join(run["logs"], "mesh")
    assert sorted(os.listdir(run_dir)) == ["checkpoints", "out.log", "params.txt"]
    model = cases.tiny_model(run["payload"]["state_dict"])
    opt = Optimizer(
        model, make_schedule("cosine", 1e-3, 1, 2), unlocked_groups=1, num_layers=LAYERS,
        accum_steps=2, grad_clip_norm=0.5,
    )
    state, epoch = ckpt.restore_checkpoint(os.path.join(run_dir, "checkpoints"), TrainState(model, opt))
    assert epoch == 2 and state.step == got["step"] == 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, got["model"][k]), k
    want, have = got["opt"], opt.state_dict()
    assert want.keys() == have.keys() and want["param_groups"] == have["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(have["state"][i][k], v), (i, k)
    for a, b in zip(have["accumulated"], want["accumulated"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", list(cases.VARIANTS))
def test_tensor_parallel_eva_variants_match_the_unsharded_tower(run, variant):
    """The fused `qkv` split by heads within q, k and v, the GELU MLP, the
    post-norm blocks and the per-block and shared rel-pos tables split by
    heads, on (4, 1, 2): outputs within 1e-5 of the unsharded tower's
    (float32, the row-parallel sums in other groupings), gradients within
    1e-4 of each tensor's largest entry, the bar of
    `tests/test_torch_eva_variants.py` (a rel-pos table's gradient sums the
    bias gradient of every token pair that shares its row)."""
    got = run["ranks"][0]["variants"][variant]
    assert "visual.blocks.0.attn.qkv.weight" in got["plan"]
    assert any(n.endswith("relative_position_bias_table") for n in got["plan"])
    for key in ("image", "dense"):
        np.testing.assert_allclose(got["sharded"][key], got["plain"][key], rtol=0, atol=1e-5)
    assert got["plain"]["grads"].keys() == got["sharded"]["grads"].keys()
    for name, want in got["plain"]["grads"].items():
        np.testing.assert_allclose(
            got["sharded"]["grads"][name], want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-8, err_msg=name,
        )


@pytest.mark.parametrize("mesh", list(cases.VIT_MESHES))
def test_vit_distill_steps_on_a_tp_mesh_match_the_jax_single_device_step(run, mesh):
    """`ViT-Tiny-Test`, its resblocks and text tower tensor-parallel: two
    clipself steps on dp4 x tp2 and dp2 x fsdp2 x tp2 against the JAX
    single-device step of the same weights and the first against the JAX
    (2, 2, 2) hybrid step, at the EVA meshes' bars; block 1's `c_proj`
    after two AdamW steps."""
    ref = run["ref"]["vit"]
    got = run["ranks"][0][mesh]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][0], ref["hybrid_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["w3"], ref["weight"], rtol=0, atol=W3_ATOL)
    assert got["losses"][1] < got["losses"][0]
    for r in run["ranks"][1:]:
        assert r[mesh]["losses"] == got["losses"]
    assert "visual.transformer.resblocks.1.attn.in_proj_weight" in got["plan"] and cases.C_PROJ in got["plan"]
    assert {f"text.transformer.resblocks.{i}.{leaf}" for i in range(2)
            for leaf in ("attn.in_proj_weight", "mlp.c_proj.weight")} <= set(got["plan"])


@pytest.mark.parametrize("output", ["image", "dense", "v1", "text"])
def test_tensor_parallel_vit_matches_the_unsharded_model(run, output):
    """`ViT-Tiny-Test` laid out on (4, 1, 2) against the same model
    unsharded on the same rank: the image embedding, the dense map (v2), the
    v1 RoI features (mask-attention pooling over the rank's heads) and the
    text embedding within 1e-5 (float32, the row-parallel sums in other
    groupings), and the gradients of their squares' sum at every sharded
    leaf, gathered whole, within 1e-4 of each tensor's largest entry."""
    got = run["ranks"][0]["vit_tp"]
    np.testing.assert_allclose(got["sharded"][output], got["plain"][output], rtol=0, atol=1e-5)
    if output == "image":
        assert got["plain"]["grads"].keys() == got["sharded"]["grads"].keys() == set(got["plan"])
        for name, want in got["plain"]["grads"].items():
            np.testing.assert_allclose(
                got["sharded"]["grads"][name], want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-8, err_msg=name,
            )


def test_full_state_dict_of_a_tensor_parallel_vit_round_trips(run):
    """On the ranks, `full_state_dict` of the sharded ViT model (the
    checkpoint's format) is the unsharded state dict, EQUAL, and stays so
    after `load_full_state_dict` of it."""
    for r in run["ranks"]:
        assert r["vit_tp"]["state_equal"] and r["vit_tp"]["round_trip_equal"]


def test_replicated_resnet_tower_on_a_tp_mesh_matches_one_process(run):
    """`RN-Tiny-Test` on (4, 1, 2): the plan shards its text tower alone (the
    ResNet matches no rule and stays whole on every rank, as in JAX); two
    clipself steps equal the one-process steps (rtol 1e-5) and the text
    embedding the unsharded tower's (1e-5)."""
    for r in run["ranks"]:
        got = r["rn_tp"]
        assert got["plan"] and all(n.startswith("text.transformer.resblocks.") for n in got["plan"])
        np.testing.assert_allclose(got["sharded"], got["plain"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["sharded_text"], got["plain_text"], rtol=0, atol=1e-5)


def test_tensor_parallel_vit_evaluator_at_v1_equals_the_single_process_one(run):
    """The evaluator of `ViT-Tiny-Test` at extract type v1 on a (4, 1, 2)
    mesh: EQUAL to the single-process evaluator."""
    ref = run["ref"]["vit_eval"]
    assert ref
    for r in run["ranks"]:
        assert r["vit_eval"] == pytest.approx(ref, rel=0, abs=0, nan_ok=True)


@pytest.mark.parametrize("output", ["image_features", "text_features", "logits", "loss"])
def test_tensor_parallel_coca_matches_the_unsharded_model(run, output):
    """The tiny CoCa ("vit": the OpenCLIP ViT with the attentional pooler,
    the `embed_cls` text tower, a 2-layer decoder) laid out on (4, 1, 2)
    against the same model unsharded on the same rank: the forward's
    features and caption logits within 1e-5, `coca_loss` rtol 1e-5, and the
    loss's gradients at every sharded leaf (the decoder's self-attention
    blocks among them, its cross-attention whole), gathered whole, within
    1e-4 of each tensor's largest entry."""
    for r in run["ranks"]:
        got = r["coca_tp"]
        if output == "loss":
            np.testing.assert_allclose(got["sharded"]["loss"], got["plain"]["loss"], rtol=LOSS_RTOL)
        else:
            np.testing.assert_allclose(got["sharded"][output], got["plain"][output], rtol=0, atol=1e-5)
    got = run["ranks"][0]["coca_tp"]
    plan = set(got["plan"])
    assert {f"text_decoder.resblocks.{i}.{leaf}" for i in range(2)
            for leaf in ("attn.in_proj_weight", "mlp.c_proj.weight")} <= plan
    assert not any(".cross_attn." in n or "attn_pool" in n for n in plan)
    if output == "loss":
        assert got["plain"]["grads"].keys() == got["sharded"]["grads"].keys() == plan
        for name, want in got["plain"]["grads"].items():
            np.testing.assert_allclose(
                got["sharded"]["grads"][name], want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-8, err_msg=name,
            )


# ---- the plan against JAX's tp_shardings, no ranks -------------------------

@contextlib.contextmanager
def _tiny_timm_archs():
    """The tiny timm arch entries of `test_torch_timm_towers.py` in both
    packages' tables, taken out after."""
    for jtable, ttable, tiny in timm_cases.TABLES:
        jtable.update(tiny)
        ttable.update(tiny)
    try:
        yield
    finally:
        for jtable, ttable, tiny in timm_cases.TABLES:
            for name in tiny:
                jtable.pop(name, None)
                ttable.pop(name, None)


def _rel_pos_cfg(pkg):
    cfg = pkg.get_model_config(cases.NAME)
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **cases.VARIANTS["eva01_rel_pos"]))


# family -> (JAX config, port config) at the tiny test size
PLAN_FAMILIES = {
    "eva02": lambda: (jconfig.get_model_config(cases.NAME), get_model_config(cases.NAME)),
    "eva01_rel_pos": lambda: (_rel_pos_cfg(jconfig), _rel_pos_cfg(pmodel_config)),
    "vit": lambda: (jconfig.get_model_config(cases.VIT), get_model_config(cases.VIT)),
    "rn": lambda: (jconfig.get_model_config(cases.RN), get_model_config(cases.RN)),
    "hf_vit": lambda: (jconfig.get_model_config("hf-vit-tiny-test"), get_model_config("hf-vit-tiny-test")),
    "coca_eva": lambda: (torch_coca_cases.coca_config("eva", jconfig), torch_coca_cases.coca_config("eva")),
    "coca_vit": lambda: (torch_coca_cases.coca_config("vit", jconfig), torch_coca_cases.coca_config("vit")),
    "convnext": lambda: (timm_cases.jcfg("convnext"), timm_cases.tcfg("convnext")),
    "swin": lambda: (timm_cases.jcfg("swin"), timm_cases.tcfg("swin")),
    "timm_vit": lambda: (timm_cases.jcfg("vit_relpos"), timm_cases.tcfg("vit_relpos")),
}


def _jax_sharded(jcfg, cfg, part=None, size=2) -> set:
    """The port's names of the leaves that JAX's `tp_shardings` shards on a
    ('data', 'model') = (8 / size, size) mesh, over the whole tree (or its
    ``part``)."""
    shapes = jax.eval_shape(lambda: jax_create_model(jcfg, dtype=jnp.float32, seed=0)[1])
    tree = shapes if part is None else {part: shapes[part]}
    mesh = jax_create_mesh(8, axis_names=("data", "model"), shape=(8 // size, size))
    specs = torch_io._flatten(tp_shardings(mesh, tree))
    return {torch_io.flax_to_torch_key(path, cfg)[0] for path, s in specs.items() if s.spec != PartitionSpec()}


@pytest.mark.parametrize("family", list(PLAN_FAMILIES))
def test_tp_plan_shards_the_leaves_jax_tp_shardings_shards(family):
    """For each tower family the port builds, at its tiny size, the plan at
    group size 2 shards exactly the leaves that JAX's `tp_shardings` shards
    on a (4, 2) mesh, but for the port's own layout of the EVA rel-pos
    tables (split by heads with their attention; JAX replicates them). An
    `in_proj` whose heads do not divide would be the other difference: no
    tiny config has one. The timm towers, the ResNet, the HF trunk and
    CoCa's cross-attention and pooler stay whole, as in JAX."""
    with _tiny_timm_archs():
        jcfg, cfg = PLAN_FAMILIES[family]()
        want = _jax_sharded(jcfg, cfg)
        model = model_class(cfg)(cfg, torch.float32)
    got = set(tpar.tp_plan(model, 2))
    tables = {n for n in got if n.endswith("relative_position_bias_table")}
    assert got - tables == want
    assert bool(tables) == (family == "eva01_rel_pos")
    assert not any(".cross_attn." in n or "attn_pool" in n for n in got)
    if family in ("convnext", "swin", "timm_vit", "rn", "hf_vit"):
        assert got and not any(n.startswith("visual.") for n in got)


def test_tp_plan_keeps_an_attention_whose_heads_do_not_divide_whole():
    """`ViT-Tiny-Test` (2 heads) at group size 4: JAX shards `in_proj` (3W
    divides) and `out_proj` (W divides); the port keeps each attention
    branch whole, since its heads do not divide, and shards the MLPs (hidden
    256) as JAX does."""
    jcfg, cfg = PLAN_FAMILIES["vit"]()
    want = _jax_sharded(jcfg, cfg, size=4)
    got = set(tpar.tp_plan(model_class(cfg)(cfg, torch.float32), 4))
    assert got and not any(".attn." in n for n in got)
    assert want - got == {n for n in want if ".attn." in n} != set()


def test_tp_plan_of_a_tree_that_matches_nothing_is_empty_and_warns(caplog):
    """A tree without a block that takes a group (the ConvNeXt tower alone):
    JAX's `tp_shardings` shards nothing and warns; the port's plan is empty,
    nothing is sliced, and it warns too."""
    with _tiny_timm_archs():
        jcfg, cfg = PLAN_FAMILIES["convnext"]()
        with caplog.at_level(logging.WARNING, logger="clipself_tpu"):
            assert _jax_sharded(jcfg, cfg, part="visual") == set()
        assert "no parameter matched" in caplog.text
        caplog.clear()
        tower = model_class(cfg)(cfg, torch.float32).visual
    before = {n: p.shape for n, p in tower.named_parameters()}
    with caplog.at_level(logging.WARNING, logger="clipself_tpu_torch"):
        plan = tpar.shard_tensor_parallel(tower, tpar.TensorParallel(None, 0, 2))
    assert plan == {} and "no parameter matched" in caplog.text
    assert {n: p.shape for n, p in tower.named_parameters()} == before
    assert not any(getattr(m, "tp", None) for m in tower.modules())


def test_kernel_wrappers_refuse_a_dtensor(run):
    got = run["ranks"][0]["dtensor"]
    assert set(got) == {"layer_norm", "layer_norm_bwd", "flash_attention", "flash_attention_bwd",
                        "rolled_rope", "nms_keep_mask"}
    for name, msg in got.items():
        assert msg is not None and msg.startswith(f"{name}: got a DTensor"), name


def _fake_mesh(shape, coords):
    return pmesh.Mesh(shape=shape, coords=coords, device=torch.device("cpu"), device_mesh=None,
                      batch_group=None, shard_group=None, tp=tpar.TensorParallel(None, coords[2], shape[2]))


@pytest.mark.parametrize("shape", [(8, 1, 1), (4, 2, 1), (4, 1, 2), (2, 2, 2), (1, 1, 8)])
def test_batch_rows_follow_the_jax_batch_sharding(shape):
    """Rank (d, f, t) holds rows [i b / n, (i + 1) b / n), i = d fsdp + f;
    the ranks of one `model` group hold the same rows; a batch that does
    not divide over the batch shards stays whole on every rank."""
    b, n = 8, shape[0] * shape[1]
    coords = np.argwhere(np.ones(shape)).tolist()
    rows = {tuple(c): pmesh.batch_rows(_fake_mesh(shape, tuple(c)), b) for c in coords}
    for (d, f, t), r in rows.items():
        i = d * shape[1] + f
        assert r == (slice(None) if n == 1 else slice(i * b // n, (i + 1) * b // n))
    assert len(set(map(str, rows.values()))) == n
    assert pmesh.batch_rows(_fake_mesh(shape, (0, 0, 0)), 7) == slice(None)


@pytest.mark.parametrize("split", [tpar.Split(0), tpar.Split(1), tpar.Split(0, 3)])
def test_tensor_parallel_slices_reassemble(split):
    full = torch.arange(18 * 12, dtype=torch.float32).reshape(18, 12)
    for size in (1, 2, 3):
        parts = [tpar.shard_tensor(full, split, r, size) for r in range(size)]
        assert torch.equal(tpar.unshard_tensor(parts, split), full)
    # the fused qkv rows: each rank holds its heads of q, of k and of v
    q, k, v = full.chunk(3)
    assert torch.equal(tpar.shard_tensor(full, tpar.Split(0, 3), 1, 2), torch.cat([q[3:], k[3:], v[3:]]))


def test_init_distributed_without_a_launcher_does_nothing_and_a_failed_start_raises(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed(torch.device("cpu")) is None
    monkeypatch.setenv("SLURM_NTASKS", "1")  # a one-task SLURM job is no launch
    assert pmesh.init_distributed(torch.device("cpu")) is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="needs MASTER_ADDR"):
        pmesh.init_distributed(torch.device("cpu"))
    assert pmesh.launcher_env({"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "3",
                               "OMPI_COMM_WORLD_LOCAL_RANK": "1"}) == (4, 3, 1)


def test_one_process_launch_repeats_the_unwrapped_run(tmp_path):
    """`tools/train_repeat.py` (what `chip_smoke.py::phase_parallel` runs):
    `train.main` under a one-process launch, a (1, 1, 1) gloo mesh with
    FSDP2 and the tensor-parallel plan in this process, against the same run
    without one. On the CPU every operation repeats, so the losses, the
    first step's gradient and the weight after the run are EQUAL; the
    launcher's variables and the group are gone after the call."""
    from clipself_tpu_torch.tools import train_repeat

    argv = ["--synthetic", "--model", cases.NAME, "--precision", "fp32", "--device", "cpu",
            "--batch-size", "2", "--det-image-size", "32", "--max-boxes", "3", "--steps-per-epoch", "2",
            "--epochs", "1", "--lr", "1e-3", "--warmup", "1", "--logs", str(tmp_path)]
    plain = train_repeat.run_once(argv + ["--name", "plain"], cases.W3, sharded=False)
    sharded = train_repeat.run_once(argv + ["--name", "sharded", "--n-devices", "1"], cases.W3, sharded=True)
    assert plain["mesh"] is None and sharded["mesh"] == (1, 1, 1)
    assert plain["tp_modules"] == 0 < sharded["tp_modules"]
    assert sharded["losses"] == plain["losses"]
    assert torch.equal(sharded["grad"], plain["grad"]) and torch.equal(sharded["after"], plain["after"])
    assert "WORLD_SIZE" not in os.environ and not torch.distributed.is_initialized()


# ---- each rank reads only its own rows -------------------------------------

READ_SHAPES = [(8, 1, 1), (4, 2, 1), (2, 2, 2)]
READ_ITEMS, READ_BATCH = 21, 8  # two global batches and a tail of 5


def _reading(shape, index: int):
    """A fake mesh of ``shape`` at batch shard ``index`` (model index 0) and
    a counting dataset of `READ_ITEMS` rows."""
    coords = (index // shape[1], index % shape[1], 0)
    arrays = {"x": np.arange(READ_ITEMS * 3, dtype=np.float32).reshape(READ_ITEMS, 3),
              "y": np.arange(READ_ITEMS, dtype=np.int64)}
    return _fake_mesh(shape, coords), cases.CountingRows(arrays), arrays


@pytest.mark.parametrize("shape", READ_SHAPES)
def test_each_rank_reads_only_its_rows_of_the_distill_loader(shape):
    """`loader_route` (0 workers) on a mesh: each batch shard builds only
    the items of its `batch_rows` of each global batch of the seeded
    order, and its batches EQUAL the whole batches cut to its rows."""
    n = shape[0] * shape[1]
    for i in range(n):
        mesh, ds, arrays = _reading(shape, i)
        rows = pmesh.batch_rows(mesh, READ_BATCH)
        route = dloader.loader_route(ds, READ_BATCH, seed=3, workers=0, device="cpu", rows=rows)
        got = list(route.epoch(1))
        whole = list(dloader.make_loader(cases.CountingRows(arrays), READ_BATCH, seed=3, epoch=1))
        order = np.random.default_rng((3, 1)).permutation(READ_ITEMS)
        want = [int(j) for s in range(2) for j in order[s * READ_BATCH:(s + 1) * READ_BATCH][rows]]
        assert ds.read == want and ds.epoch == 1
        assert len(got) == len(whole) == route.steps == 2
        for g, w in zip(got, whole):
            for k in w:
                assert torch.equal(g[k], w[k][rows]), k


@pytest.mark.parametrize("shape", READ_SHAPES)
def test_each_rank_reads_only_its_rows_of_the_native_loader(shape):
    """`NativeDistillLoader` plans the items of its rows alone: each global
    batch of its order, cut to the rank's `batch_rows`."""
    class Items:  # what `_indices` reads of a dataset
        crop_size, epoch = 8, 0

        def __len__(self):
            return READ_ITEMS

    n = shape[0] * shape[1]
    order = np.random.default_rng((3, 0)).permutation(READ_ITEMS)
    for i in range(n):
        rows = pmesh.batch_rows(_reading(shape, i)[0], READ_BATCH)
        native = dloader.NativeDistillLoader(Items(), READ_BATCH, seed=3, num_threads=1, rows=rows)
        try:
            it = native._indices()
            for s in range(2):
                assert next(it).tolist() == order[s * READ_BATCH:(s + 1) * READ_BATCH][rows].tolist()
        finally:
            native.close()


@pytest.mark.parametrize("shape", READ_SHAPES)
def test_each_rank_reads_only_its_rows_of_the_detector_files(shape):
    """`detector/train.py::file_batches` on a mesh: the rank reads the items
    of its rows of each global batch alone; its batches EQUAL the whole
    batches cut to them."""
    n = shape[0] * shape[1]
    whole = list(dtrain.file_batches(cases.CountingRows(_reading(shape, 0)[2]), READ_BATCH,
                                     seed=5, epoch=2, steps=3))
    order = np.random.default_rng((5, 2)).permutation(READ_ITEMS)
    assert len(whole) == 2  # the tail of 5 is dropped
    for i in range(n):
        mesh, ds, _ = _reading(shape, i)
        rows = pmesh.batch_rows(mesh, READ_BATCH)
        got = list(dtrain.file_batches(ds, READ_BATCH, seed=5, epoch=2, steps=3, rows=rows))
        assert ds.read == [int(j) for s in range(2) for j in order[s * READ_BATCH:(s + 1) * READ_BATCH][rows]]
        assert ds.epoch == 2 and len(got) == 2
        for g, w in zip(got, whole):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k][rows])


@pytest.mark.parametrize("shape", READ_SHAPES)
def test_each_rank_reads_only_its_rows_of_the_evaluator(shape):
    """The evaluator's reader (`make_loader` with `batch_rows` of the mesh,
    `rank_batches`): each global batch that divides over the batch shards
    is read as the rank's rows, marked `RankRows`; the tail of 5, which
    does not divide, is read whole by every rank. Rows EQUAL the whole
    batch's."""
    n = shape[0] * shape[1]
    whole = list(dloader.make_loader(cases.CountingRows(_reading(shape, 0)[2]), READ_BATCH,
                                     shuffle=False, drop_last=False))
    for i in range(n):
        mesh, ds, _ = _reading(shape, i)
        reader = dloader.rank_batches(dloader.make_loader(
            ds, READ_BATCH, shuffle=False, drop_last=False, rows=partial(pmesh.batch_rows, mesh),
        ))
        got = list(reader)
        rows = pmesh.batch_rows(mesh, READ_BATCH)
        want = [j for s in range(2) for j in list(range(s * READ_BATCH, (s + 1) * READ_BATCH))[rows]]
        assert ds.read == want + [16, 17, 18, 19, 20]
        assert [isinstance(b, dloader.RankRows) for b in got] == [True, True, False]
        for g, w, r in zip(got, whole, (rows, rows, slice(None))):
            for k in w:
                assert torch.equal(g[k], w[k][r]), k
