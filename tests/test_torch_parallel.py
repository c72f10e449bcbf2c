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
  - the evaluator on (2, 2, 2) against the single-process evaluator;
  - `train.main` on (2, 2, 2) under the launcher's variables, its checkpoint
    resumed in this process;
  - FSDP2's share of the state on each rank, the EVA variants' tensor
    parallelism against the unsharded tower, and the kernel wrappers'
    refusal of a DTensor.

Tolerances, with their reasons: the mesh sums the same float32 products in
other groupings (row-parallel partial sums, per-rank box sums, FSDP2's
gradient average): losses rtol 1e-5 and block 1's w3 after two AdamW steps
atol 1e-5 (the bars of `tests/test_train_step.py`'s JAX mesh cases); the
RegionCLIP loss 1e-5 of its value (`tests/test_torch_regionclip.py`); the
local loss and its feature gradients 1e-6 (a [16, 16] logit matrix); the
evaluator's metrics, the checkpoint's tensors and the trainer's resumed
state are EQUAL (top-k decisions and copies); the trainer's losses on the
mesh against its single-process losses rtol 1e-5.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_cases as cases
from test_train_step import _batch
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.parallel.mesh import create_mesh as jax_create_mesh
from clipself_tpu.parallel.mesh import hybrid_shardings, shard_batch as jax_shard_batch
from clipself_tpu.train import contrastive as jcontrastive
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu.train import step as jstep
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
from clipself_tpu_torch.models.torch_io import state_dict_from_jax
from clipself_tpu_torch.parallel import mesh as pmesh
from clipself_tpu_torch.parallel import tensor_parallel as tpar
from clipself_tpu_torch.train import checkpoint as ckpt
from clipself_tpu_torch.train import main as train_main
from clipself_tpu_torch.train.optim import Optimizer, make_schedule
from clipself_tpu_torch.train.step import TrainState

WORLD = 8
LAYERS = get_model_config(cases.NAME).vision.layers
EMBED = get_model_config(cases.NAME).embed_dim
REGION_C, REGION_SAMPLE = 32, 10
LOSS_RTOL, W3_ATOL, REGION_REL, CLIP_TOL, TRAINER_RTOL = 1e-5, 1e-5, 1e-5, 1e-6, 1e-5


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
    payload = {
        "state_dict": state_dict_from_jax(params),
        "batch": batch,
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
    }
    group = cases.Group(WORLD, payload)

    # the JAX references, while the ranks run
    ref = {}
    sched = joptim.make_schedule("cosine", cases.LR, warmup=cases.WARMUP, total_steps=cases.TOTAL)

    def jax_run(mesh, shard):
        tx = joptim.build_optimizer(params, sched, wd=cases.WD, unlocked_groups=LAYERS, num_layers=LAYERS)
        state = jstep.TrainState.create(jax.tree.map(jnp.array, params), tx)
        teacher = jax.tree.map(jnp.array, params)
        state_sh = teacher_sh = None
        if shard:
            state_sh = hybrid_shardings(mesh, state, min_size=128)
            teacher_sh = hybrid_shardings(mesh, teacher, min_size=128)
            state = jax.tree.map(jax.device_put, state, state_sh)
            teacher = jax.tree.map(jax.device_put, teacher, teacher_sh)
        step = jstep.make_train_step(
            jmodel, tx, jmethods.clipself_loss, mesh=mesh,
            state_sharding=state_sh, teacher_sharding=teacher_sh,
        )
        jb = jax_shard_batch(mesh, batch) if mesh is not None else {k: jnp.asarray(v) for k, v in batch.items()}
        return step, state, teacher, jb

    step, state, teacher, jb = jax_run(None, False)
    ref["losses"] = []
    for _ in range(2):
        state, metrics = step(state, teacher, jb, jax.random.PRNGKey(0))
        ref["losses"].append(float(metrics["loss"]))
    ref["w3"] = np.asarray(state.params["visual"]["blocks_1"]["mlp"]["w3"]["kernel"]).T
    hy_mesh = jax_create_mesh(8, axis_names=("data", "fsdp", "model"), shape=(2, 2, 2))
    step, state, teacher, jb = jax_run(hy_mesh, True)
    ref["hybrid_loss"] = float(step(state, teacher, jb, jax.random.PRNGKey(0))[1]["loss"])

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
    ref["trainer"] = train_main.main(_trainer_argv(logs, "single", 2))
    ranks = group.results()
    return {"ranks": ranks, "ref": ref, "payload": payload, "logs": logs}


@pytest.mark.parametrize("mesh", list(cases.DISTILL_MESHES))
def test_distill_steps_on_a_mesh_match_the_jax_single_device_step(run, mesh):
    ref = run["ref"]
    got = run["ranks"][0][mesh]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][0], ref["hybrid_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["w3"], ref["w3"], rtol=0, atol=W3_ATOL)
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
