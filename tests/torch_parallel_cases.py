"""The ranks of `tests/test_torch_parallel.py`: one gloo group of processes,
spawned once, runs every mesh case of the port on `EVA02-CLIP-Tiny-Test`
(the detector's on preset `tiny_test`; the tensor-parallel OpenCLIP ViT
and text towers on `ViT-Tiny-Test`, a replicated image tower on
`RN-Tiny-Test`, CoCa's decoder on the tiny CoCa of `torch_coca_cases.py`) and hands the results back to the test process; `pipeline_ring_cases` are the ranks of `tests/test_torch_pipeline_ring.py`. This module imports nothing of JAX: each spawned rank imports
it (and the port) afresh."""

from __future__ import annotations

import copy
import io
import os
import shutil
import socket
import time
import traceback
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

NAME = "EVA02-CLIP-Tiny-Test"
W3 = "visual.blocks.1.mlp.w3.weight"
VIT, RN = "ViT-Tiny-Test", "RN-Tiny-Test"
C_PROJ = "visual.transformer.resblocks.1.mlp.c_proj.weight"
# the payload's state dict and distill batch of each model
STATE = {NAME: "state_dict", VIT: "vit_state_dict", RN: "rn_state_dict"}
BATCH = {NAME: "batch", VIT: "batch", RN: "rn_batch"}
VIT_MESHES = {"vit_dp4_tp2": (4, 1, 2), "vit_dp2_fsdp2_tp2": (2, 2, 2)}
TP_MESH = (4, 1, 2)  # the sharded-against-unsharded cases and the ViT evaluator
DISTILL_MESHES = {"dp8": (8, 1, 1), "dp4_fsdp2": (4, 2, 1), "dp4_tp2": (4, 1, 2), "dp2_fsdp2_tp2": (2, 2, 2)}
REGION_MESH = (4, 1, 2)  # 4 batch shards, each a tensor-parallel pair
EVAL_MESH = (2, 2, 2)
LR, WARMUP, TOTAL, WD = 1e-3, 2, 20, 0.1  # tests/test_train_step.py's schedule and decay
# the EVA variants' flags (tests/test_torch_eva_variants.py) under tensor parallelism
VARIANTS = {
    "eva01_rel_pos": dict(subln=False, naiveswiglu=False, rope=False, use_rel_pos_bias=True),
    "bige_shared_rel_pos": dict(subln=False, naiveswiglu=False, rope=False, postnorm=True,
                                use_shared_rel_pos_bias=True),
}
VARIANT_LEAVES = ("visual.blocks.0.attn.qkv.weight", "visual.blocks.0.attn.q_bias",
                  "visual.blocks.1.mlp.fc2.weight", "visual.blocks.1.mlp.fc1.bias")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Group:
    """``world`` spawned gloo ranks running ``cases(payload)`` (a function of
    this module: `run_cases` by default); started at once, so the test
    process can work meanwhile, and read with `results`."""

    def __init__(self, world: int, payload: dict, cases: str = "run_cases"):
        import tempfile

        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.queue = world, ctx.Queue()
        port = free_port()
        # the payload goes by file: handed to `Process` it is written down
        # each rank's pipe, which holds `start` until that rank has booted
        self.dir = tempfile.mkdtemp(prefix="torch_parallel_")
        path = os.path.join(self.dir, "payload.pt")
        torch.save(payload, path)
        self.procs = [
            ctx.Process(target=_rank_main, args=(r, world, port, path, self.queue, cases))
            for r in range(world)
        ]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 240.0) -> list[dict]:
        """Each rank's results, rank order. A rank that failed raises here
        with its traceback, at once (its peers, waiting in a collective, are
        ended), as does a rank that died without a word. Every rank has
        exited when it returns."""
        import queue as queues

        got, deadline = {}, time.monotonic() + timeout
        try:
            while len(got) < self.world:
                try:
                    rank, value = self.queue.get(timeout=1.0)
                except queues.Empty:
                    dead = [r for r, p in enumerate(self.procs) if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with {self.procs[dead[0]].exitcode}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{self.world - len(got)} rank(s) gave no result in {timeout} s")
                    continue
                if isinstance(value, str):
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            for p in self.procs:
                p.join(timeout=30 if len(got) == self.world else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
            shutil.rmtree(self.dir, ignore_errors=True)
        return [torch.load(io.BytesIO(got[r]), weights_only=False) for r in range(self.world)]


def _rank_main(rank: int, world: int, port: int, path: str, queue, cases: str) -> None:
    torch.set_num_threads(1)
    try:
        payload = torch.load(path, weights_only=False)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world
        )
        os.environ.update(
            WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
            MASTER_ADDR="localhost", MASTER_PORT=str(port),
        )
        # as bytes: tensors sent as they are live in the rank's shared memory,
        # which is gone once the rank exits
        buf = io.BytesIO()
        torch.save(globals()[cases](payload), buf)
        queue.put((rank, buf.getvalue()))
    except Exception:  # handed to the test process, which raises it
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tiny_model(state_dict, name: str = NAME):
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.models.clip import CLIP
    from clipself_tpu_torch.models.torch_io import load_weights

    model = CLIP(get_model_config(name), torch.float32)
    load_weights(model, {k: v.clone() for k, v in state_dict.items()})
    return model


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


class CountingRows(torch.utils.data.Dataset):
    """The rows of ``arrays`` (a dict of arrays with one leading axis) as
    items; ``read`` lists the index of every item built, in order."""

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self.read = []
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, i):
        self.read.append(int(i))
        return {k: v[i] for k, v in self.arrays.items()}


def eval_rows(batches: list) -> dict:
    """The evaluator batches' arrays joined along the image axis."""
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def run_cases(payload: dict) -> dict:
    """Every case, in the same order on every rank (their collectives pair up)."""
    out = {name: distill_case(payload, shape) for name, shape in DISTILL_MESHES.items()}
    out["region"] = region_case(payload)
    out["local_clip"] = local_clip_case(payload)
    out["eval"] = eval_case(payload)
    out["eval_reader"] = eval_reader_case(payload)
    out["detector"] = detector_case(payload)
    out["trainer"] = trainer_case(payload)
    out["dtensor"] = dtensor_case()
    out["variants"] = {name: variant_case(flags) for name, flags in VARIANTS.items()}
    out.update({name: distill_case(payload, shape, VIT, C_PROJ) for name, shape in VIT_MESHES.items()})
    out["vit_tp"] = vit_tp_case(payload)
    out["rn_tp"] = rn_tp_case(payload)
    out["vit_eval"] = vit_eval_case(payload)
    out["coca_tp"] = coca_tp_case(payload)
    return out


def _layout(payload, shape, name: str = NAME):
    """Student and frozen teacher of model ``name`` laid out on a fresh mesh
    of ``shape``."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.parallel.mesh import create_mesh, shard_model
    from clipself_tpu_torch.train.optim import set_trainable

    cfg = get_model_config(name)
    layers = cfg.vision.layers
    mesh = create_mesh(shape, torch.device("cpu"))
    model = tiny_model(payload[STATE[name]], name)
    teacher = copy.deepcopy(model).requires_grad_(False)
    set_trainable(model, layers, layers)
    shard_model(model, mesh)
    shard_model(teacher, mesh)
    return cfg, mesh, model, teacher


def _numel(tensors) -> int:
    from clipself_tpu_torch.parallel.mesh import local_tensor

    return sum(local_tensor(t).numel() for t in tensors)


def distill_case(payload: dict, shape, name: str = NAME, weight: str = W3) -> dict:
    """Two clipself steps of model ``name`` on the mesh: the global losses,
    ``weight`` (block 1's down projection) after them, and this rank's share
    of the student, teacher and AdamW state."""
    from clipself_tpu_torch.parallel.mesh import full_leaf, shard_batch
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import Optimizer, make_schedule
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    cfg, mesh, model, teacher = _layout(payload, shape, name)
    layers = cfg.vision.layers
    opt = Optimizer(
        model, make_schedule("cosine", LR, WARMUP, TOTAL), wd=WD, unlocked_groups=layers,
        num_layers=layers, mesh=mesh,
    )
    state = TrainState(model, opt)
    step_fn = make_train_step(partial(clipself_loss, group=mesh.batch_group), teacher, mesh=mesh)
    batch = _tensors(shard_batch(mesh, payload[BATCH[name]]))
    losses = [float(step_fn(state, batch)["loss"]) for _ in range(2)]
    w3 = full_leaf(weight, dict(model.named_parameters())[weight], mesh)
    opt_state = [t for s in opt.opt.state.values() for t in s.values() if torch.is_tensor(t) and t.dim()]
    return {
        "losses": losses,
        "w3": w3.numpy(),
        "student_numel": _numel(model.parameters()),
        "teacher_numel": _numel(teacher.parameters()),
        "adam_numel": _numel(opt_state),
        "plan": sorted(mesh.plan),
    }


def region_case(payload: dict) -> dict:
    """The RegionCLIP loss of a global batch whose ranks hold different
    numbers of valid boxes and different classes."""
    from clipself_tpu_torch.parallel.mesh import reduce_sum, shard_batch
    from clipself_tpu_torch.train.methods import regionclip_loss

    _, mesh, model, _ = _layout(payload, REGION_MESH)
    batch = _tensors(shard_batch(mesh, payload["region_batch"]))
    loss, metrics = regionclip_loss(
        model, None, batch, noun_embeddings=torch.from_numpy(payload["nouns"]),
        noise=torch.from_numpy(payload["region_noise"]), num_sample_cats=payload["region_sample"],
        group=mesh.batch_group,
    )
    return {
        "loss": float(reduce_sum(loss.detach(), mesh.batch_group)),
        "boxes": float(metrics["num_boxes"]),
        "classes": sorted(set(batch["boxes"][..., 4][batch["boxes"][..., 5] > 0.5].tolist())),
    }


def local_clip_case(payload: dict) -> dict:
    """`local_clip_loss` over the whole group: the loss and the gradients of
    this rank's image and text rows."""
    from clipself_tpu_torch.train.contrastive import local_clip_loss

    n = dist.get_world_size()
    rank = dist.get_rank()
    img, txt = (torch.from_numpy(payload[k]) for k in ("clip_image", "clip_text"))
    per = img.shape[0] // n
    rows = slice(rank * per, (rank + 1) * per)
    img, txt = img[rows].clone().requires_grad_(True), txt[rows].clone().requires_grad_(True)
    loss = local_clip_loss(img, txt, torch.tensor(payload["clip_scale"]))
    loss.backward()
    return {"loss": loss.item(), "d_image": img.grad.numpy(), "d_text": txt.grad.numpy()}


def eval_case(payload: dict) -> dict:
    """The zero-shot evaluator on the (2, 2, 2) mesh."""
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot

    _, mesh, model, _ = _layout(payload, EVAL_MESH)
    return evaluate_zero_shot(
        model, payload["eval_batches"], payload["eval_embeddings"], device="cpu",
        ann_bucket=payload["eval_bucket"], mesh=mesh,
    )


def eval_reader_case(payload: dict) -> dict:
    """The evaluator on the (2, 2, 2) mesh fed by the trainer's reader: each
    rank reads only its rows of a batch that divides over the 4 batch
    shards, the whole tail of 3 otherwise; the metrics and the items read."""
    from functools import partial

    from clipself_tpu_torch.data.loader import make_loader, rank_batches
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.parallel.mesh import batch_rows

    _, mesh, model, _ = _layout(payload, EVAL_MESH)
    ds = CountingRows(eval_rows(payload["eval_batches"]))
    batch = len(payload["eval_batches"][0]["boxes"])
    reader = rank_batches(make_loader(
        ds, batch, shuffle=False, drop_last=False, rows=partial(batch_rows, mesh),
    ))
    metrics = evaluate_zero_shot(
        model, reader, payload["eval_embeddings"], device="cpu", ann_bucket=payload["eval_bucket"],
        mesh=mesh,
    )
    return {"metrics": metrics, "read": ds.read, "batch_index": mesh.batch_index}


def detector_case(payload: dict) -> dict:
    """One F-ViT train step of preset `tiny_test` on an 8-rank `data` mesh
    (`detector/train.py::make_det_train_step` under `data_parallel`), with
    the global batch's sampler noise given in place of the generator's
    draws: the global metrics and (rank 0) the heads after the step. Then
    `detector.train.main` under the launcher's variables, each rank with an
    output directory of its own: its logged metrics and its files."""
    from clipself_tpu_torch.detector import config, fvit, targets, train
    from clipself_tpu_torch.parallel.mesh import batch_rows, create_mesh

    cfg = config.PRESETS["tiny_test"]
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = create_mesh((world, 1, 1), torch.device("cpu"))
    clip = tiny_model(payload["det_clip"], cfg.clip_model).requires_grad_(False)
    det = fvit.FViTDetector(cfg)
    det.load_state_dict({k: v.clone() for k, v in payload["det_heads"].items()}, strict=True)
    state = train.DetTrainState(det, train.build_det_optimizer(det), data_parallel=train.data_parallel(det, mesh))
    noise = targets.SampleNoise(**{k: torch.from_numpy(v) for k, v in payload["det_noise"].items()})
    batch = payload["det_batch"]
    size = len(batch["images"])

    def given(generator, b, anchors, rois):
        assert (b, anchors, rois) == tuple(noise.rpn_pos.shape) + (noise.roi_pos.shape[1],)
        return noise

    drawn, train.draw_noise = train.draw_noise, given
    try:
        step = train.make_det_train_step(
            clip, cfg, torch.from_numpy(payload["det_ce"]), torch.from_numpy(payload["det_cw"]),
            torch.Generator(), mesh,
        )
        rows = batch_rows(mesh, size)
        metrics = step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()})
    finally:
        train.draw_noise = drawn
    out_dir = os.path.join(payload["det_out"], f"rank{rank}")
    run = train.main(payload["det_argv"] + ["--output", out_dir])
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "heads": {k: v.clone() for k, v in det.state_dict().items()} if rank == 0 else None,
        "main": [h["metrics"] for h in run["history"]],
        "mesh": run["mesh"],
        "files": sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else [],
    }


def trainer_case(payload: dict) -> dict:
    """`train.main` under the launcher's variables on a (2, 2, 2) mesh: one
    epoch, saved, then a second one resumed from that checkpoint (each rank
    takes its shards of it); rank 0 returns both runs' logged steps and the
    gathered model and optimizer state the second ended with."""
    from clipself_tpu_torch.parallel.mesh import full_optimizer_state, full_state_dict
    from clipself_tpu_torch.train import main as train_main

    first = train_main.main(payload["trainer_argv"])
    run = train_main.main(payload["trainer_resume_argv"])
    state, mesh = run["state"], run["mesh"]
    model = full_state_dict(state.model, mesh)
    opt = full_optimizer_state(state.optimizer, mesh)
    if dist.get_rank():
        return {}
    return {"history": first["history"] + run["history"], "model": model, "opt": opt,
            "step": state.step, "shape": mesh.shape}


def dtensor_case() -> dict:
    """What each kernel wrapper says when it is handed a DTensor."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from clipself_tpu_torch.ops import attention, layer_norm, nms, rope_roll

    mesh = init_device_mesh("cpu", (dist.get_world_size(),))

    def dt(*shape):
        return distribute_tensor(torch.ones(shape), mesh, [Replicate()])

    x, w = dt(2, 5, 8), torch.ones(8)
    q = dt(1, 5, 2, 8)
    calls = {
        "layer_norm": lambda: layer_norm.layer_norm_fwd(x, w, w, 1e-6),
        "layer_norm_bwd": lambda: layer_norm.layer_norm_bwd(x, x, x[..., 0], x[..., 0], w),
        "flash_attention": lambda: attention.flash_attention_fwd(q, q, q, 0.5),
        "flash_attention_bwd": lambda: attention.flash_attention_bwd(q, q, q, q, q[..., 0], q, 0.5),
        "rolled_rope": lambda: rope_roll.rolled_rope_packed((x,), torch.ones(5, 4, 4)),
        "nms_keep_mask": lambda: nms.nms_keep_mask(dt(3, 4), torch.ones(3, dtype=torch.bool), 0.5),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


def dryrun_case(payload: dict) -> dict:
    """`__graft_entry__.py::dryrun_multichip(8, full)` in the port: one
    clipself step of ``payload["model"]`` on a (2, 2, 2) mesh, its schedule
    and decay, every block unlocked; the global loss and the step's seconds."""
    import time

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.parallel.mesh import create_mesh, shard_batch, shard_model
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import Optimizer, make_schedule, set_trainable
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    cfg = get_model_config(payload["model"])
    layers = cfg.vision.layers
    mesh = create_mesh((2, 2, 2), torch.device("cpu"))
    model = tiny_model(payload["state_dict"], payload["model"])
    teacher = copy.deepcopy(model).requires_grad_(False)
    set_trainable(model, layers, layers)
    shard_model(model, mesh)
    shard_model(teacher, mesh)
    opt = Optimizer(model, make_schedule("cosine", 1e-5, 2, 10), wd=0.1, unlocked_groups=layers,
                    num_layers=layers, mesh=mesh)
    step = make_train_step(partial(clipself_loss, group=mesh.batch_group), teacher, mesh=mesh)
    batch = _tensors(shard_batch(mesh, payload["batch"]))
    t0 = time.perf_counter()
    loss = float(step(TrainState(model, opt), batch)["loss"])
    return {"loss": loss, "seconds": time.perf_counter() - t0}


def variant_case(flags: dict) -> dict:
    """An EVA variant (fused `qkv`, GELU MLP, post-norm, rel-pos tables drawn
    from a seed) laid out on (4, 1, 2) against the same model unsharded, on
    the same rank: the image embedding, the dense map and the gradients of
    the sharded leaves (gathered whole) of one backward."""
    import dataclasses

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.parallel.mesh import create_mesh, full_leaf, shard_model

    cfg = get_model_config(NAME)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **flags))
    model = create_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn((2, 32, 32, 3), generator=gen)
    sharded = copy.deepcopy(model)
    mesh = create_mesh((4, 1, 2), torch.device("cpu"))
    shard_model(sharded, mesh)
    out = {}
    for tag, m in (("plain", model), ("sharded", sharded)):
        img, dense = m.encode_image(x), m.encode_dense(x)
        (img.square().sum() + dense.square().sum()).backward()
        named = dict(m.named_parameters())
        leaves = list(VARIANT_LEAVES) + [n for n in named if n.endswith("relative_position_bias_table")]
        grads = {n: named[n].grad if tag == "plain" else full_leaf(n, named[n].grad, mesh) for n in leaves}
        out[tag] = {"image": img.detach().numpy(), "dense": dense.detach().numpy(),
                    "grads": {n: g.numpy() for n, g in grads.items()}}
    out["plan"] = sorted(mesh.plan)
    return out


def _encodings(model, x, boxes, text) -> dict:
    """The image embedding, the dense map (v2), the v1 RoI features and the
    text embedding of ``model``, and one backward of their squares' sum (the
    text last: FSDP2 takes its root from the first forward)."""
    out = {
        "image": model.encode_image(x),
        "dense": model.encode_dense(x, keep_shape=True),
        "v1": model.encode_pseudo_boxes(x, boxes, extract_type="v1"),
        "text": model.encode_text(text),
    }
    sum(t.square().sum() for t in out.values()).backward()
    return {k: t.detach().numpy() for k, t in out.items()}


def vit_tp_case(payload: dict) -> dict:
    """`ViT-Tiny-Test` laid out on (4, 1, 2) against the same model unsharded
    on the same rank: its full state dict against the unsharded one and
    after a round trip through `load_full_state_dict`; the image embedding,
    the dense map, the v1 RoI features, the text embedding and the
    gradients of every sharded leaf (gathered whole) of one backward."""
    from clipself_tpu_torch.parallel.mesh import create_mesh, full_leaf, full_state_dict, load_full_state_dict, shard_model

    model = tiny_model(payload["vit_state_dict"], VIT)
    sharded = copy.deepcopy(model)
    mesh = create_mesh(TP_MESH, torch.device("cpu"))
    shard_model(sharded, mesh)
    want = model.state_dict()

    def equal(state):
        return state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want)

    state = full_state_dict(sharded, mesh)
    saved = equal(state)
    load_full_state_dict(sharded, state, mesh)
    out = {"plan": sorted(mesh.plan), "state_equal": saved, "round_trip_equal": equal(full_state_dict(sharded, mesh))}
    x = torch.from_numpy(payload["batch"]["images"][:2])
    boxes = torch.from_numpy(payload["batch"]["boxes"][:2, :, :4])
    text = torch.from_numpy(payload["tp_text"])
    for tag, m in (("plain", model), ("sharded", sharded)):
        got = _encodings(m, x, boxes, text)
        named = dict(m.named_parameters())
        got["grads"] = {
            n: (named[n].grad if tag == "plain" else full_leaf(n, named[n].grad, mesh)).numpy()
            for n in mesh.plan
        }
        out[tag] = got
    return out


def rn_tp_case(payload: dict) -> dict:
    """`RN-Tiny-Test` on (4, 1, 2), its ResNet replicated over `model` and its
    text tower sharded: two clipself steps against the same two steps in one
    process on this rank (the whole batch, no mesh), and the text
    embedding against the unsharded tower's (after the steps: FSDP2 takes
    its root from the first forward)."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.parallel.mesh import shard_batch
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import Optimizer, make_schedule, set_trainable
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    layers = get_model_config(RN).vision.layers
    text = torch.from_numpy(payload["tp_text"])
    out = {}
    for tag in ("plain", "sharded"):
        if tag == "sharded":
            _, mesh, model, teacher = _layout(payload, TP_MESH, RN)
            batch = _tensors(shard_batch(mesh, payload["rn_batch"]))
            out["plan"] = sorted(mesh.plan)
        else:
            mesh, model = None, tiny_model(payload["rn_state_dict"], RN)
            teacher = copy.deepcopy(model).requires_grad_(False)
            set_trainable(model, layers, layers)
            batch = _tensors(payload["rn_batch"])
        opt = Optimizer(model, make_schedule("cosine", LR, WARMUP, TOTAL), wd=WD, unlocked_groups=layers,
                        num_layers=layers, mesh=mesh)
        group = None if mesh is None else mesh.batch_group
        step_fn = make_train_step(partial(clipself_loss, group=group), teacher, mesh=mesh)
        out[tag] = [float(step_fn(TrainState(model, opt), batch)["loss"]) for _ in range(2)]
        with torch.no_grad():  # the text tower is frozen: after the steps as before
            out[f"{tag}_text"] = model.encode_text(text).numpy()
    return out


def vit_eval_case(payload: dict) -> dict:
    """The zero-shot evaluator of `ViT-Tiny-Test` at extract type v1 on a
    (4, 1, 2) mesh."""
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.parallel.mesh import create_mesh, shard_model

    mesh = create_mesh(TP_MESH, torch.device("cpu"))
    model = tiny_model(payload["vit_state_dict"], VIT).requires_grad_(False)
    shard_model(model, mesh)
    return evaluate_zero_shot(
        model, payload["eval_batches"], payload["eval_embeddings"], device="cpu",
        ann_bucket=payload["eval_bucket"], extract_type="v1", mesh=mesh,
    )


def coca_tp_case(payload: dict) -> dict:
    """The tiny CoCa of `torch_coca_cases.py` ("vit": the OpenCLIP ViT with
    the attentional pooler, the `embed_cls` text tower, a 2-layer decoder)
    laid out on (4, 1, 2) against the same model unsharded on the same rank:
    the forward's image and text features and caption logits, `coca_loss`,
    and the gradients of every sharded leaf (gathered whole) of one backward
    of that loss."""
    from clipself_tpu_torch.models.coca import CoCa, coca_loss
    from clipself_tpu_torch.parallel.mesh import create_mesh, full_leaf, shard_model

    model = CoCa(payload["coca_cfg"], torch.float32)
    model.load_state_dict({k: v.clone() for k, v in payload["coca_state_dict"].items()})
    sharded = copy.deepcopy(model)
    mesh = create_mesh(TP_MESH, torch.device("cpu"))
    shard_model(sharded, mesh)
    img = torch.from_numpy(payload["coca_image"])
    txt = torch.from_numpy(payload["coca_text"]).long()
    out = {"plan": sorted(mesh.plan)}
    for tag, m in (("plain", model), ("sharded", sharded)):
        fwd = m(img, txt)
        loss, _ = coca_loss(fwd, txt)
        loss.backward()
        named = dict(m.named_parameters())
        got = {k: fwd[k].detach().numpy() for k in ("image_features", "text_features", "logits")}
        got["loss"] = loss.item()
        got["grads"] = {
            n: (named[n].grad if tag == "plain" else full_leaf(n, named[n].grad, mesh)).numpy()
            for n in mesh.plan
        }
        out[tag] = got
    return out


# the pipeline and ring cases of tests/test_torch_pipeline_ring.py: (stages,
# microbatches) of the toy pipelines, the stages of the gradient and EVA
# cases, the ring sizes, and the (data, sp) mesh of the ring beside a data axis
PIPELINES, GRAD_STAGES, EVA_STAGES = ((2, 4), (4, 8), (8, 8)), 4, 2
RINGS, GRAD_RING, DATA_SP = (2, 4, 8), 4, (2, 4)


def consecutive_groups(sizes) -> dict:
    """For each size, the world cut into groups of that many consecutive
    ranks: this rank's group (every rank creates every group, in order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    mine = {}
    for size in sizes:
        for first in range(0, world, size):
            g = dist.new_group(list(range(first, first + size)))
            if first <= rank < first + size:
                mine[size] = g
    return mine


def toy_block(blk, x):
    """`tests/test_pipeline.py::_apply_toy`."""
    return torch.tanh(x @ blk["w"] + blk["b"])


def _grads(leaves: dict) -> dict:
    return {k: None if t.grad is None else t.grad.numpy() for k, t in leaves.items()}


def pipeline_ring_cases(payload: dict) -> dict:
    """Every pipeline and ring case, in the same order on every rank: the
    toy pipelines, their gradients (every stage trainable, then stage 0
    frozen with an input that needs no gradient), the tiny EVA tower's
    blocks with their gradients against the same blocks in turn on this
    rank, the rings and their gradients, the ring beside a data axis, the
    shape errors and one `ppermute` of the rank's index."""
    from torch.func import functional_call

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.models.eva_vit import EvaBlock
    from clipself_tpu_torch.ops.ring_attention import ring_attention, sequence_shard
    from clipself_tpu_torch.parallel.mesh import ppermute
    from clipself_tpu_torch.parallel.pipeline import pipeline_apply, stack_block_params, stage_params

    rank = dist.get_rank()
    groups = consecutive_groups(sorted({s for s, _ in PIPELINES} | {EVA_STAGES, GRAD_STAGES, *RINGS}))
    t = {k: torch.from_numpy(v) for k, v in payload["toy"].items()}
    toy, _ = stack_block_params(t)
    out = {"pipeline": {}}
    with torch.no_grad():
        for stages, mb in PIPELINES:
            st = stage_params(toy, groups[stages])
            out["pipeline"][stages, mb] = pipeline_apply(
                st, toy_block, torch.from_numpy(payload["pipe_x"]), mb, groups[stages]).numpy()

    def toy_grads(frozen_first: bool) -> dict:
        g = groups[GRAD_STAGES]
        frozen = frozen_first and dist.get_rank(g) == 0
        st = {k: v.clone().requires_grad_(not frozen) for k, v in stage_params(toy, g).items()}
        x = torch.from_numpy(payload["grad_x"]).requires_grad_(not frozen_first)
        (pipeline_apply(st, toy_block, x, GRAD_STAGES, g) ** 2).sum().backward()
        return {"grads": _grads(st), "x": None if x.grad is None else x.grad.numpy()}

    out["toy_grads"], out["frozen_first_grads"] = toy_grads(False), toy_grads(True)

    cfg = get_model_config(NAME).vision
    block = EvaBlock(cfg)
    grid = (cfg.grid_size, cfg.grid_size)

    def eva_block(blk, x):
        return functional_call(block, blk, (x, grid))

    eva, _ = stack_block_params({k: v.clone() for k, v in payload["state_dict"].items()}, "visual.blocks.")
    g = groups[EVA_STAGES]
    tokens = torch.from_numpy(payload["tokens"])
    with torch.no_grad():
        out["eva"] = pipeline_apply(stage_params(eva, g), eva_block, tokens, EVA_STAGES, g).numpy()
    st = {k: v.clone().requires_grad_() for k, v in stage_params(eva, g).items()}
    (pipeline_apply(st, eva_block, tokens, EVA_STAGES, g) ** 2).sum().backward()
    whole = {k: v.clone().requires_grad_() for k, v in eva.items()}
    h = tokens
    for i in range(next(iter(eva.values())).shape[0]):
        h = eva_block({k: v[i] for k, v in whole.items()}, h)
    (h ** 2).sum().backward()
    per, s = next(iter(st.values())).shape[0], dist.get_rank(g)
    out["eva_grads"] = {k: (st[k].grad.numpy(), whole[k].grad[s * per:(s + 1) * per].numpy()) for k in st}

    q, k, v = (torch.from_numpy(payload["ring_qkv"][n]) for n in "qkv")
    scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        out["ring"] = {
            size: ring_attention(*(sequence_shard(x, groups[size]) for x in (q, k, v)), scale, groups[size]).numpy()
            for size in RINGS
        }
    g = groups[GRAD_RING]
    shards = [sequence_shard(torch.from_numpy(payload["ring_grad_qkv"][n]), g).clone().requires_grad_()
              for n in "qkv"]
    (ring_attention(*shards, scale, g) ** 2).sum().backward()
    out["ring_grads"] = [x.grad.numpy() for x in shards]
    data, sp = DATA_SP
    rows = len(payload["ring_data_qkv"]["q"]) // data
    d = rank // sp
    with torch.no_grad():
        local = [sequence_shard(torch.from_numpy(payload["ring_data_qkv"][n][d * rows:(d + 1) * rows]), groups[sp])
                 for n in "qkv"]
        out["ring_data"] = ring_attention(*local, scale, groups[sp]).numpy()

    errors = {}
    for name, call in (
        ("blocks", lambda: stage_params({"w": torch.zeros(6, 2)}, groups[4])),
        ("batch", lambda: pipeline_apply(stage_params(toy, groups[2]), toy_block, torch.zeros(16, 16), 3,
                                         groups[2])),
        ("sequence", lambda: sequence_shard(torch.zeros(1, 63, 1, 1), groups[2])),
    ):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    x = torch.full((3,), float(rank), requires_grad=True)
    y = ppermute(x, None)
    (y * (rank + 1)).sum().backward()
    out["ppermute"] = (y.detach().numpy(), x.grad.numpy())
    return out
