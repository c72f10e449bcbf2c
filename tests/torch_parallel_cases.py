"""The ranks of `tests/test_torch_parallel.py`: one gloo group of processes,
spawned once, runs every mesh case of the port on `EVA02-CLIP-Tiny-Test`
and hands the results back to the test process. This module imports
nothing of JAX: each spawned rank imports it (and the port) afresh."""

from __future__ import annotations

import copy
import io
import os
import socket
import time
import traceback
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

NAME = "EVA02-CLIP-Tiny-Test"
W3 = "visual.blocks.1.mlp.w3.weight"
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
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.queue = world, ctx.Queue()
        port = free_port()
        self.procs = [
            ctx.Process(target=_rank_main, args=(r, world, port, payload, self.queue, cases))
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
        return [torch.load(io.BytesIO(got[r]), weights_only=False) for r in range(self.world)]


def _rank_main(rank: int, world: int, port: int, payload: dict, queue, cases: str) -> None:
    torch.set_num_threads(1)
    try:
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


def run_cases(payload: dict) -> dict:
    """Every case, in the same order on every rank (their collectives pair up)."""
    out = {name: distill_case(payload, shape) for name, shape in DISTILL_MESHES.items()}
    out["region"] = region_case(payload)
    out["local_clip"] = local_clip_case(payload)
    out["eval"] = eval_case(payload)
    out["trainer"] = trainer_case(payload)
    out["dtensor"] = dtensor_case()
    out["variants"] = {name: variant_case(flags) for name, flags in VARIANTS.items()}
    return out


def _layout(payload, shape):
    """Student and frozen teacher laid out on a fresh mesh of ``shape``."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.parallel.mesh import create_mesh, shard_model
    from clipself_tpu_torch.train.optim import set_trainable

    cfg = get_model_config(NAME)
    layers = cfg.vision.layers
    mesh = create_mesh(shape, torch.device("cpu"))
    model = tiny_model(payload["state_dict"])
    teacher = copy.deepcopy(model).requires_grad_(False)
    set_trainable(model, layers, layers)
    shard_model(model, cfg, mesh)
    shard_model(teacher, cfg, mesh)
    return cfg, mesh, model, teacher


def _numel(tensors) -> int:
    from clipself_tpu_torch.parallel.mesh import local_tensor

    return sum(local_tensor(t).numel() for t in tensors)


def distill_case(payload: dict, shape) -> dict:
    """Two clipself steps on the mesh: the global losses, block 1's w3 after
    them, and this rank's share of the student, teacher and AdamW state."""
    from clipself_tpu_torch.parallel.mesh import full_leaf, shard_batch
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import Optimizer, make_schedule
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    cfg, mesh, model, teacher = _layout(payload, shape)
    layers = cfg.vision.layers
    opt = Optimizer(
        model, make_schedule("cosine", LR, WARMUP, TOTAL), wd=WD, unlocked_groups=layers,
        num_layers=layers, mesh=mesh,
    )
    state = TrainState(model, opt)
    step_fn = make_train_step(partial(clipself_loss, group=mesh.batch_group), teacher, mesh=mesh)
    batch = _tensors(shard_batch(mesh, payload["batch"]))
    losses = [float(step_fn(state, batch)["loss"]) for _ in range(2)]
    w3 = full_leaf(W3, dict(model.named_parameters())[W3], mesh)
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
    shard_model(model, cfg, mesh)
    shard_model(teacher, cfg, mesh)
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
    shard_model(sharded, cfg, mesh)
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
