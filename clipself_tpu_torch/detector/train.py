"""F-ViT detector training (a port of `clipself_tpu/detector/train.py`:
mmdet `F-ViT/train.py` + `dist_train.sh`).

    python -m clipself_tpu_torch.detector.train --ann-file <json> --image-root <dir>
    python -m clipself_tpu_torch.detector.train --synthetic --steps-per-epoch 10
    torchrun --nproc-per-node 8 -m clipself_tpu_torch.detector.train --batch-size 64 ...

Recipe (`configs/ov_coco/...eva_original.py:213-224`): AdamW lr 1e-4, betas
(0.9, 0.999), wd 0.1 on every parameter, gradient clip 1.0, linear warm-up
over 250 updates from a ratio of 1e-3, 3 epochs, batch 8 a device. The step
runs eagerly: the frozen CLIP trunk's taps without gradients, the detection
loss and its backward into the heads, the global gradient norm (before
clipping), clipping, the AdamW update. The samplers' noise is drawn from a
`torch.Generator` on the step's device, seeded from ``--seed``.

Batches come from a COCO- or LVIS-format annotation file through
`DetectionDataset` (``--ann-file``, ``--image-root``), in the JAX trainer's
order: each epoch a `default_rng((seed, epoch))` permutation of the images,
the ragged tail dropped, the items read in this process as the JAX trainer
reads them; or, with ``--synthetic``, seeded `SyntheticDetectionData`
batches. ``--clip-checkpoint`` loads a distilled CLIP `.pt` non-strictly, as
the JAX package's `create_model(pretrained=)` does. ``--device`` defaults to
`cuda`; without a CUDA device that is an error, not a CPU run.

Under a launcher (`torchrun`, SLURM, OpenMPI: `parallel/mesh.py::
init_distributed`) the trainer runs on a 1-D `data` mesh over every rank,
with no flag, as the JAX trainer runs over every device it sees; without
one it is one process. ``--batch-size`` is the global batch, as in JAX, and
must divide over the ranks (`check_batch`). Each rank reads only the items
of its rows of each global batch (`file_batches`; the synthetic route cuts
its rows of each drawn batch), runs the frozen trunk, replicated, and the
NMS kernel on them, and computes its share of the global batch's loss: the
counts that the losses divide by are summed over the group first
(`FViTDetector.loss(group=)`), as XLA computes the loss of a sharded batch.
The heads are replicated and `DistributedDataParallel` averages their
gradients over the group (`data_parallel`); each rank backpropagates its
share times the number of ranks, so the update follows the global loss's
gradient, and clipping by the global norm and AdamW then run alike on every
rank. DDP rather than FSDP2's replicate dimension: the heads are small
enough to hold whole on every rank, their parameters stay plain tensors
(the optimizer, the clipping and the JAX-format checkpoint writer run as in
one process), and DDP reduces the learned temperature, a scalar parameter
that FSDP2 does not take. The samplers' noise is drawn for the global batch
from the one seeded generator on every rank and cut to the rank's rows, so
a mesh run equals the single-process run. The logged metrics are the global
batch's; rank 0 alone logs them and writes the checkpoints. Buffer donation
and the TPU compiler options of the JAX step are not carried (ROADMAP.md
queue 1 item 10).
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from clipself_tpu_torch.detector.classes import class_weights, coco_split, lvis_split
from clipself_tpu_torch.detector.config import PRESETS, FViTConfig
from clipself_tpu_torch.detector.data import DetectionDataset, SyntheticDetectionData, collate
from clipself_tpu_torch.detector.fvit import FViTDetector, backbone_taps, create_detector
from clipself_tpu_torch.detector.rpn import num_anchors
from clipself_tpu_torch.detector.targets import SampleNoise, draw_noise
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.torch_io import _flatten, detector_state_dict_to_jax, load_pretrained
from clipself_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    check_batch,
    create_mesh,
    init_distributed,
    num_batch_shards,
    reduce_sum,
)
from clipself_tpu_torch.train.main import _device
from clipself_tpu_torch.train.optim import clip_by_global_norm

log = logging.getLogger("fvit")


def det_lr_schedule(
    base_lr: float, warmup: int = 250, warmup_ratio: float = 1e-3
) -> Callable[[int], float]:
    """mmdet 'step' policy with linear warm-up; the shipped step epoch (100)
    is beyond max_epochs, so the post-warm-up lr is constant. Evaluated at
    the update count (0 for the first update) in float32, as the JAX
    schedule is."""
    f32 = np.float32

    def lr(step: int) -> float:
        frac = np.clip(f32(step) / f32(max(warmup, 1)), f32(0.0), f32(1.0))
        return float(f32(base_lr) * (f32(warmup_ratio) + f32(1.0 - warmup_ratio) * frac))

    return lr


class DetOptimizer:
    """AdamW on every parameter it is given, biases, norm scales and the
    learned temperature included (the reference config has no
    paramwise_cfg): the optax chain clip_by_global_norm -> scale_by_adam ->
    add_decayed_weights -> scale_by_learning_rate, with the learning rate of
    update ``count`` from the schedule. `torch.optim.AdamW`'s decoupled decay
    p (1 - lr wd) - lr u is that chain's p - lr (u + wd p)."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        schedule: Callable[[int], float],
        *,
        wd: float = 0.1,
        grad_clip: float = 1.0,
    ):
        self.params = list(params)
        # gradients stay allocated and are zeroed, never None: a parameter
        # outside the loss's graph (the mask head without gt masks) still
        # gets its weight decay, as optax applies it to a zero gradient
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.opt = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=wd
        )

    def step(self, count: int) -> torch.Tensor:
        """Clip, apply update number ``count`` (0-based) and clear the
        gradients. Returns the global gradient norm before clipping."""
        norm = clip_by_global_norm(self.params, self.grad_clip)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(count)
        self.opt.step()
        self.opt.zero_grad(set_to_none=False)
        return norm


def build_det_optimizer(
    det: FViTDetector, base_lr: float = 1e-4, wd: float = 0.1, grad_clip: float = 1.0
) -> DetOptimizer:
    return DetOptimizer(
        det.parameters(), det_lr_schedule(base_lr), wd=wd, grad_clip=grad_clip
    )


class _DetectorLoss(nn.Module):
    """`FViTDetector.loss` as a module's forward: `DistributedDataParallel`
    reduces the gradients of what runs through its wrapper's forward."""

    def __init__(self, det: FViTDetector):
        super().__init__()
        self.det = det

    def forward(self, *args, **kwargs):
        return self.det.loss(*args, **kwargs)


def data_parallel(det: FViTDetector, mesh: Mesh) -> nn.Module:
    """``det``'s loss under `DistributedDataParallel` over the mesh's batch
    group: called as `FViTDetector.loss`, its backward averages the heads'
    gradients over the group. ``det`` keeps its own parameters and names.
    The mask head takes no gradient in a step whose batch has no gt masks,
    so with it the wrapper looks for parameters left out of the graph."""
    from torch.nn.parallel import DistributedDataParallel

    return DistributedDataParallel(
        _DetectorLoss(det), device_ids=None, process_group=mesh.batch_group,
        find_unused_parameters=det.cfg.with_mask,
    )


@dataclass
class DetTrainState:
    model: FViTDetector
    optimizer: DetOptimizer
    step: int = 0
    # on a data mesh: the model's loss under `data_parallel`
    data_parallel: Optional[nn.Module] = None


def make_det_train_step(
    clip_model,
    cfg: FViTConfig,
    class_embed: torch.Tensor,
    class_weight: Optional[torch.Tensor],
    generator: torch.Generator,
    mesh: Optional[Mesh] = None,
) -> Callable[[DetTrainState, dict], dict]:
    """Build ``step_fn(state, batch) -> metrics`` for batches of device
    tensors (`images`, `gt_boxes`, `gt_labels`, `gt_valid`, optional
    `gt_masks`, `valid_hw`). The metrics are device tensors; reading one
    waits for the step. ``generator`` (on the step's device) draws each
    step's sampler noise. With ``mesh`` (a `data` mesh; ``state`` carries
    `data_parallel`), ``batch`` holds this rank's rows of the global batch,
    the noise is the global batch's cut to those rows, and the metrics are
    the global batch's on every rank."""
    anchors = num_anchors(cfg)
    shards = num_batch_shards(mesh)
    group = None if mesh is None else mesh.batch_group

    def step_fn(state: DetTrainState, batch: dict) -> dict:
        taps, _ = backbone_taps(clip_model, batch["images"], cfg, False)
        b, g = batch["gt_boxes"].shape[:2]
        noise = draw_noise(generator, b * shards, anchors, cfg.train_proposals.max_per_img + g)
        if mesh is not None:
            rows = batch_rows(mesh, b * shards)
            noise = SampleNoise(*(t[rows] for t in noise))
        loss_fn = state.model.loss if mesh is None else state.data_parallel
        loss, metrics = loss_fn(
            taps, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"], noise, class_embed,
            class_weight, batch.get("gt_masks"), batch.get("valid_hw"), group=group,
        )
        # this rank's share of the global loss; DDP averages the gradients
        (loss if shards == 1 else loss * shards).backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            keys = list(metrics)  # the loss builds them in one order on every rank
            total = reduce_sum(torch.stack([metrics[k].float() for k in keys]), group)
            metrics = dict(zip(keys, total.unbind()))
        metrics["grad_norm"] = state.optimizer.step(state.step)
        state.step += 1
        return metrics

    return step_fn


def file_batches(
    ds: DetectionDataset, batch_size: int, *, seed: int, epoch: int, steps: int,
    rows: slice = slice(None),
) -> Iterable[dict]:
    """One epoch of host batches from ``ds`` in the JAX trainer's order: a
    `default_rng((seed, epoch))` permutation of the images cut into
    ``steps`` global batches of ``batch_size`` (a ragged tail dropped), each
    collated from its ``rows`` alone (this rank's of a mesh): only their
    items are read."""
    ds.set_epoch(epoch)
    order = np.random.default_rng((seed, epoch)).permutation(len(ds))
    for i in range(steps):
        idx = order[i * batch_size : (i + 1) * batch_size]
        if len(idx) < batch_size:
            return
        yield collate([ds[int(j)] for j in idx[rows]])


def parse_args(argv=None):
    p = argparse.ArgumentParser("fvit-train")
    p.add_argument("--preset", default="ov_coco_vitb16", choices=sorted(PRESETS))
    p.add_argument("--dataset", default=None, choices=["coco", "lvis"],
                   help="class-split registry; inferred from --preset when omitted")
    p.add_argument("--ann-file", default=None)
    p.add_argument("--image-root", default=None)
    p.add_argument("--class-embed", default=None, help=".npy [K+1, D] text embeddings")
    p.add_argument("--clip-checkpoint", default=None, help="distilled CLIP .pt / .npz")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ratio-range", type=float, nargs=2, default=(0.1, 2.0),
                   help="train-time random resize ratio range (mmdet Resize)")
    p.add_argument("--output", default="out_fvit")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train on parsed ``argv``. Returns {"state", "history", "clip",
    "mesh"} (``clip``: the frozen CLIP model the taps came from; ``mesh``:
    the data mesh's shape under a launcher, else None): ``history``
    holds one entry per logged step (epoch, step, step_ms, data_ms,
    metrics), where step_ms is the host clock from the batch's copy to the
    device to its metrics read back, and data_ms the host clock spent
    building the batch before it (reading and collating the items, or
    drawing the synthetic batch)."""
    args = parse_args(argv)
    if not args.synthetic and not (args.ann_file and args.image_root):
        raise SystemExit("fvit-train: --ann-file and --image-root are required without --synthetic")
    device = _device(args.device)
    launch = init_distributed(device)
    mesh = None
    if launch is not None:
        device = launch.device
        mesh = create_mesh((launch.world, 1, 1), device)
    check_batch(args.batch_size, num_batch_shards(mesh))
    rows = batch_rows(mesh, args.batch_size)  # this rank's rows of each global batch
    rank = 0 if launch is None else launch.rank
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    cfg = PRESETS[args.preset]
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    if args.dataset is None:
        args.dataset = "lvis" if "lvis" in args.preset else "coco"
    split = coco_split() if args.dataset == "coco" else lvis_split()
    k = len(split["all"])
    if k != cfg.num_classes:
        # a mismatched registry makes the background label (num_classes) an
        # out-of-range gather index
        raise SystemExit(
            f"--dataset {args.dataset} has {k} classes but preset "
            f"{args.preset} expects {cfg.num_classes}"
        )
    rng = np.random.default_rng(args.seed)
    if args.class_embed:
        ce = np.load(args.class_embed).astype(np.float32)
        if ce.shape != (k + 1, cfg.embed_dim):
            raise SystemExit(
                f"--class-embed {args.class_embed} has shape {ce.shape}; "
                f"preset {args.preset} needs ({k + 1}, {cfg.embed_dim}): "
                f"{k} classes + background"
            )
    else:
        log.warning("no --class-embed given; using random embeddings")
        ce = rng.normal(size=(k + 1, cfg.embed_dim)).astype(np.float32)
    ce = ce / np.linalg.norm(ce, axis=-1, keepdims=True)
    class_embed = torch.as_tensor(ce, device=device)
    cw = torch.as_tensor(class_weights(args.dataset, cfg.bg_weight), device=device)

    # the trunk's random weights do not follow --seed: the JAX CLIs, and
    # `fvit-test` here, build it from create_model's default seed, so a
    # checkpoint is scored on the trunk it was trained on
    clip_model = create_model(cfg.clip_model, device=device, dtype=dtype)
    if args.clip_checkpoint:
        load_pretrained(clip_model, args.clip_checkpoint)
    clip_model.requires_grad_(False)
    det = create_detector(cfg, device=device, seed=args.seed)

    if args.synthetic:
        data = SyntheticDetectionData(
            k, image_size=cfg.image_size, max_gt=cfg.max_gt, with_mask=cfg.with_mask
        )
        steps = args.steps_per_epoch or 10

        def batches(epoch):
            for _ in range(steps):
                yield {k: v[rows] for k, v in data.batch(args.batch_size).items()}
    else:
        ds = DetectionDataset(
            args.ann_file, args.image_root, split["all"],
            image_size=cfg.image_size, max_gt=cfg.max_gt, train=True,
            ratio_range=tuple(args.ratio_range),
            seed=args.seed, with_mask=cfg.with_mask,
        )
        steps = args.steps_per_epoch or (len(ds) // args.batch_size)

        def batches(epoch):
            return file_batches(
                ds, args.batch_size, seed=args.seed, epoch=epoch, steps=steps, rows=rows,
            )

    state = DetTrainState(
        det, build_det_optimizer(det, args.lr, args.wd),
        data_parallel=None if mesh is None else data_parallel(det, mesh),
    )
    generator = torch.Generator(device=device).manual_seed(args.seed)
    step_fn = make_det_train_step(clip_model, cfg, class_embed, cw, generator, mesh)
    history = []
    for epoch in range(args.epochs):
        tick = time.perf_counter()
        for i, host in enumerate(batches(epoch)):
            t0 = time.perf_counter()
            batch = {
                k2: torch.as_tensor(v, device=device)
                for k2, v in host.items() if k2 not in ("scale", "image_id")
            }
            metrics = step_fn(state, batch)
            if (i + 1) % args.log_every == 0 or i == 0:
                m = {k2: float(v) for k2, v in metrics.items()}  # waits for the step
                step_ms = (time.perf_counter() - t0) * 1e3
                history.append({
                    "epoch": epoch, "step": state.step, "step_ms": step_ms,
                    "data_ms": (t0 - tick) * 1e3, "metrics": m,
                })
                shown = {k2: round(v, 4) for k2, v in m.items()}
                log.info(f"epoch {epoch} step {i + 1}/{steps} {shown} ({step_ms:.1f} ms)")
            tick = time.perf_counter()
        if rank == 0:
            save_detector(args.output, det, cfg, epoch)
    log.info("done")
    return {"state": state, "history": history, "clip": clip_model,
            "mesh": None if mesh is None else mesh.shape}


def save_detector(output: str, det: FViTDetector, cfg: FViTConfig, epoch: int) -> str:
    """Write the JAX package's checkpoint format: a pickle of {"params":
    flax paths joined by '/' -> float32 arrays in flax layouts, "preset":
    the CLIP model's name, "epoch"}, which both `detector/evaluate.py::
    load_detector` and the JAX package read. Returns the file's path."""
    tree = detector_state_dict_to_jax(det.state_dict())
    flat = {"/".join(path): val for path, val in _flatten(tree).items()}
    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, f"detector_epoch{epoch}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": flat, "preset": cfg.clip_model, "epoch": epoch}, f)
    return path


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():  # the launched group of `init_distributed`
            dist.destroy_process_group()
