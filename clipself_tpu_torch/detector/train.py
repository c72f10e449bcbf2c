"""F-ViT detector training on one device (a port of
`clipself_tpu/detector/train.py`: mmdet `F-ViT/train.py` + `dist_train.sh`).

    python -m clipself_tpu_torch.detector.train --ann-file <json> --image-root <dir>
    python -m clipself_tpu_torch.detector.train --synthetic --steps-per-epoch 10

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
`cuda`; without a CUDA device that is an error, not a CPU run. The mesh
shardings, buffer donation and TPU compiler options of the JAX step are not
carried (ROADMAP.md queue 1 items 9 and 10).
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

from clipself_tpu_torch.detector.classes import class_weights, coco_split, lvis_split
from clipself_tpu_torch.detector.config import PRESETS, FViTConfig
from clipself_tpu_torch.detector.data import DetectionDataset, SyntheticDetectionData, collate
from clipself_tpu_torch.detector.fvit import FViTDetector, backbone_taps, create_detector
from clipself_tpu_torch.detector.rpn import num_anchors
from clipself_tpu_torch.detector.targets import draw_noise
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.torch_io import _flatten, detector_state_dict_to_jax, load_pretrained
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


@dataclass
class DetTrainState:
    model: FViTDetector
    optimizer: DetOptimizer
    step: int = 0


def make_det_train_step(
    clip_model,
    cfg: FViTConfig,
    class_embed: torch.Tensor,
    class_weight: Optional[torch.Tensor],
    generator: torch.Generator,
) -> Callable[[DetTrainState, dict], dict]:
    """Build ``step_fn(state, batch) -> metrics`` for batches of device
    tensors (`images`, `gt_boxes`, `gt_labels`, `gt_valid`, optional
    `gt_masks`, `valid_hw`). The metrics are device tensors; reading one
    waits for the step. ``generator`` (on the step's device) draws each
    step's sampler noise."""
    anchors = num_anchors(cfg)

    def step_fn(state: DetTrainState, batch: dict) -> dict:
        taps, _ = backbone_taps(clip_model, batch["images"], cfg, False)
        b, g = batch["gt_boxes"].shape[:2]
        noise = draw_noise(generator, b, anchors, cfg.train_proposals.max_per_img + g)
        loss, metrics = state.model.loss(
            taps, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"], noise, class_embed,
            class_weight, batch.get("gt_masks"), batch.get("valid_hw"),
        )
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = state.optimizer.step(state.step)
        state.step += 1
        return metrics

    return step_fn


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
    """Train on parsed ``argv``. Returns {"state", "history", "clip"}
    (``clip``: the frozen CLIP model the taps came from): ``history``
    holds one entry per logged step (epoch, step, step_ms, data_ms,
    metrics), where step_ms is the host clock from the batch's copy to the
    device to its metrics read back, and data_ms the host clock spent
    building the batch before it (reading and collating the items, or
    drawing the synthetic batch)."""
    args = parse_args(argv)
    if not args.synthetic and not (args.ann_file and args.image_root):
        raise SystemExit("fvit-train: --ann-file and --image-root are required without --synthetic")
    device = _device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
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
            return (data.batch(args.batch_size) for _ in range(steps))
    else:
        ds = DetectionDataset(
            args.ann_file, args.image_root, split["all"],
            image_size=cfg.image_size, max_gt=cfg.max_gt, train=True,
            ratio_range=tuple(args.ratio_range),
            seed=args.seed, with_mask=cfg.with_mask,
        )
        steps = args.steps_per_epoch or (len(ds) // args.batch_size)

        def batches(epoch):
            ds.set_epoch(epoch)
            order = np.random.default_rng((args.seed, epoch)).permutation(len(ds))
            for i in range(steps):
                idx = order[i * args.batch_size : (i + 1) * args.batch_size]
                if len(idx) < args.batch_size:
                    return
                yield collate([ds[int(j)] for j in idx])

    state = DetTrainState(det, build_det_optimizer(det, args.lr, args.wd))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    step_fn = make_det_train_step(clip_model, cfg, class_embed, cw, generator)
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
        save_detector(args.output, det, cfg, epoch)
    log.info("done")
    return {"state": state, "history": history, "clip": clip_model}


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
    main()
