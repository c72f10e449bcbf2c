"""CLIPSelf distillation trainer CLI on one device (a port of the distill
path of `clipself_tpu/train/main.py:292-611`).

    python -m clipself_tpu_torch.train.main --synthetic --steps-per-epoch 10 \\
        --model EVA02-CLIP-B-16 --batch-size 2 --det-image-size 1024

parse flags -> student with seeded random weights and a frozen teacher copy
of them -> AdamW with the reference lock and decay rules -> epoch loop of
train steps -> alpha-ensemble checkpoint on save epochs, with resume. The
data are the seeded synthetic batches of `data/loader.py` (`--synthetic`,
required: the COCO datasets are not ported yet). `--device` defaults to
`cuda`; without a CUDA device that is an error, not a CPU run.

Not carried by this slice (ROADMAP.md queue 1): real datasets and the
native loader, `--pretrained`, zero-shot eval during training,
`--accum-freq`, fsdp/tp meshes, the RegionCLIP and
proposal methods, and profiling. Their flags are absent.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import time
from functools import partial

import numpy as np
import torch

from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.loader import SyntheticDistillData
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.train import checkpoint as ckpt
from clipself_tpu_torch.train.methods import (
    clipself_loss,
    multiscale_sizes,
    resize_images_for_scale,
)
from clipself_tpu_torch.train.optim import build_optimizer, make_schedule
from clipself_tpu_torch.train.step import TrainState, make_train_step
from clipself_tpu_torch.utils.meters import AverageMeter, ThroughputMeter

log = logging.getLogger("clipself_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser("clipself_tpu_torch trainer")
    # model
    p.add_argument("--model", default="EVA02-CLIP-B-16")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    p.add_argument("--lock-image", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--lock-image-unlocked-groups", type=int, default=12)
    p.add_argument("--grad-checkpointing", action="store_true",
                   help="recompute each block in the backward pass")
    # method
    p.add_argument("--cosine-weight", type=float, default=1.0)
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--extract-type", default="v2", choices=["v1", "v2"],
                   help="accepted for parity: the EVA tower has one RoI path "
                        "(the reference and the JAX package ignore it there)")
    # data
    p.add_argument("--synthetic", action="store_true", help="seeded synthetic batches")
    p.add_argument("--det-image-size", type=int, default=1024)
    p.add_argument("--max-boxes", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=2, help="batch on the one device")
    p.add_argument("--steps-per-epoch", type=int, default=None, help="required with --synthetic")
    # optim
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--wd", type=float, default=0.1)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--lr-scheduler", default="cosine",
                   choices=["cosine", "const", "const-cooldown"])
    p.add_argument("--epochs-cooldown", type=int, default=None,
                   help="const-cooldown: cooldown over the last N epochs")
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--alpha", type=float, default=0.7, help="ensemble weight on save")
    # infra
    p.add_argument("--name", default=None)
    p.add_argument("--logs", default="./logs")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir, or 'auto' = the run dir's checkpoints")
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--log-every-n-steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu to "
            "run on the CPU)"
        )
    return device


def _setup_logging(out_dir: str) -> None:
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    if not any(type(h) is logging.StreamHandler for h in root.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s | %(message)s"))
        root.addHandler(h)
    # one out.log per run dir; drop file handlers of earlier in-process runs
    for h in [h for h in root.handlers if isinstance(h, logging.FileHandler)]:
        root.removeHandler(h)
        h.close()
    fh = logging.FileHandler(os.path.join(out_dir, "out.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
    root.addHandler(fh)


def train(args) -> dict:
    """Run the distill loop of parsed ``args``. Returns the run's
    {"state", "teacher", "history", "out_dir"}; ``history`` holds one entry
    per logged step (epoch, step, loss, lr, images_per_sec)."""
    if not args.synthetic:
        raise NotImplementedError(
            "only --synthetic data is ported (COCO datasets: ROADMAP.md queue 1 item 2)"
        )
    if not args.steps_per_epoch:
        raise ValueError("--synthetic needs --steps-per-epoch")
    if args.resume == "auto" and not args.name:
        raise ValueError(
            "--resume auto needs --name (without it each run creates a "
            "fresh timestamped dir, so there is nothing to resume from)"
        )
    device = _device(args.device)
    cfg = get_model_config(args.model)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    name = args.name or f"{args.model}-grid_distill-{time.strftime('%Y%m%d-%H%M%S')}"
    out_dir = os.path.join(args.logs, name)
    os.makedirs(out_dir, exist_ok=True)
    _setup_logging(out_dir)
    with open(os.path.join(out_dir, "params.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k}: {getattr(args, k)}\n")

    model = create_model(
        cfg, device=device, dtype=dtype, seed=args.seed,
        grad_checkpointing=args.grad_checkpointing,
    )
    teacher = copy.deepcopy(model).requires_grad_(False)  # the initial weights, frozen

    steps_per_epoch = args.steps_per_epoch
    total_steps = steps_per_epoch * args.epochs
    sched_kw = {}
    if args.lr_scheduler == "const-cooldown":
        cooldown_epochs = args.epochs_cooldown or max(args.epochs // 4, 1)
        sched_kw = dict(
            cooldown_steps=steps_per_epoch * cooldown_epochs,
            cooldown_power=args.lr_cooldown_power,
            cooldown_end_lr=args.lr_cooldown_end,
        )
    schedule = make_schedule(args.lr_scheduler, args.lr, args.warmup, total_steps, **sched_kw)
    optimizer = build_optimizer(
        model, schedule, wd=args.wd, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
        grad_clip_norm=args.grad_clip_norm, unlocked_groups=args.lock_image_unlocked_groups,
        num_layers=cfg.vision.layers, lock_image=args.lock_image,
    )
    state = TrainState(model, optimizer)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    start_epoch = 0
    if args.resume:
        resume_dir = ckpt_dir if args.resume == "auto" else args.resume
        if os.path.isdir(resume_dir):
            state, start_epoch = ckpt.restore_checkpoint(resume_dir, state)
            log.info(f"resume from {resume_dir}: epoch {start_epoch}, step {state.step}")
        elif args.resume != "auto":
            raise FileNotFoundError(resume_dir)
        else:
            log.info("--resume auto: no checkpoint yet, starting fresh")

    step_fn = make_train_step(
        partial(clipself_loss, cosine_weight=args.cosine_weight), teacher
    )
    data = SyntheticDistillData(
        batch_size=args.batch_size, det_size=args.det_image_size,
        crop_size=cfg.vision.image_size, max_anns=args.max_boxes, seed=args.seed,
    )
    if args.multiscale:
        ms_sizes = multiscale_sizes(args.det_image_size, cfg.vision.patch_size)
        ms_rng = np.random.default_rng(args.seed + 1)

        def maybe_multiscale(batch):
            return resize_images_for_scale(batch, int(ms_rng.choice(ms_sizes)))
    else:
        def maybe_multiscale(batch):
            return batch

    log.info(
        f"{args.model} on {device}: batch {args.batch_size}, {args.det_image_size}px images, "
        f"{args.max_boxes} boxes, {len(optimizer.params)} trainable tensors"
    )
    history = []
    train_iter = iter(data)
    host, dev_batch = None, None
    for epoch in range(start_epoch, args.epochs):
        loss_meter = AverageMeter()
        tput = ThroughputMeter()
        for i in range(steps_per_epoch):
            nxt = next(train_iter)
            if nxt is not host:  # the synthetic stream repeats one batch
                host = nxt
                dev_batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
            metrics = step_fn(state, maybe_multiscale(dev_batch))
            tput.update(args.batch_size)
            if (i + 1) % args.log_every_n_steps == 0 or i + 1 == steps_per_epoch:
                loss = float(metrics["loss"])  # waits for the step
                loss_meter.update(loss)
                ips = tput.window()
                lr_now = float(schedule(state.step - 1))
                history.append(
                    {"epoch": epoch, "step": state.step, "loss": loss, "lr": lr_now,
                     "images_per_sec": ips}
                )
                log.info(
                    f"epoch {epoch} step {i + 1}/{steps_per_epoch} loss {loss:.4f} "
                    f"lr {lr_now:.3e} | {ips:.2f} img/s"
                )
        completed = epoch + 1
        log.info(f"epoch {epoch} done | mean logged loss {loss_meter.avg:.4f}")
        if (args.save_frequency and completed % args.save_frequency == 0) or completed == args.epochs:
            ckpt.save_checkpoint(
                ckpt_dir, state, teacher.state_dict(), completed, alpha=args.alpha
            )
    log.info("done")
    return {"state": state, "teacher": teacher, "history": history, "out_dir": out_dir}


def main(argv=None) -> dict:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
