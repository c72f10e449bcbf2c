"""CLIPSelf and RegionCLIP trainer CLI on one device or a mesh of ranks (a
port of `clipself_tpu/train/main.py:174-611`).

    python -m clipself_tpu_torch.train.main \\
        --model EVA02-CLIP-B-16 --dataset-type grid_distill \\
        --train-data instances_train2017.json --train-image-root train2017 \\
        --val-data panoptic_val2017.json --val-image-root val2017 \\
        --val-segm-root panoptic_val2017 --embed-path coco_panoptic_b16.npy \\
        --batch-size 2 --det-image-size 1024 --workers 8

parse flags -> student with seeded random weights (or `--pretrained`) and
a copy of its initial weights (a frozen teacher module for the distill
methods, a state dict for RegionCLIP, which runs no teacher) -> AdamW with
the reference lock and decay rules, optionally accumulating gradients over
`--accum-freq` micro-steps -> zero-shot eval -> epoch loop of train steps
-> alpha-ensemble checkpoint on save epochs (`--keep-checkpoints`,
`--save-most-recent`, `--export-torch`), with resume -> zero-shot eval of
the ensembled weights every `--zeroshot-frequency` epochs, each appended to
`results.jsonl` (NaN as null). The data routes (`data/`, no PIL):
  - `--train-data`: COCO files, `grid_distill`, `proposals_distill` or
    `region_clip` items made by `--workers` spawned processes, a fresh
    loader an epoch; with `--native-loader` (grid_distill; ignored for the
    others, as in the JAX trainer) the C++ core's thread pool
    (`native/loader.cc`, built with `make -C native`; needs the libjpeg and
    libpng headers);
  - `--val-data` (COCO-panoptic): the evaluator; without `--train-data` the
    run evaluates once and returns;
  - `--synthetic`: one seeded distill batch, repeated (`--steps-per-epoch`
    needed; there is no synthetic RegionCLIP batch, as in the JAX package).
`region_clip` trains against the `--train-embed-path` noun embeddings with
the federated BCE of `train/methods.py::regionclip_loss`; its class-sampling
noise is drawn on the device from ``(--seed, step)``.
Batches reach the card through `data/loader.py::device_prefetch`.
`--device` defaults to `cuda`; without a CUDA device that is an error, not
a CPU run.

`--model` takes the EVA01 / EVA02 configs, the plain OpenCLIP / OpenAI ViT
ones (`ViT-B-16`, `ViT-L-14-336`, ...) and the ModifiedResNet ones (`RN50`,
...); `--extract-type v1` pools the ViT's RoI features by mask attention
and the ResNet's by its attention pool over 7x7 RoI-aligned maps (the EVA
tower, as in the JAX package, ignores it), `--force-quick-gelu` sets
QuickGELU in both towers, `--lock-image-freeze-bn-stats` keeps the
ResNet's BatchNorm statistics out of the update, `--force-patch-dropout`
sets the config's patch dropout (which, as in the JAX trainer, no step
applies: the drop needs keep indices that the trainer never gives), and
`--pretrained` takes a file or a catalog tag (`models/pretrained.py`;
nothing is downloaded). The timm-family towers (`convnext_*`, `swin_*`,
`vit_*`) train with `--no-lock-image` (under the lock none of their
parameters trains, as in the JAX trainer); `--pretrained-image` marks such a
tower's config `timm_model_pretrained`, which without `--pretrained` only
logs a warning (no hub weights are fetched).

Under a launcher, one process a GPU, the JAX trainer's dp / fsdp / tp mesh
(`parallel/mesh.py`):

    torchrun --nproc-per-node 8 -m clipself_tpu_torch.train.main --synthetic \\
        --steps-per-epoch 10 --batch-size 8 --fsdp-size 2 --tp-size 2

gives a (data 2, fsdp 2, model 2) mesh: each rank takes its rows of the
global batch (every rank builds the global batch from the seed, or from the
files in the seeded order), FSDP2 shards the student and the frozen teacher
over (data, fsdp), the transformer blocks that the JAX package lays out
over `model` are tensor-parallel over it (the EVA and OpenCLIP ViT image
towers, the CLIP text tower of every model; the ModifiedResNet, timm, HF
and CoCa cross-attention parts are replicated, as in JAX), the losses are
those of the global batch, rank 0 writes the run's files and the
checkpoints (in the single-process format, so they resume under any mesh),
and the evaluator splits each batch over the ranks. `--n-devices`
must equal the launched world size; without a launcher the run is the
single-process one, and `--fsdp-size` / `--tp-size` above 1 are refused
with the JAX trainer's error. `--device cpu` runs the group over gloo.

Not carried (ROADMAP.md queue 1, item 10): the TPU knobs (`--attn-impl`,
`--pad-multiple`, `--scoped-vmem-kib`, `--profile-dir`). Their flags are
absent.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import os
import time
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.datasets import (
    COCOPanopticEvalDataset,
    GridDistillDataset,
    ProposalDistillDataset,
    RegionCLIPDataset,
)
from clipself_tpu_torch.data.loader import (
    SyntheticDistillData,
    loader_route,
    make_loader,
    native_route,
    rank_batches,
    stop_worker_server,
    synthetic_route,
)
from clipself_tpu_torch.eval.zero_shot import (
    DEFAULT_ANN_BUCKET,
    evaluate_zero_shot,
    metrics_json,
)
from clipself_tpu_torch.models.clip import dense_stride
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.pretrained import resolve_pretrained
from clipself_tpu_torch.models.torch_io import load_pretrained
from clipself_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    check_batch,
    create_mesh,
    full_state_dict,
    init_distributed,
    load_full_state_dict,
    mesh_shape,
    shard_model,
)
from clipself_tpu_torch.train import checkpoint as ckpt
from clipself_tpu_torch.train.methods import (
    clipself_loss,
    make_regionclip_loss,
    multiscale_sizes,
    resize_images_for_scale,
)
from clipself_tpu_torch.train.ensemble import student_teacher_ensemble
from clipself_tpu_torch.train.optim import build_optimizer, make_schedule, set_trainable
from clipself_tpu_torch.train.step import TrainState, make_train_step
from clipself_tpu_torch.utils.meters import AverageMeter, ThroughputMeter

log = logging.getLogger("clipself_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser("clipself_tpu_torch trainer")
    # model
    p.add_argument("--model", default="EVA02-CLIP-B-16")
    p.add_argument("--pretrained", default=None,
                   help="reference-layout .pt (or .npz), or a catalog tag of --model "
                        "(models/pretrained.py), to start from; non-strict, as the JAX "
                        "trainer's import")
    p.add_argument("--pretrained-image", action="store_true",
                   help="timm towers: mark the trunk pretrained (reference factory.py:182-187); "
                        "nothing is fetched, pass --pretrained for weights")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    p.add_argument("--lock-image", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--lock-image-unlocked-groups", type=int, default=12)
    p.add_argument("--grad-checkpointing", action="store_true",
                   help="recompute each block in the backward pass")
    p.add_argument("--force-quick-gelu", action="store_true",
                   help="QuickGELU in both towers (the OpenAI weights' activation)")
    p.add_argument("--lock-image-freeze-bn-stats", action="store_true",
                   help="freeze BatchNorm running stats in unlocked image-tower groups "
                        "(reference main.py:165; here the stats are parameters, so "
                        "'freeze' keeps them out of the update)")
    p.add_argument("--force-patch-dropout", type=float, default=None,
                   help="override the config's vision patch_dropout "
                        "(reference factory.py:174-176)")
    # method
    p.add_argument("--cosine-weight", type=float, default=1.0)
    p.add_argument("--contrast-weight", type=float, default=1.0)
    p.add_argument("--multiscale", action="store_true", help="ignored for region_clip")
    p.add_argument("--extract-type", default="v2", choices=["v1", "v2"],
                   help="RoI features of the OpenCLIP ViT: v2 RoI-align on the dense map, "
                        "v1 mask-attention pooling (also the evaluator's masks); the EVA "
                        "tower has one RoI path and ignores it")
    p.add_argument("--dataset-type", default="grid_distill",
                   choices=["grid_distill", "proposals_distill", "region_clip"])
    p.add_argument("--train-embed-path", default=None,
                   help="RegionCLIP noun embeddings .npy (needed for region_clip)")
    # data
    p.add_argument("--train-data", default=None, help="COCO instances or proposals JSON")
    p.add_argument("--train-image-root", default=None)
    p.add_argument("--val-data", default=None, help="COCO-panoptic JSON")
    p.add_argument("--val-image-root", default=None)
    p.add_argument("--val-segm-root", default=None)
    p.add_argument("--test-type", default="coco_panoptic", choices=["coco_panoptic"],
                   help="val dataset type (reference data.py:643)")
    p.add_argument("--downsample-factor", type=int, default=None,
                   help="eval dense-map downsample; default = the stride of the tower's dense map "
                        "(models/clip.py::dense_stride)")
    p.add_argument("--embed-path", default=None, help="class embeddings .npy of the val set")
    p.add_argument("--synthetic", action="store_true", help="seeded synthetic batches")
    p.add_argument("--det-image-size", type=int, default=1024)
    p.add_argument("--max-boxes", type=int, default=20)
    p.add_argument("--max-split", type=int, default=16)
    p.add_argument("--crop-scale", type=float, default=1.0)
    p.add_argument("--pre-transforms", action="store_true")
    p.add_argument("--train-ratio", type=float, default=1.0)
    p.add_argument("--min-size", type=float, default=8.0)
    p.add_argument("--max-size", type=float, default=1024.0)
    p.add_argument("--batch-size", type=int, default=2,
                   help="global batch (split over the data-like ranks of a mesh)")
    p.add_argument("--val-batch-size", type=int, default=1)
    p.add_argument("--workers", type=int, default=8,
                   help="data worker processes (threads of the native pool)")
    p.add_argument("--native-loader", action="store_true",
                   help="use the C++ decode/resize pool for grid_distill (ignored otherwise)")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="default len(train set) // batch size; required with --synthetic")
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
    p.add_argument("--skip-scheduler", action="store_true",
                   help="constant base LR, no warmup or decay (reference train.py:84)")
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--accum-freq", type=int, default=1,
                   help="gradient accumulation micro-steps an update (optax.MultiSteps)")
    p.add_argument("--alpha", type=float, default=0.7, help="ensemble weight on save")
    # infra
    p.add_argument("--name", default=None)
    p.add_argument("--logs", default="./logs")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir, or 'auto' = the newer of the run dir's checkpoints/ "
                        "and checkpoints_latest/")
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--save-most-recent", action="store_true",
                   help="also keep a rolling checkpoints_latest/ written every epoch")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="retain only the newest N epoch checkpoints")
    p.add_argument("--export-torch", action="store_true",
                   help="also write each saved checkpoint as <run>/epoch_<n>.pt")
    p.add_argument("--zeroshot-frequency", type=int, default=1)
    p.add_argument("--image-ave-pool", action="store_true",
                   help="evaluator crop features = average-pooled dense map "
                        "instead of encode_image (reference zero_shot.py:78)")
    p.add_argument("--eval-ann-bucket", type=int, default=None,
                   help=f"zero-shot eval ann-axis bucket width (default {DEFAULT_ANN_BUCKET}; "
                        "0 disables)")
    p.add_argument("--log-every-n-steps", type=int, default=50)
    p.add_argument("--debug", action="store_true", help="DEBUG log level")
    p.add_argument("--log-local", action="store_true",
                   help="write out-<rank>.log (out-0.log: one process) instead of out.log")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks of the mesh: must equal the launched world size (1 without a launcher)")
    p.add_argument("--fsdp-size", type=int, default=1,
                   help="shard params/optimizer state over this many ranks "
                        "(FSDP2 over an 'fsdp' mesh axis; 1 = pure data parallel)")
    p.add_argument("--tp-size", type=int, default=1,
                   help="Megatron tensor parallelism over a 'model' mesh axis "
                        "(EVA towers; a branch whose heads or hidden width does not divide stays whole)")
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu to "
            "run on the CPU)"
        )
    return device


def _setup_logging(args, out_dir: str, rank: int = 0) -> None:
    """DEBUG level under ``--debug``, else INFO; rank 0 writes the run dir's
    out.log, or with ``--log-local`` every rank its own out-<rank>.log
    (`clipself_tpu/train/main.py::setup_logging`)."""
    level = logging.DEBUG if args.debug else logging.INFO
    root = logging.getLogger()
    root.setLevel(level)
    if not any(type(h) is logging.StreamHandler for h in root.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s | %(message)s"))
        root.addHandler(h)
    # one log file per run dir; drop file handlers of earlier in-process runs
    for h in [h for h in root.handlers if isinstance(h, logging.FileHandler)]:
        root.removeHandler(h)
        h.close()
    if rank and not args.log_local:
        return
    fh = logging.FileHandler(os.path.join(out_dir, f"out-{rank}.log" if args.log_local else "out.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
    fh.setLevel(level)
    root.addHandler(fh)


def build_data(args, device: torch.device, crop_size: int, mesh: Optional[Mesh] = None) -> dict:
    """The run's data (`clipself_tpu/train/main.py::build_data`): "train" a
    `data/loader.py::TrainRoute` (device batches an epoch, each of this
    rank's rows of the global batch), "train_size" with files; "val_ds" and
    "val" (a factory of the evaluator's batches: on a ``mesh`` each rank's
    rows of a batch that divides over its batch shards, `RankRows`) with
    ``--val-data``. A rank reads the items of its own rows alone."""
    rows = batch_rows(mesh, args.batch_size)
    data = {}
    if args.synthetic:
        data["train"] = synthetic_route(SyntheticDistillData(
            batch_size=args.batch_size, det_size=args.det_image_size,
            crop_size=crop_size, max_anns=args.max_boxes, seed=args.seed,
        ), device, rows=rows)
        return data
    pin = device.type == "cuda"
    if args.train_data:
        if args.dataset_type == "grid_distill":
            ds = GridDistillDataset(
                args.train_data, args.train_image_root,
                det_size=args.det_image_size, crop_size=crop_size,
                max_split=args.max_split, max_anns=args.max_boxes,
                crop_scale=args.crop_scale, pre_transforms=args.pre_transforms,
                train_ratio=args.train_ratio, seed=args.seed,
            )
        elif args.dataset_type == "proposals_distill":
            ds = ProposalDistillDataset(
                args.train_data, args.train_image_root,
                det_size=args.det_image_size, crop_size=crop_size,
                max_anns=args.max_boxes, min_size=args.min_size,
                max_size=args.max_size, seed=args.seed,
            )
        else:
            ds = RegionCLIPDataset(
                args.train_data, args.train_image_root,
                det_size=args.det_image_size, max_anns=args.max_boxes,
                train_ratio=args.train_ratio, seed=args.seed,
            )
        data["train_size"] = len(ds)
        route = native_route if args.native_loader and args.dataset_type == "grid_distill" \
            else loader_route
        data["train"] = route(
            ds, args.batch_size, seed=args.seed, workers=args.workers, device=device, rows=rows,
        )
    if args.val_data:
        if not args.embed_path:
            raise ValueError("--val-data needs --embed-path (the class embeddings .npy)")
        val_ds = COCOPanopticEvalDataset(
            args.val_data, args.val_image_root, args.val_segm_root,
            embed_path=args.embed_path, det_size=args.det_image_size,
            crop_size=crop_size, downsample_factor=args.downsample_factor,
        )
        data["val_ds"] = val_ds
        data["val"] = lambda: rank_batches(make_loader(
            val_ds, args.val_batch_size, shuffle=False, num_workers=args.workers,
            # never drop tail eval images: mAcc must see the whole val set
            drop_last=False, pin_memory=pin, rows=partial(batch_rows, mesh),
        ))
    return data


def noun_embeddings(path: str, device: torch.device) -> torch.Tensor:
    """The RegionCLIP noun embeddings of ``path`` ([C, D] .npy) as float32
    rows L2-normalized with +1e-12, on ``device`` (JAX `main.py:401-403`)."""
    emb = np.load(path).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12
    return torch.as_tensor(emb, device=device)


def _resume_dir(args, out_dir: str) -> str:
    """``--resume``: the given dir, or with 'auto' whichever of the run's
    checkpoints/ and checkpoints_latest/ holds the newest epoch (the first
    on a tie; JAX `main.py:440-457`)."""
    if args.resume != "auto":
        return args.resume
    candidates = [os.path.join(out_dir, "checkpoints"), os.path.join(out_dir, "checkpoints_latest")]
    return max(
        (d for d in candidates if os.path.isdir(d)),
        key=lambda d: ckpt.latest_epoch(d) or -1,
        default=candidates[0],
    )


def train(args) -> dict:
    """Run the training loop of parsed ``args``. Returns the run's
    {"state", "teacher", "teacher_params", "history", "evals",
    "native_fallback_rows", "out_dir"}: ``teacher`` is the frozen teacher
    module (None for region_clip), ``teacher_params`` the initial weights
    that the alpha-ensemble mixes in; ``history`` holds one entry per logged
    step (epoch, step, loss, the method's own loss, lr, images_per_sec),
    ``evals`` one per evaluation (epoch and metrics, as in results.jsonl);
    ``native_fallback_rows`` counts the rows that `--native-loader` left to
    the NumPy route (None without it). An evaluation-only run
    (``--val-data`` without ``--train-data``) returns {"evals", "out_dir"}.
    Under a launcher every rank calls it; the returned state is the rank's
    (`parallel/mesh.py::full_state_dict` gathers the model), and "mesh" is
    added to the result."""
    region = args.dataset_type == "region_clip"
    if not (args.synthetic or args.train_data or args.val_data):
        raise ValueError("no data: pass --synthetic, --train-data or --val-data")
    if args.synthetic and not args.steps_per_epoch:
        raise ValueError("--synthetic needs --steps-per-epoch")
    if region and args.synthetic:
        raise ValueError("--dataset-type region_clip has no synthetic batch: pass --train-data")
    if region and args.train_data and not args.train_embed_path:
        raise ValueError("--dataset-type region_clip needs --train-embed-path (the noun embeddings .npy)")
    if args.resume == "auto" and not args.name:
        raise ValueError(
            "--resume auto needs --name (without it each run creates a "
            "fresh timestamped dir, so there is nothing to resume from)"
        )
    device = _device(args.device)
    cfg = get_model_config(args.model)
    if args.force_patch_dropout is not None:
        # override the config's patch dropout (reference factory.py:174-176)
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, patch_dropout=args.force_patch_dropout)
        )
    if args.pretrained_image:
        # reference factory.py:182-187: timm towers only
        if not cfg.vision.timm_model_name:
            raise ValueError("pretrained image towers currently only supported for timm models")
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, timm_model_pretrained=True))
    if args.force_quick_gelu:
        # reference main.py:125 -> the factory's quick_gelu override
        cfg = dataclasses.replace(
            cfg,
            vision=dataclasses.replace(cfg.vision, quick_gelu=True),
            text=dataclasses.replace(cfg.text, quick_gelu=True),
        )
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.downsample_factor is None:
        # the dense map's stride, not `cfg.vision.patch_size` as the JAX
        # trainer takes it: the two differ for the HF trunk adapter (the HF
        # config's patch) and ConvNeXt / Swin (32), where masks on the
        # patch_size grid do not fit the dense map (ROADMAP.md queue 3, Watch)
        args.downsample_factor = dense_stride(cfg.vision)
    launch = init_distributed(device)
    world = 1 if launch is None else launch.world
    if args.n_devices is not None and args.n_devices != world:
        raise ValueError(
            f"--n-devices {args.n_devices}: the launch has {world} process(es), one a device"
        )
    shape = mesh_shape(world, args.fsdp_size, args.tp_size)
    check_batch(args.batch_size, shape[0] * shape[1])
    mesh: Optional[Mesh] = None
    if launch is not None:
        device = launch.device
        mesh = create_mesh(shape, device)
    rank = 0 if mesh is None else dist.get_rank()
    data = build_data(args, device, cfg.vision.image_size, mesh)

    name = args.name or f"{args.model}-{args.dataset_type}-{time.strftime('%Y%m%d-%H%M%S')}"
    if mesh is not None and not args.name:
        # every rank writes into rank 0's run dir (JAX main.py:381-390)
        box = [name]
        dist.broadcast_object_list(box, src=0)
        name = box[0]
    out_dir = os.path.join(args.logs, name)
    os.makedirs(out_dir, exist_ok=True)
    _setup_logging(args, out_dir, rank)
    if rank == 0:
        with open(os.path.join(out_dir, "params.txt"), "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k}: {getattr(args, k)}\n")
    log.debug("args: " + ", ".join(f"{k}={getattr(args, k)}" for k in sorted(vars(args))))

    model = create_model(
        cfg, device=device, dtype=dtype, seed=args.seed,
        grad_checkpointing=args.grad_checkpointing,
    )
    if args.pretrained:
        # a file, or a catalog tag resolved to its cached file (`create_model(pretrained=)`'s route)
        load_pretrained(model, resolve_pretrained(cfg.name, args.pretrained))
    evals = []
    eval_model = None
    if mesh is not None:
        # copies of the initial weights before the layout: the ensemble's host
        # copy, the frozen teacher and the evaluator's model of ensembled weights
        teacher_params = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        teacher = (
            copy.deepcopy(model).requires_grad_(False) if "train" in data and not region else None
        )
        if "val" in data and args.zeroshot_frequency != 0:
            eval_model = copy.deepcopy(model).requires_grad_(False)
        set_trainable(
            model, args.lock_image_unlocked_groups, cfg.vision.layers, args.lock_image,
            args.lock_image_freeze_bn_stats,
        )
        for m in (model, teacher, eval_model):
            if m is not None:
                shard_model(m, mesh)

    def run_eval(params, epoch) -> None:
        """Zero-shot eval of ``model`` with ``params`` (a state dict; None =
        the student as it is), appended to results.jsonl."""
        nonlocal eval_model
        if "val" not in data or args.zeroshot_frequency == 0:
            return
        target = model
        if params is not None:
            if mesh is not None:
                load_full_state_dict(eval_model, params, mesh)
            else:
                if eval_model is None:
                    eval_model = copy.deepcopy(model).requires_grad_(False)
                eval_model.load_state_dict(params)
            target = eval_model
        bucket = DEFAULT_ANN_BUCKET if args.eval_ann_bucket is None else args.eval_ann_bucket
        results = evaluate_zero_shot(
            target, data["val"](), data["val_ds"].embeddings, device=device,
            ann_bucket=bucket, image_ave_pool=args.image_ave_pool,
            extract_type=args.extract_type, mesh=mesh,
        )
        line = metrics_json({"epoch": epoch, **results})  # NaN as null
        log.info(f"eval epoch {epoch}: {line}")
        if rank == 0:
            with open(os.path.join(out_dir, "results.jsonl"), "a") as f:
                f.write(line + "\n")
        evals.append(json.loads(line))

    if "train" not in data:
        run_eval(None, 0)
        log.info("done")
        return {"evals": evals, "out_dir": out_dir, "mesh": mesh}

    # the initial weights: the distill methods' frozen teacher; RegionCLIP runs
    # no teacher and keeps them on the host for the alpha-ensemble only (on a
    # mesh both were taken before the layout, above)
    if mesh is None and region:
        teacher = None
        teacher_params = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    elif mesh is None:
        teacher = copy.deepcopy(model).requires_grad_(False)
        teacher_params = teacher.state_dict()
    route = data["train"]
    steps_per_epoch = args.steps_per_epoch or route.steps
    if steps_per_epoch < 1:
        raise ValueError(
            f"{data['train_size']} training images make no batch of {args.batch_size}"
        )
    if not route.endless and steps_per_epoch > route.steps:
        # a loader is one pass over the images; only the native loader runs on
        raise ValueError(
            f"--steps-per-epoch {steps_per_epoch}: an epoch of {data['train_size']} images "
            f"has {route.steps} batches of {args.batch_size}"
        )
    total_steps = steps_per_epoch * args.epochs
    if args.skip_scheduler:
        # the reference never steps its scheduler (train.py:84): the base LR throughout
        schedule = make_schedule("const", args.lr, 0, total_steps)
    else:
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
        num_layers=cfg.vision.layers, lock_image=args.lock_image, accum_steps=args.accum_freq,
        freeze_bn_stats=args.lock_image_freeze_bn_stats, mesh=mesh,
    )
    state = TrainState(model, optimizer)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    start_epoch = 0
    if args.resume:
        resume_dir = _resume_dir(args, out_dir)
        if os.path.isdir(resume_dir):
            state, start_epoch = ckpt.restore_checkpoint(resume_dir, state, mesh=mesh)
            log.info(f"resume from {resume_dir}: epoch {start_epoch}, step {state.step}")
        elif args.resume != "auto":
            raise FileNotFoundError(resume_dir)
        else:
            log.info("--resume auto: no checkpoint yet, starting fresh")

    group = None if mesh is None else mesh.batch_group  # the losses are the global batch's
    if region:
        loss_fn = make_regionclip_loss(
            noun_embeddings(args.train_embed_path, device), args.seed,
            contrast_weight=args.contrast_weight, extract_type=args.extract_type, group=group,
        )
    else:
        loss_fn = partial(
            clipself_loss, cosine_weight=args.cosine_weight, extract_type=args.extract_type,
            group=group,
        )
    step_fn = make_train_step(loss_fn, teacher, mesh=mesh)
    if args.multiscale and not region:
        ms_sizes = multiscale_sizes(args.det_image_size, cfg.vision.patch_size)
        ms_rng = np.random.default_rng(args.seed + 1)

        def maybe_multiscale(batch):
            return resize_images_for_scale(batch, int(ms_rng.choice(ms_sizes)))
    else:
        def maybe_multiscale(batch):
            return batch

    if mesh is not None:
        log.info(f"mesh (data, fsdp, model) {shape}: rank {rank} at {mesh.coords} on {device}")
    log.info(
        f"{args.model} on {device}: {args.dataset_type}, batch {args.batch_size}, "
        f"{args.det_image_size}px images, {args.max_boxes} boxes, {len(optimizer.params)} "
        f"trainable tensors, {args.accum_freq} micro-step(s) an update"
    )
    # eval before training (reference main.py:263-269)
    run_eval(None, start_epoch)
    history = []
    for epoch in range(start_epoch, args.epochs):
        batches = route.epoch(epoch)
        loss_meter = AverageMeter()
        tput = ThroughputMeter()
        for i in range(steps_per_epoch):
            metrics = step_fn(state, maybe_multiscale(next(batches)))
            tput.update(args.batch_size)
            if (i + 1) % args.log_every_n_steps == 0 or i + 1 == steps_per_epoch:
                loss = float(metrics["loss"])  # waits for the step
                loss_meter.update(loss)
                ips = tput.window()
                entry = {"epoch": epoch, "step": state.step, "loss": loss, "lr": optimizer.lr,
                         "images_per_sec": ips}
                entry.update({k: float(v) for k, v in metrics.items() if k.startswith("loss_")})
                history.append(entry)
                log.info(
                    f"epoch {epoch} step {i + 1}/{steps_per_epoch} loss {loss:.4f} "
                    f"lr {optimizer.lr:.3e} | {ips:.2f} img/s"
                )
        completed = epoch + 1
        log.info(f"epoch {epoch} done | mean logged loss {loss_meter.avg:.4f}")
        batches.close()  # ends this epoch's loader and its worker processes
        if route.fallback_rows is not None:
            log.info(f"native loader: {route.fallback_rows} row(s) built by the NumPy route so far")
        if (args.save_frequency and completed % args.save_frequency == 0) or completed == args.epochs:
            target = ckpt.save_checkpoint(
                ckpt_dir, state, teacher_params, completed, alpha=args.alpha,
                keep=args.keep_checkpoints, mesh=mesh,
            )
            if args.export_torch and rank == 0:
                path = os.path.join(out_dir, f"epoch_{completed}.pt")
                ckpt.export_torch(path, target, epoch=completed, name=name)
                log.debug(f"exported {path}")
        elif args.alpha < 1.0 and "val" in data and mesh is not None:
            target = student_teacher_ensemble(full_state_dict(state.model, mesh), teacher_params, args.alpha)
        elif args.alpha < 1.0 and "val" in data:
            initial = {k: v.to(device) for k, v in teacher_params.items()}  # RegionCLIP's are on the host
            target = student_teacher_ensemble(state.model.state_dict(), initial, args.alpha)
        else:
            target = None
        if args.save_most_recent:
            # rolling latest, every epoch whatever --save-frequency says (JAX main.py:600-607)
            ckpt.save_checkpoint(
                os.path.join(out_dir, "checkpoints_latest"), state, teacher_params, completed,
                alpha=args.alpha, keep=1, mesh=mesh,
            )
        if args.zeroshot_frequency > 0 and completed % args.zeroshot_frequency == 0:
            run_eval(target, completed)
    route.close()
    log.info("done")
    return {"state": state, "teacher": teacher, "teacher_params": teacher_params,
            "history": history, "evals": evals, "native_fallback_rows": route.fallback_rows,
            "out_dir": out_dir, "mesh": mesh}


def main(argv=None) -> dict:
    return train(parse_args(argv))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_worker_server()
        if dist.is_initialized():  # the launched group of `parallel/mesh.py::init_distributed`
            dist.destroy_process_group()
