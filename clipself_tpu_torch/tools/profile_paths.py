"""Where the device time of the main paths goes, by kernel class.

    python -m clipself_tpu_torch.tools.profile_paths \\
        --model EVA02-CLIP-L-14-336 --det-image-size 896 --eval-batch 1
    python -m clipself_tpu_torch.tools.profile_paths --path detector

``--path clip`` (the default) runs the distill step (batch 2, 20 boxes, every block unlocked, bf16, AdamW,
seeded random weights, one synthetic batch staged on the device) and the
zero-shot evaluator (13 valid of 100 annotations, bucket 25) of one model,
each first without the profiler (host clock around a synchronised window:
ms per step or batch, images/s, peak memory) and then under
`torch.profiler` for ``--steps`` steps or batches, and prints for each a
table of kernel classes: ms per step, share of the kernel time, launches per
step; then the kernel time against the window (the device's idle share,
under the profiler and derived for the unprofiled run). The first line
names the card and its power limit; with ``--json`` the last line is the
tables as one JSON object. `--device cpu` rehearses the control flow at a
small model; it has no device time to report and says so.

``--path detector`` runs the F-ViT detector of ``--preset`` (default
`ov_coco_vitb16`: EVA02-CLIP-B/16 at 640^2) on one synthetic batch of
``--det-batch`` images the same way, twice: `predict` alone on images staged
on the device (backbone taps, heads, both NMS passes), and
`evaluate_detector` over the same images as host items (adds the copy to
the device and the NumPy COCO matching).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from functools import partial

import numpy as np
import torch

from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.data.loader import SyntheticDistillData
from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
from clipself_tpu_torch.detector.classes import base_novel_mask
from clipself_tpu_torch.detector.config import PRESETS
from clipself_tpu_torch.detector.data import SyntheticDetectionData, synthetic_eval_items
from clipself_tpu_torch.detector.evaluate import evaluate_detector, make_predict_fn
from clipself_tpu_torch.detector.fvit import create_detector
from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.train.methods import clipself_loss
from clipself_tpu_torch.train.optim import build_optimizer, make_schedule
from clipself_tpu_torch.train.step import TrainState, make_train_step

# kernel class: substrings of the kernel's name, first match wins
CLASSES = (
    ("flash_attention_bwd kernel", ("flash_bwd_kernel", "flash_bwd_wgmma_kernel")),
    (
        "flash backward di pass, dQ cast",
        ("flash_bwd_di_kernel", "f32_to_bf16_kernel", "dq_tiles_to_bf16_kernel"),
    ),
    ("flash_attention forward kernel", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")),
    ("layer_norm forward kernel", ("layer_norm_fwd_kernel",)),
    ("layer_norm backward kernel and its reduce", ("layer_norm_bwd",)),
    ("rope_roll kernel", ("rope_roll_kernel",)),
    ("nms kernel", ("nms_kernel",)),
    ("convolutions (cuDNN)", ("cudnn", "conv2d", "fprop", "dgrad", "implicit_gemm", "nchwToNhwc", "nhwcToNchw")),
    ("GroupNorm", ("GroupNorm", "group_norm", "RowwiseMoments")),
    ("sorts", ("sort", "Sort", "radix", "Radix")),
    ("gathers and index selections", ("gather", "index", "scatter")),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "cublas", "gemv")),
    ("AdamW multi-tensor kernels", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("dtype casts and copies", ("copy", "Memcpy", "direct_copy", "CatArrayBatchedCopy")),
    ("memsets and fills", ("Memset", "FillFunctor")),
    ("elementwise", ("elementwise", "vectorized")),
)


def classify(name: str) -> str:
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn, n: int, device: torch.device, images: int) -> dict:
    """``fn`` run ``n`` times unprofiled, then ``n`` times under the
    profiler; returns the table and the totals."""
    fn()  # warm-up
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    out = {"wall_ms": wall_ms, "images_per_sec": images / wall_ms * 1e3}
    if device.type != "cuda":
        out["device"] = "not measured (no CUDA device)"
        return out
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    table: dict[str, list] = {}
    other: dict[str, float] = {}
    events = prof.key_averages()
    # a host range (`Optimizer.step#AdamW.step`, ...) is mirrored onto the
    # device's timeline under the same name: it spans kernels, it is not one
    host_names = {ev.key for ev in events if ev.device_type == torch.autograd.DeviceType.CPU}
    for ev in events:
        device_us = getattr(ev, "self_device_time_total", 0) or 0
        if ev.device_type != torch.autograd.DeviceType.CUDA or device_us <= 0:
            continue
        if ev.key in host_names:
            continue
        label = classify(ev.key)
        row = table.setdefault(label, [0.0, 0])
        row[0] += device_us / 1e3 / n
        row[1] += ev.count / n
        if label == "other":
            other[ev.key] = other.get(ev.key, 0.0) + device_us / 1e3 / n
    kernel_ms = sum(r[0] for r in table.values())
    if kernel_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    out.update(
        profiled_wall_ms=profiled_ms, kernel_ms=kernel_ms,
        launches=sum(r[1] for r in table.values()),
        idle_share_profiled=1 - kernel_ms / profiled_ms,
        idle_share_derived=1 - kernel_ms / wall_ms,
        classes={
            k: {"ms": v[0], "share": v[0] / kernel_ms, "launches": v[1]}
            for k, v in sorted(table.items(), key=lambda kv: -kv[1][0])
        },
        # the largest kernels that no class names, with their ms
        other=dict(sorted(other.items(), key=lambda kv: -kv[1])[:3]),
    )
    return out


def report(title: str, unit: str, res: dict) -> None:
    if "classes" not in res:
        print(f"{title}: ran on the CPU ({res['wall_ms']:.3f} ms per {unit} of host time); "
              f"device time {res['device']}", flush=True)
        return
    print(f"{title}: {res['wall_ms']:.3f} ms per {unit} unprofiled, "
          f"{res['images_per_sec']:.3f} images/s", flush=True)
    print(
        f"  peak memory {res['peak_gib']:.3f} GiB; under the profiler {res['profiled_wall_ms']:.3f} "
        f"ms per {unit}, kernel time {res['kernel_ms']:.3f} ms, {res['launches']:.0f} kernels per "
        f"{unit}; idle share {res['idle_share_profiled']:.1%} under the profiler, "
        f"{res['idle_share_derived']:.1%} derived for the unprofiled run",
        flush=True,
    )
    print(f"  | kernel class | ms / {unit} | share of kernel time | launches / {unit} |")
    print("  |---|---|---|---|")
    for label, row in res["classes"].items():
        print(f"  | {label} | {row['ms']:.3f} | {row['share']:.1%} | {row['launches']:.0f} |")
    for name, ms in res["other"].items():
        print(f"  other: {ms:.3f} ms {name[:120]}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("clipself_tpu_torch path profiler")
    p.add_argument("--path", default="clip", choices=["clip", "detector"])
    p.add_argument("--preset", default="ov_coco_vitb16", choices=sorted(PRESETS))
    p.add_argument("--det-batch", type=int, default=8)
    p.add_argument("--model", default="EVA02-CLIP-B-16")
    p.add_argument("--det-image-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--max-boxes", type=int, default=20)
    p.add_argument("--eval-batch", type=int, default=2)
    p.add_argument("--max-anns", type=int, default=100)
    p.add_argument("--valid-anns", type=int, default=13)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0], flush=True)
    if args.path == "detector":
        out = profile_detector(args, device)
    else:
        out = profile_clip(args, device)
    if args.json:
        print(json.dumps(out), flush=True)
    return out


def profile_clip(args, device: torch.device) -> dict:
    cfg = get_model_config(args.model)
    v = cfg.vision
    out = {"model": args.model, "image": args.det_image_size}

    # the distill step
    model = create_model(cfg, device=device, dtype=torch.bfloat16, seed=args.seed,
                         grad_checkpointing=args.grad_checkpointing)
    teacher = create_model(cfg, device=device, dtype=torch.bfloat16, seed=args.seed)
    teacher.requires_grad_(False)
    optimizer = build_optimizer(
        model, make_schedule("cosine", 1e-5, 1, 1000), wd=0.1,
        unlocked_groups=v.layers, num_layers=v.layers,
    )
    state = TrainState(model, optimizer)
    step_fn = make_train_step(partial(clipself_loss, cosine_weight=1.0), teacher)
    host = SyntheticDistillData(
        batch_size=args.batch_size, det_size=args.det_image_size, crop_size=v.image_size,
        max_anns=args.max_boxes, seed=args.seed,
    ).batch
    batch = {k: torch.as_tensor(a, device=device) for k, a in host.items()}
    out["train"] = measure(lambda: step_fn(state, batch), args.steps, device, args.batch_size)
    report(
        f"{args.model} distill step, batch {args.batch_size} at {args.det_image_size}px, "
        f"{args.max_boxes} boxes, crops {v.image_size}px, {v.layers} blocks unlocked, bf16"
        + (", block recomputation" if args.grad_checkpointing else ""),
        "step", out["train"],
    )
    del state, optimizer, step_fn, teacher, batch
    model.requires_grad_(False)

    # the evaluator
    host = synthetic_panoptic_batch(
        0, batch=args.eval_batch, image_size=args.det_image_size, max_anns=args.max_anns,
        valid_anns=args.valid_anns, crop_size=v.image_size,
        mask_hw=args.det_image_size // v.patch_size, seed=args.seed,
    )
    ebatch = {k: (a if k == "boxes" else torch.as_tensor(a, device=device)) for k, a in host.items()}
    emb = class_embeddings(133, cfg.embed_dim, seed=args.seed)
    out["eval"] = measure(
        lambda: evaluate_zero_shot(model, [ebatch], emb, device=device),
        args.steps, device, args.eval_batch,
    )
    report(
        f"{args.model} zero-shot evaluator, {args.eval_batch} images a batch at "
        f"{args.det_image_size}px, {args.valid_anns} valid of {args.max_anns} anns, crops "
        f"{v.image_size}px",
        "batch", out["eval"],
    )
    return out


def profile_detector(args, device: torch.device) -> dict:
    cfg = PRESETS[args.preset]
    clip = create_model(cfg.clip_model, device=device, dtype=torch.bfloat16, seed=args.seed)
    det = create_detector(cfg, device=device, seed=args.seed + 1)
    emb = class_embeddings(cfg.num_classes + 1, cfg.embed_dim, seed=args.seed)
    emb /= (emb ** 2).sum(-1, keepdims=True) ** 0.5
    host = SyntheticDetectionData(
        cfg.num_classes, cfg.image_size, cfg.max_gt, seed=args.seed, with_mask=cfg.with_mask
    ).batch(args.det_batch)
    items = synthetic_eval_items(host)
    images = torch.as_tensor(host["images"], device=device)
    valid_hw = torch.as_tensor(host["valid_hw"], device=device)
    # the OV-COCO base / novel split where the preset has its 65 classes;
    # any other vocabulary fuses every class with the base exponent
    coco = cfg.num_classes == 65
    bm = base_novel_mask("coco") if coco else np.ones(cfg.num_classes + 1, bool)
    predict = make_predict_fn(
        det, clip, cfg, torch.as_tensor(emb, device=device), torch.as_tensor(bm, device=device)
    )
    what = (f"F-ViT {args.preset} ({cfg.clip_model}), {args.det_batch} images a batch at "
            f"{cfg.image_size}px, {cfg.test_proposals.max_per_img} proposals, bf16")
    out = {"preset": args.preset, "image": cfg.image_size}
    out["predict"] = measure(lambda: predict(images, valid_hw), args.steps, device, args.det_batch)
    report(f"{what}: predict on staged images", "batch", out["predict"])
    if coco:  # `evaluate_detector` scores with the COCO protocol
        out["evaluate"] = measure(
            lambda: evaluate_detector(det, clip, items, cfg, emb, device=device,
                                      batch_size=args.det_batch),
            args.steps, device, args.det_batch,
        )
        report(f"{what}: evaluate_detector from host items", "batch", out["evaluate"])
    return out


if __name__ == "__main__":
    main()
