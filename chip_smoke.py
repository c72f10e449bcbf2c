#!/usr/bin/env python3
"""Drive the PyTorch / H100 port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from `clipself_tpu_torch/csrc/` with the build time;
2. each kernel against its plain PyTorch version at the shapes of the
   EVA02-CLIP-B/16 evaluator (dense 1024^2 pass: 4097 tokens, batch 2; crop
   pass: 197 tokens, 50 crops), in float32 and bfloat16, with CUDA-event
   times of both;
3. the slice: `evaluate_zero_shot` of EVA02-CLIP-B/16 (seeded random
   weights, bf16) over 4 synthetic panoptic batches, with images/s, the mAcc
   dict and the kernel launch counts of that run;
4. whole-path parity of the dense map against the plain float32 path.

The second-to-last line is one JSON object with a row per kernel; the last
line is `{"ok": true, "device": {...}}`. Without a CUDA card it exits 1
before printing either.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

MODEL = "EVA02-CLIP-B-16"
BATCH, IMAGE, MAX_ANNS, VALID_ANNS, CROP, BUCKET = 2, 1024, 100, 13, 224, 25
N_BATCHES, N_CLASSES, SEED = 4, 133, 0

# Tolerances, each with its reason:
# RoPE: kernel and plain version compute the same two products in float32;
# the kernel fuses the add into an FMA, so they differ by at most one
# rounding, measured in ULPs of sum(|x_i * t_i|), the magnitude at which the
# products round (an output ULP would blow up where the two terms cancel).
ROPE_MAX_ULP = 2.0
# Attention f32: same math, other summation order and exp2 for exp.
ATTN_F32_MAX_ABS = 1e-4
# Attention bf16: the kernel rounds the probabilities to bf16 before the
# value product; plain float32 on the same (bf16-valued) inputs is the bar.
ATTN_BF16_MIN_COS = 0.9999
# Whole path: f32 kernels vs f32 plain differ by summation order only.
PATH_F32_MAX_ABS = 1e-4
# Whole path bf16 vs f32: the bar of PARITY_CHIP.md for the JAX tower's
# bf16 chip path against float32.
PATH_BF16_MIN_COS = 0.9996


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def min_row_cos(a, b) -> float:
    import torch

    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def ulp(t, dtype):
    """Spacing of ``dtype`` at |t| (t float32; zeros get the smallest normal)."""
    import torch

    mant = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    tiny = torch.finfo(dtype).tiny
    mag = torch.clamp(t.abs(), min=tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


def phase_kernels(torch, dev, results):
    from clipself_tpu_torch.models.rope import rope_tables
    from clipself_tpu_torch.ops import attention, rope_roll

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    # RoPE, with the tables of the model's grids (64x64 dense, 14x14 crops)
    for (b, n, w), grid in (((BATCH, 4097, 768), 64), ((BATCH * BUCKET, 197, 768), 14)):
        tables = rope_tables(grid, grid, 64, 1, 16, dev)
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, n, w, generator=gen).to(dev, dt)
            got = rope_roll.rolled_rope(x, *tables).float()
            want = rope_roll.rolled_rope_plain(x, *tables).float()
            mag = rope_roll.rolled_rope_plain(x.float().abs(), *(t.abs() for t in tables))
            err_ulp = ((got - want).abs() / ulp(mag, dt)).max().item()
            max_abs = (got - want).abs().max().item()
            ms = cuda_ms(lambda: rope_roll.rolled_rope(x, *tables))
            plain_ms = cuda_ms(lambda: rope_roll.rolled_rope_plain(x, *tables))
            print(
                f"kernel rope_roll [{b},{n},{w}] {str(dt)[6:]}: max_abs {max_abs:.3e} "
                f"max_ulp {err_ulp:.2f} (bar {ROPE_MAX_ULP}) ms {ms:.4f} plain_ms {plain_ms:.4f}",
                flush=True,
            )
            if not err_ulp <= ROPE_MAX_ULP:
                fail(f"rope_roll {dt} [{b},{n},{w}] off by {err_ulp} ULP")
            if dt == torch.bfloat16 and n == 4097:
                results["rope_roll"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    # attention on [B, N, H, D] per-head views of the [B, N, W] projections
    for b, n in ((BATCH, 4097), (BATCH * BUCKET, 197)):
        scale = 64 ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (
                torch.randn(b, n, 768, generator=gen).to(dev, dt).view(b, n, 12, 64)
                for _ in range(3)
            )
            got = attention.flash_attention(q, k, v, scale).float()
            want = attention.attention_plain(q.float(), k.float(), v.float(), scale)
            max_abs = (got - want).abs().max().item()
            cos = min_row_cos(got, want)
            ms = cuda_ms(lambda: attention.flash_attention(q, k, v, scale), iters=10)
            plain_ms = cuda_ms(lambda: attention.attention_plain(q, k, v, scale), iters=10)
            print(
                f"kernel flash_attention [{b},{n},12,64] {str(dt)[6:]}: max_abs {max_abs:.3e} "
                f"min_row_cos {cos:.7f} ms {ms:.4f} plain_ms {plain_ms:.4f}",
                flush=True,
            )
            if dt == torch.float32 and not max_abs <= ATTN_F32_MAX_ABS:
                fail(f"flash_attention f32 [{b},{n}] max abs {max_abs}")
            if dt == torch.bfloat16 and not cos >= ATTN_BF16_MIN_COS:
                fail(f"flash_attention bf16 [{b},{n}] min row cosine {cos}")
            if dt == torch.bfloat16 and n == 4097:
                results["flash_attention"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)


def phase_slice(torch, dev):
    import numpy as np

    from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.ops import attention, rope_roll

    model = create_model(MODEL, device=dev, dtype=torch.bfloat16, seed=SEED)
    cfg = model.cfg
    mask_hw = IMAGE // cfg.vision.patch_size

    def batch(i):
        # staged on the card, as the JAX evaluator bench stages them
        host = synthetic_panoptic_batch(
            i, batch=BATCH, image_size=IMAGE, max_anns=MAX_ANNS, valid_anns=VALID_ANNS,
            crop_size=CROP, mask_hw=mask_hw, n_classes=N_CLASSES, seed=SEED,
        )
        return {k: (v if k == "boxes" else torch.as_tensor(v, device=dev)) for k, v in host.items()}

    warm = batch(N_BATCHES)
    batches = [batch(i) for i in range(N_BATCHES)]
    emb = class_embeddings(N_CLASSES, cfg.embed_dim, seed=SEED)
    evaluate_zero_shot(model, [warm], emb, device=dev, ann_bucket=BUCKET)  # warm-up
    torch.cuda.synchronize()

    for counter in (attention.LAUNCHES, rope_roll.LAUNCHES):
        counter.reset()
    t0 = time.perf_counter()
    res = evaluate_zero_shot(model, batches, emb, device=dev, ann_bucket=BUCKET)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_attention": attention.LAUNCHES.count, "rope_roll": rope_roll.LAUNCHES.count}

    ips = BATCH * N_BATCHES / dt
    print(
        f"slice {MODEL} zero-shot eval: {N_BATCHES} batches x {BATCH} images {IMAGE}px, "
        f"{VALID_ANNS} valid of {MAX_ANNS} anns (bucket {BUCKET}), crops {CROP}px: "
        f"{dt:.3f} s, {ips:.3f} images/s",
        flush=True,
    )
    print("slice mAcc " + json.dumps(res, sort_keys=True), flush=True)
    print("slice launches " + json.dumps(launches), flush=True)
    if not res or not all(np.isfinite(v) for v in res.values()):
        fail(f"evaluator result not finite: {res}")
    # per batch: the dense pass runs 11 attention blocks (the last block
    # takes the value path), the crop pass all 12, crops in one call; two
    # RoPE launches (q and k) per attention block
    per_batch = (cfg.vision.layers - 1) + cfg.vision.layers
    expect = {"flash_attention": N_BATCHES * per_batch, "rope_roll": 2 * N_BATCHES * per_batch}
    if launches != expect:
        fail(f"launch counts {launches}, expected {expect}")
    return model, batches[0], launches


def phase_parity(torch, dev, model_bf16, batch):
    from clipself_tpu_torch.models import eva_vit, rope
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.ops.attention import attention_plain
    from clipself_tpu_torch.ops.rope_roll import rolled_rope_plain

    images = batch["images"]
    model_f32 = create_model(MODEL, device=dev, dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        dense_k32 = model_f32.encode_dense(images, keep_shape=True)
        dense_k16 = model_bf16.encode_dense(images, keep_shape=True)
        # the plain path: the same model with the kernels' plain versions
        # swapped in where the tower calls the kernel wrappers
        saved = eva_vit.multi_head_attention, rope.rolled_rope
        eva_vit.multi_head_attention, rope.rolled_rope = attention_plain, rolled_rope_plain
        try:
            dense_p32 = model_f32.encode_dense(images, keep_shape=True)
        finally:
            eva_vit.multi_head_attention, rope.rolled_rope = saved
    torch.cuda.synchronize()
    f32_abs = (dense_k32 - dense_p32).abs().max().item()
    f32_cos = min_row_cos(dense_k32, dense_p32)
    bf16_abs = (dense_k16.float() - dense_p32).abs().max().item()
    bf16_cos = min_row_cos(dense_k16, dense_p32)
    shape = list(dense_p32.shape)
    print(
        f"parity dense map {shape} f32 kernels vs f32 plain: max_abs {f32_abs:.3e} "
        f"min_row_cos {f32_cos:.7f} (bar max_abs {PATH_F32_MAX_ABS})",
        flush=True,
    )
    print(
        f"parity dense map {shape} bf16 kernels vs f32 plain: max_abs {bf16_abs:.3e} "
        f"min_row_cos {bf16_cos:.7f} (bar min_row_cos {PATH_BF16_MIN_COS})",
        flush=True,
    )
    for t in (dense_k32, dense_k16, dense_p32):
        if not torch.isfinite(t).all():
            fail("non-finite dense map")
    if not f32_abs <= PATH_F32_MAX_ABS:
        fail(f"f32 kernel path off the plain path by {f32_abs}")
    if not bf16_cos >= PATH_BF16_MIN_COS:
        fail(f"bf16 kernel path min row cosine {bf16_cos}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from clipself_tpu_torch.ops import _build

    # full float32 for every float32 product and convolution of the run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    built = _build.LIBRARY.build_seconds
    print(
        f"build: kernels from clipself_tpu_torch/csrc ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'%.2f s' % built if built is not None else 'skipped, cached'})",
        flush=True,
    )

    results = {}
    phase_kernels(torch, dev, results)
    model_bf16, batch0, launches = phase_slice(torch, dev)
    phase_parity(torch, dev, model_bf16, batch0)

    rows = {
        "rope_roll": ("clipself_tpu_torch/csrc/rope_roll.cu", "clipself_tpu/ops/rope_roll.py:105"),
        "flash_attention": (
            "clipself_tpu_torch/csrc/flash_attention.cu",
            "clipself_tpu/ops/attention.py:288",
        ),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in rows.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
