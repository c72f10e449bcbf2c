#!/usr/bin/env python3
"""Drive the PyTorch / H100 port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from `clipself_tpu_torch/csrc/` with the build time;
2. each kernel against its plain PyTorch version at the shapes the two
   models give it (EVA02-CLIP-B/16 at 1024^2: 4097 and 197 tokens, 12 heads,
   widths 768 and 2048; EVA02-CLIP-L-14-336 at 896^2: 4097 and 577 tokens,
   16 heads, widths 1024 and 2730), in float32 and bfloat16: the RoPE
   forward and backward, the flash-attention forward with and without its
   LSE (also at the detector's [8, 1601, 12, 64]), the flash backward (each
   row says which of the kernel's designs its shape and type took: "wgmma"
   for bfloat16 at head_dim 64, "fma" for float32), and the fused LayerNorm
   forward (with and
   without statistics) and backward, also on the two strided views of the
   final norm. Each with CUDA-event times of the kernel, of its plain
   version and, where one PyTorch call computes the same function
   (`scaled_dot_product_attention` and autograd of it, `F.layer_norm` and
   `aten.native_layer_norm_backward`), of that call (the RoPE and LayerNorm
   launches replayed from a CUDA graph, so that the host's launch pace does
   not hide their ten-microsecond times), and with
   the least time the card could take (bytes moved once over 3.35 TB/s, or
   operations over the peak rate of their type); then the greedy-NMS kernel
   against its plain version, masks equal flag for flag, at the detector's
   shapes ([8, 2000] RPN candidates at IoU 0.7, class-offset candidates at
   0.4, one image, an invalid tail) and at the edge cases (one box, no valid
   box, identical boxes, zero-area boxes, duplicates, a negative threshold);
then for each model, B/16 first:
3. the evaluator: `evaluate_zero_shot` (seeded random weights, bf16) over 4
   synthetic panoptic batches, with images/s, the mAcc dict and the kernel
   launch counts of that run;
4. whole-path parity of the dense map against the plain float32 path;
5. the trainer: `clipself_tpu_torch.train.main`, bf16, synthetic data, batch
   2, 20 boxes, teacher crops at the model's own size, every block unlocked:
   1 warm-up step and 5 timed steps, with images/s, the per-step losses,
   peak device memory and the launch counts of the run; for L/14 then 2
   steps with `--grad-checkpointing`;
6. train parity: one step's loss and trainable gradients at batch 1 on f32
   kernels, bf16 kernels and the f32 plain path (L/14: at full width and a
   depth of 6 blocks, since the plain path keeps every block's
   [1, 16, 4097, 4097] float32 attention maps for its backward);
then the F-ViT detector, preset `ov_coco_vitb16` (EVA02-CLIP-B/16 backbone at
640^2, 102300 anchors, 1000 proposals, 65 classes), full width and depth:
7. `evaluate_detector` (seeded random CLIP and detector weights, bf16, random
   unit-norm class embeddings) over two batches of 8 synthetic images after a
   warm-up batch, with images/s, peak memory, the metrics and the launch
   counts of that run;
8. detector parity on two images: the bf16 kernel path against the plain
   float32 path on the backbone taps, the dense VLM map, the RPN objectness
   maps and the bbox head's logits and deltas on 32 fixed rois; the float32
   kernel path against the float32 plain path on the same tensors and on the
   detections; and, on the same float32 taps, `predict` with the NMS kernel
   against `predict` with the plain NMS: proposals and detections equal bit
   for bit.

The second-to-last line is one JSON object with a row per kernel; the last
line is `{"ok": true, "device": {...}}`. Without a CUDA card it exits 1
before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

MAX_ANNS, VALID_ANNS, BUCKET = 100, 13, 25
N_BATCHES, N_CLASSES, SEED = 4, 133, 0
# trainer: 1 warm-up step, then 5 timed steps; 2 steps when recomputing
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_BOXES, RECOMPUTE_STEPS = 2, 1, 5, 20, 2


@dataclasses.dataclass(frozen=True)
class Model:
    """One model at the image size and evaluator batch of its recipe."""

    key: str
    model: str
    image: int
    eval_batch: int
    parity_layers: int | None = None  # depth of the train-parity phase; None: all

    @property
    def vision(self):
        from clipself_tpu_torch.core.config import get_model_config

        return get_model_config(self.model).vision

    @property
    def heads(self) -> int:
        return self.vision.width // self.vision.head_width

    @property
    def hidden(self) -> int:
        return int(self.vision.width * self.vision.mlp_ratio)

    @property
    def crop(self) -> int:
        return self.vision.image_size

    def grid(self, size: int) -> int:
        return size // self.vision.patch_size

    def tokens(self, size: int) -> int:
        return 1 + self.grid(size) ** 2


MODELS = (
    Model("b16", "EVA02-CLIP-B-16", image=1024, eval_batch=2),
    Model("l14", "EVA02-CLIP-L-14-336", image=896, eval_batch=1, parity_layers=6),
)

# the detector phase: preset, images a batch (the reference's 8 a GPU), timed
# batches, images of the parity phase, fixed rois of its head rows
DET_PRESET, DET_BATCH, DET_BATCHES, DET_PARITY_IMAGES, DET_FIXED_ROIS = "ov_coco_vitb16", 8, 2, 2, 32

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory, dense bf16 tensor cores, float32 outside the tensor cores.
PEAK_BYTES_S, PEAK_BF16_FLOPS, PEAK_F32_FLOPS = 3.35e12, 989e12, 67e12

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
# LSE: a sum of f32 exponentials in another order, values of ~log(N) ~ 8.
LSE_MAX_ABS = 1e-4
# Flash backward f32: up to N = 4097 products per entry summed in another
# order, dQ through f32 atomics in a run-dependent order; relative to the
# largest gradient entry, since the gradients' scale depends on the inputs.
BWD_F32_MAX_REL = 1e-4
# Flash backward bf16: P and dS are rounded to bf16 before their products.
BWD_BF16_MIN_COS = 0.999
# LayerNorm y and dx: kernel and plain version compute the same float32
# formulas; only the order of the row sums differs (and an FMA where the
# plain version rounds twice). Measured in float32 ULPs of the magnitude at
# which the terms round: (|x| + mean|x|) * rstd * |w| + |b| for y,
# rstd * (|g| + mean|g| + |xhat| * mean|g * xhat|) for dx (an ULP of the
# result would blow up where the terms cancel). bfloat16 rounds that float32
# value once on both sides, so a result may also land on the neighbouring
# bfloat16: one bfloat16 ULP of the plain result is allowed on top. The first
# run on an H100 measured at most 5 ULP (float32 forward at width 2730).
LN_MAX_ULP = 8.0
# LayerNorm dweight, dbias: float32 sums over all rows (8194 or 23080) in
# another order, relative to their largest entry.
LN_SUM_MAX_REL = 1e-5
# Train parity, one step at batch 1: f32 kernels vs f32 plain differ by
# summation order only; bf16 kernels vs f32 plain by bf16 rounding through
# the blocks and their backward. Tightened from 1e-3 and 0.99 after the
# first run on an H100 measured a max relative gradient error of 2.6e-6
# and a min gradient cosine of 0.99976 on B/16.
STEP_LOSS_MAX_ABS = 1e-5
STEP_GRAD_F32_MAX_REL = 1e-4
STEP_GRAD_BF16_MIN_COS = 0.999
# Recomputation: the first step's loss comes from the same forward kernels
# on the same weights and batch, with or without it.
RECOMPUTE_LOSS_MAX_ABS = 1e-5
# NMS: the keep mask is discrete; the kernel's arithmetic is pinned to the
# plain version's single rounded operations, so no flag may differ.
# Detector, bf16 kernels vs f32 plain: the dense VLM map keeps the bar of
# PARITY_CHIP.md; the other rows of its "fvit_detector_predict" table (taps,
# RPN maps, bbox-head logits and deltas on fixed rois) are reported, with a
# floor that only a broken path falls below: the first run on an H100
# measured 0.99984 (taps), 0.99957 (RPN maps), 0.99973 (logits) and 0.99905
# (deltas, rows of four small values).
DET_BF16_MIN_COS_FLOOR = 0.998
# Detector, f32 kernels vs f32 plain: the towers differ by summation order
# (1e-4 on the dense map, as above); taps are unnormalised values of order
# 10 and the heads stack convolutions on them: 1e-3 (the first run measured
# 4.3e-5 on the taps and 2.5e-5 on the logits).
DET_F32_MAX_ABS = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _counters():
    from clipself_tpu_torch.ops import attention, layer_norm, nms, rope_roll

    return {
        "nms": nms.LAUNCHES,
        "flash_attention": attention.LAUNCHES,
        "flash_attention_bwd": attention.BWD_LAUNCHES,
        "rope_roll": rope_roll.LAUNCHES,
        "rope_roll_bwd": rope_roll.BWD_LAUNCHES,
        "layer_norm": layer_norm.LAUNCHES,
        "layer_norm_bwd": layer_norm.BWD_LAUNCHES,
    }


def reset_counts() -> None:
    for counter in _counters().values():
        counter.reset()


def read_counts() -> dict:
    return {name: counter.count for name, counter in _counters().items()}


def expected_launches(
    layers: int, *, evals: int = 0, steps: int = 0, recompute: bool = False, dets: int = 0
) -> dict:
    """Launches of ``evals`` evaluator batches plus ``steps`` train steps
    plus ``dets`` detector batches of a tower of ``layers`` blocks. A dense pass runs layers - 1 attention
    blocks (the last block takes the value path), a crop pass all of them;
    RoPE runs twice (q and k) per attention block; every block has four
    LayerNorms and the tower a final one. An evaluator batch is one dense and
    one crop pass; a train step is the teacher's crop pass, the student's
    dense pass and its backward; with recomputation the student's blocks
    (not its final norm) run their forward once more. A detector batch is
    one dense pass (the taps) and two NMS launches, all images at once: the
    RPN's proposals and the final class-wise NMS."""
    dense, crop, norms = layers - 1, layers, 4 * layers + 1
    again = steps if recompute else 0
    flash = evals * (dense + crop) + steps * (crop + dense) + again * dense + dets * dense
    return {
        "nms": 2 * dets,
        "flash_attention": flash,
        "flash_attention_bwd": steps * dense,
        "rope_roll": 2 * flash,
        "rope_roll_bwd": 2 * steps * dense,
        "layer_norm": (2 * evals + 2 * steps + dets) * norms + again * 4 * layers,
        "layer_norm_bwd": steps * norms,
    }


@contextlib.contextmanager
def plain_path():
    """Swap the kernels' plain versions in where the tower calls the kernel
    wrappers (`eva_vit.multi_head_attention`, `eva_vit.layer_norm`,
    `rope.rolled_rope`, the detector's `nms.nms_keep_mask`); autograd
    differentiates them. Fails if any kernel
    launched inside, so a swap that misses a call site cannot compare the
    kernels with themselves."""
    from clipself_tpu_torch.models import eva_vit, rope
    from clipself_tpu_torch.ops.attention import attention_plain
    from clipself_tpu_torch.ops.layer_norm import layer_norm_plain
    from clipself_tpu_torch.ops.rope_roll import rolled_rope_plain

    def rope_plain(x, cos, sin_a, sin_b, a_bwd, b_bwd):
        return rolled_rope_plain(x, cos, sin_a, sin_b)

    saved = eva_vit.multi_head_attention, eva_vit.layer_norm, rope.rolled_rope
    eva_vit.multi_head_attention, eva_vit.layer_norm, rope.rolled_rope = (
        attention_plain, layer_norm_plain, rope_plain
    )
    reset_counts()
    try:
        with plain_nms():
            yield
    finally:
        eva_vit.multi_head_attention, eva_vit.layer_norm, rope.rolled_rope = saved
    if any(read_counts().values()):
        fail(f"the plain path launched kernels: {read_counts()}")


@contextlib.contextmanager
def plain_nms():
    """Swap the plain NMS in where `detector/nms.py` calls the kernel's
    wrapper; fails if the NMS kernel launched inside."""
    from clipself_tpu_torch.detector import nms as det_nms
    from clipself_tpu_torch.ops import nms as ops_nms

    saved, before = det_nms.nms_keep_mask, ops_nms.LAUNCHES.count
    det_nms.nms_keep_mask = ops_nms.nms_keep_mask_plain
    try:
        yield
    finally:
        det_nms.nms_keep_mask = saved
    if ops_nms.LAUNCHES.count != before:
        fail("the plain NMS path launched the NMS kernel")


def cuda_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean device time of one ``fn()`` between two CUDA events. With
    ``graph`` the ``iters`` calls are captured into one CUDA graph and
    replayed: a kernel of some ten microseconds is otherwise timed at the
    pace of the host's launches, not at its own."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = 1
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(iters):
                fn()
        captured.replay()
        torch.cuda.synchronize()
        reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        if graph:
            captured.replay()
        else:
            for _ in range(iters):
                fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Records:
    """Per kernel, one record for each shape and type it was checked at:
    error, kernel / plain / library times and the card's bound."""

    def __init__(self):
        self.rows: dict[str, list[dict]] = {}

    def add(self, name, what, shape, dtype, *, err, ms, plain_ms, library_ms, moved, flops,
            note="", design=None):
        """``moved``: bytes of every input read once and every output written
        once; ``flops``: operations on these inputs; ``design``: which of a
        kernel's hand-written designs the shape and type took."""
        import torch

        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        by_bytes, by_ops = moved / PEAK_BYTES_S * 1e3, flops / peak * 1e3
        rec = dict(
            what=what, shape=list(shape), dtype=str(dtype)[6:], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=library_ms,
        )
        if design is not None:
            rec["design"] = design
            note += f"design {design} "
        self.rows.setdefault(name, []).append(rec)
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        print(
            f"kernel {name} {what} {list(shape)} {rec['dtype']}: max_abs {err:.3e} {note}"
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
            f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})",
            flush=True,
        )

    def primary(self, name: str, what: str, shape, dtype: str = "bfloat16") -> dict:
        """The record of one shape (bfloat16 unless told): the row's own numbers."""
        for rec in self.rows[name]:
            if (rec["what"], rec["shape"], rec["dtype"]) == (what, list(shape), dtype):
                return rec
        fail(f"no {dtype} record of {name} {what} at {list(shape)}")


def check_rope(torch, dev, records, gen, shape, grid, head_dim, backward):
    from clipself_tpu_torch.models.rope import rope_tables, rope_tables_bwd
    from clipself_tpu_torch.ops import rope_roll

    b, n, w = shape
    tables = rope_tables(grid, grid, head_dim, 1, 16, dev)
    a_bwd, b_bwd = rope_tables_bwd(grid, grid, head_dim, 1, 16, dev)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(b, n, w, generator=gen).to(dev, dt)
        # y = x*cos + roll*sin_a + roll*sin_b: five operations an element
        cost = dict(moved=2 * nbytes(x) + nbytes(*tables), flops=5 * x.numel(), library_ms=None)
        got = rope_roll.rolled_rope_fwd(x, *tables).float()
        want = rope_roll.rolled_rope_plain(x, *tables).float()
        mag = rope_roll.rolled_rope_plain(x.float().abs(), *(t.abs() for t in tables))
        err_ulp = ((got - want).abs() / ulp(mag, dt)).max().item()
        records.add(
            "rope_roll", "forward", shape, dt, err=(got - want).abs().max().item(),
            ms=cuda_ms(lambda: rope_roll.rolled_rope_fwd(x, *tables), graph=True),
            plain_ms=cuda_ms(lambda: rope_roll.rolled_rope_plain(x, *tables), graph=True),
            note=f"max_ulp {err_ulp:.2f} (bar {ROPE_MAX_ULP}) ", **cost,
        )
        if not err_ulp <= ROPE_MAX_ULP:
            fail(f"rope_roll {dt} {shape} off by {err_ulp} ULP")
        if not backward:
            continue
        # the backward: the same kernel on dy with the rolled tables,
        # against autograd of the plain forward; the plain backward's
        # time is the same composition in plain PyTorch
        dy = torch.randn(b, n, w, generator=gen).to(dev, dt)
        got = rope_roll.rolled_rope_bwd(dy, tables[0], a_bwd, b_bwd).float()
        xr = torch.zeros(b, n, w, device=dev, dtype=dt, requires_grad=True)
        (want,) = torch.autograd.grad(rope_roll.rolled_rope_plain(xr, *tables), xr, dy)
        want = want.float()
        mag = rope_roll.rolled_rope_plain(
            dy.float().abs(), tables[0].abs(), b_bwd.abs(), a_bwd.abs()
        )
        err_ulp = ((got - want).abs() / ulp(mag, dt)).max().item()
        records.add(
            "rope_roll", "backward", shape, dt, err=(got - want).abs().max().item(),
            ms=cuda_ms(lambda: rope_roll.rolled_rope_bwd(dy, tables[0], a_bwd, b_bwd), graph=True),
            plain_ms=cuda_ms(lambda: rope_roll.rolled_rope_plain(dy, tables[0], b_bwd, a_bwd), graph=True),
            note=f"max_ulp {err_ulp:.2f} (bar {ROPE_MAX_ULP}) ", **cost,
        )
        if not err_ulp <= ROPE_MAX_ULP:
            fail(f"rope_roll backward {dt} {shape} off by {err_ulp} ULP")


def sdpa(torch, q, k, v, scale):
    """The library's attention on the same [B, N, H, D] tensors."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale
    )
    return out.transpose(1, 2)


def check_attention(torch, dev, records, gen, shape, train):
    """The forward on [B, N, H, D] per-head views of [B, N, W] projections;
    with ``train`` also the forward with its LSE and the one-pass backward
    (plain float32 on the bf16-valued inputs is the bar for bf16)."""
    from clipself_tpu_torch.ops import attention

    b, n, h, d = shape
    scale = d ** -0.5
    flops = 4 * b * h * n * n * d  # the two products Q K^T and P V
    for dt in (torch.float32, torch.bfloat16):
        iters = 5 if dt == torch.float32 else 10
        q, k, v = (
            torch.randn(b, n, h * d, generator=gen).to(dev, dt).view(b, n, h, d) for _ in range(3)
        )
        got = attention.flash_attention_fwd(q, k, v, scale).float()
        f = [t.float() for t in (q, k, v)]
        want = attention.attention_plain(*f, scale)
        max_abs = (got - want).abs().max().item()
        cos = min_row_cos(got, want)
        del got, want
        records.add(
            "flash_attention", "forward", shape, dt, err=max_abs,
            ms=cuda_ms(lambda: attention.flash_attention_fwd(q, k, v, scale), iters),
            plain_ms=cuda_ms(lambda: attention.attention_plain(q, k, v, scale), iters),
            library_ms=cuda_ms(lambda: sdpa(torch, q, k, v, scale), iters),
            moved=4 * nbytes(q), flops=flops, note=f"min_row_cos {cos:.7f} ",
            design=attention.kernel_design(dt, d),
        )
        if dt == torch.float32 and not max_abs <= ATTN_F32_MAX_ABS:
            fail(f"flash_attention f32 {shape} max abs {max_abs}")
        if dt == torch.bfloat16 and not cos >= ATTN_BF16_MIN_COS:
            fail(f"flash_attention bf16 {shape} min row cosine {cos}")
        if not train:
            continue
        out, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
        out32, lse32 = attention.attention_lse_plain(*f, scale)
        lse_err = (lse - lse32).abs().max().item()
        records.add(
            "flash_attention", "forward with lse", shape, dt, err=lse_err,
            ms=cuda_ms(lambda: attention.flash_attention_fwd(q, k, v, scale, return_lse=True), iters),
            plain_ms=cuda_ms(lambda: attention.attention_lse_plain(q, k, v, scale), iters),
            library_ms=None, moved=4 * nbytes(q) + nbytes(lse), flops=flops,
            note=f"(of the lse, bar {LSE_MAX_ABS}) ", design=attention.kernel_design(dt, d),
        )
        if not lse_err <= LSE_MAX_ABS:
            fail(f"flash_attention lse {dt} {shape} max abs {lse_err}")
        do = torch.randn(q.shape, generator=gen).to(dev, dt)
        got = attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
        want = attention.attention_bwd_plain(*f, out32, lse32, do.float(), scale)
        del out32, lse32
        errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        rel = max(e / w.abs().max().item() for e, w in zip(errs, want))
        coss = [min_row_cos(g, w) for g, w in zip(got, want)]
        finite = all(torch.isfinite(g).all().item() for g in got)
        del got, want, f
        # the library's backward alone: autograd of its forward, kept graph
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = sdpa(torch, *leaves, scale)
        records.add(
            "flash_attention_bwd", "backward", shape, dt, err=max(errs),
            ms=cuda_ms(lambda: attention.flash_attention_bwd(q, k, v, out, lse, do, scale), iters),
            plain_ms=cuda_ms(lambda: attention.attention_bwd_plain(q, k, v, out, lse, do, scale), 5),
            library_ms=cuda_ms(
                lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), iters
            ),
            # q, k, v, out, dO and the lse read, dq, dk, dv written; five
            # products (S, dP, dV, dK, dQ)
            moved=8 * nbytes(q) + nbytes(lse), flops=flops * 5 // 2,
            note=f"rel {rel:.3e} min_row_cos {min(coss):.6f} ",
            design=attention.kernel_design(dt, d, backward=True),
        )
        del lib_out, leaves
        if not finite:
            fail(f"flash_attention_bwd {dt} {shape}: non-finite gradient")
        if dt == torch.float32 and not rel <= BWD_F32_MAX_REL:
            fail(f"flash_attention_bwd f32 {shape} relative error {rel} (bar {BWD_F32_MAX_REL})")
        if dt == torch.bfloat16 and not min(coss) >= BWD_BF16_MIN_COS:
            fail(f"flash_attention_bwd bf16 {shape} min row cosine {min(coss)}")


# the views of a [B, N, W] tensor that the tower's LayerNorms see
LN_VIEWS = {
    "": lambda t: t,
    " rows 1: of": lambda t: t[:, 1:],  # the dense pass's final norm
    " row 0 of": lambda t: t[:, 0],     # the CLS pass's final norm
}


def check_layer_norm(torch, dev, records, gen, shape, view, backward):
    from clipself_tpu_torch.ops import layer_norm as ln

    eps, w = 1e-6, shape[-1]
    for dt in (torch.float32, torch.bfloat16):
        x = LN_VIEWS[view]((torch.randn(shape, generator=gen) * 3 + 0.5).to(dev, dt))
        dy = LN_VIEWS[view](torch.randn(shape, generator=gen).to(dev, dt)).contiguous()
        weight = (torch.randn(w, generator=gen) * 0.2 + 1.0).to(dev)
        bias = (torch.randn(w, generator=gen) * 0.1).to(dev)
        # the library call takes the affine in x's type
        lib_w, lib_b = weight.to(dt), bias.to(dt)
        what = f"{view} {list(shape)}:" if view else ""

        def err_ulps(got, want, mag):
            diff = (got.float() - want.float()).abs()
            if dt == torch.bfloat16:
                diff = torch.clamp(diff - ulp(want.float(), dt), min=0.0)
            return (diff / ulp(mag, torch.float32)).max().item()

        want, mu, rstd = ln.layer_norm_stats_plain(x, weight, bias, eps)
        xf = x.float()
        mag = (xf.abs() + xf.abs().mean(-1, keepdim=True)) * (rstd[..., None] * weight.abs())
        mag = mag + bias.abs()
        for stats in (False, True):
            out = ln.layer_norm_fwd(x, weight, bias, eps, return_stats=stats)
            got = out[0] if stats else out
            err = err_ulps(got, want, mag)
            if stats:
                stat_err = max(
                    ((out[1] - mu).abs() / ulp(xf.abs().mean(-1), torch.float32)).max().item(),
                    ((out[2] - rstd).abs() / ulp(rstd, torch.float32)).max().item(),
                )
                err = max(err, stat_err)
            records.add(
                "layer_norm", f"forward{' with stats' if stats else ''}{what}", x.shape, dt,
                err=(got.float() - want.float()).abs().max().item(),
                ms=cuda_ms(lambda: ln.layer_norm_fwd(x, weight, bias, eps, return_stats=stats), graph=True),
                plain_ms=cuda_ms(lambda: ln.layer_norm_plain(x, weight, bias, eps), graph=True),
                library_ms=cuda_ms(
                    lambda: torch.nn.functional.layer_norm(x, (w,), lib_w, lib_b, eps), graph=True
                ),
                # x read, y written, the affine read, the statistics written
                moved=2 * nbytes(x) + nbytes(weight, bias) + (nbytes(mu, rstd) if stats else 0),
                flops=8 * x.numel(), note=f"max_ulp {err:.2f} (bar {LN_MAX_ULP}) ",
            )
            if not err <= LN_MAX_ULP:
                fail(f"layer_norm {dt} {what} {tuple(x.shape)} stats={stats} off by {err} ULP")
        if not backward:
            continue
        # both sides take the kernel forward's statistics
        _, mu, rstd = ln.layer_norm_fwd(x, weight, bias, eps, return_stats=True)
        got = ln.layer_norm_bwd(x, dy, mu, rstd, weight)
        want = ln.layer_norm_bwd_plain(x, dy, mu, rstd, weight)
        g = dy.float() * weight
        xhat = (xf - mu[..., None]) * rstd[..., None]
        mag = rstd[..., None] * (
            g.abs() + g.abs().mean(-1, keepdim=True)
            + xhat.abs() * (g * xhat).abs().mean(-1, keepdim=True)
        )
        err = err_ulps(got[0], want[0], mag)
        sum_rel = max(
            ((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got[1:], want[1:])
        )
        # the library's backward as one call, on its own forward's statistics
        _, lib_mean, lib_rstd = torch.ops.aten.native_layer_norm(x, [w], lib_w, lib_b, eps)
        records.add(
            "layer_norm_bwd", f"backward{what}", x.shape, dt,
            err=(got[0].float() - want[0].float()).abs().max().item(),
            ms=cuda_ms(lambda: ln.layer_norm_bwd(x, dy, mu, rstd, weight), graph=True),
            plain_ms=cuda_ms(lambda: ln.layer_norm_bwd_plain(x, dy, mu, rstd, weight), graph=True),
            library_ms=cuda_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [w], lib_mean, lib_rstd, lib_w, lib_b, [True, True, True]
                ),
                graph=True,
            ),
            # x, dy, the statistics and the weight read; dx, dweight, dbias
            # written (the per-block partial sums are scratch, not counted)
            moved=3 * nbytes(x) + nbytes(mu, rstd) + 3 * nbytes(weight),
            flops=14 * x.numel(),
            note=f"max_ulp {err:.2f} (bar {LN_MAX_ULP}) sums rel {sum_rel:.3e} (bar {LN_SUM_MAX_REL}) ",
        )
        if not err <= LN_MAX_ULP:
            fail(f"layer_norm_bwd {dt} {what} {tuple(x.shape)} dx off by {err} ULP")
        if not sum_rel <= LN_SUM_MAX_REL:
            fail(f"layer_norm_bwd {dt} {what} {tuple(x.shape)} dweight/dbias off by {sum_rel}")


# (kind, images, boxes, IoU threshold, timed): the detector's own shapes
# first (RPN candidates, final class-wise NMS, one image), then edge cases
NMS_CASES = (
    ("anchors", 8, 2000, 0.7, True), ("class_offset", 8, 2000, 0.4, True),
    ("anchors", 1, 2000, 0.7, True), ("invalid_tail", 8, 1999, 0.7, False),
    ("plain", 2, 1, 0.5, False), ("none_valid", 2, 300, 0.5, False),
    ("identical", 2, 300, 0.5, False), ("zero_area", 2, 515, 0.5, False),
    ("duplicates", 2, 300, 0.4, False),
    # below zero even disjoint pairs suppress: the kernel's shortcut for empty
    # intersections must be off
    ("plain", 2, 300, -0.5, False),
)


def check_nms(torch, dev, records):
    """The kernel's keep mask against the plain version's, flag for flag."""
    from clipself_tpu_torch.detector.data import synthetic_nms_case
    from clipself_tpu_torch.ops import nms

    for seed, (kind, b, n, thr, timed) in enumerate(NMS_CASES):
        boxes, valid = (t.to(dev) for t in synthetic_nms_case(kind, b, n, seed))
        got = nms.nms_keep_mask(boxes, valid, thr)
        torch.cuda.synchronize()
        want = nms.nms_keep_mask_plain(boxes, valid, thr)
        differ = (got != want).sum().item()
        kept = got.sum(dim=1)
        what = f"keep mask {kind} thr {thr}"
        if not timed:
            print(
                f"kernel nms {what} [{b}, {n}, 4]: {differ} flags differ, kept {kept.tolist()}",
                flush=True,
            )
        else:
            # what this data needs: each kept box against every later box,
            # ~14 float operations an IoU and its test; boxes and validity
            # read once, the mask written once
            ranks = torch.arange(n, device=dev)
            ious = ((n - 1 - ranks) * got).sum().item()
            records.add(
                "nms", what, boxes.shape, torch.float32, err=float(differ),
                ms=cuda_ms(lambda: nms.nms_keep_mask(boxes, valid, thr)),
                plain_ms=cuda_ms(lambda: nms.nms_keep_mask_plain(boxes, valid, thr), iters=2, warmup=1),
                library_ms=None, moved=nbytes(boxes, valid, got), flops=14 * ious,
                note=f"(flags that differ) kept {kept.tolist()}, dependent chain "
                f"{kept.max().item()} kept boxes (one barrier each) ",
            )
        if differ:
            fail(f"nms {what} [{b}, {n}]: {differ} flags differ from the plain version")
        if got[~valid].any():
            fail(f"nms {what}: an invalid slot was kept")


def phase_kernels(torch, dev, records):
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    for s in MODELS:
        v = s.vision
        student = (TRAIN_BATCH, s.tokens(s.image), v.width)
        # the crop pass: the evaluator's bucket of crops for B/16 (as the
        # earlier runs), the teacher's 40 crops for L/14
        n_crops = 2 * BUCKET if s.key == "b16" else TRAIN_BATCH * TRAIN_BOXES
        crops = (n_crops, s.tokens(s.crop), v.width)
        heads = (s.heads, v.head_width)
        check_rope(torch, dev, records, gen, student, s.grid(s.image), heads[1], backward=True)
        check_rope(torch, dev, records, gen, crops, s.grid(s.crop), heads[1], backward=False)
        check_attention(torch, dev, records, gen, student[:2] + heads, train=True)
        check_attention(torch, dev, records, gen, crops[:2] + heads, train=False)
        if s.key == "b16":  # the detector's dense pass: 8 images at 640^2
            from clipself_tpu_torch.detector.config import PRESETS

            side = PRESETS[DET_PRESET].image_size
            check_attention(torch, dev, records, gen, (DET_BATCH, s.tokens(side)) + heads, train=False)
        if s.key == "l14":  # the evaluator's own shapes: one image, one bucket
            check_attention(torch, dev, records, gen, (1, student[1]) + heads, train=False)
            check_attention(torch, dev, records, gen, (BUCKET, crops[1]) + heads, train=False)
        torch.cuda.empty_cache()
        for width in (v.width, s.hidden):
            check_layer_norm(torch, dev, records, gen, student[:2] + (width,), "", backward=True)
        if s.key == "l14":
            teacher = (TRAIN_BATCH * TRAIN_BOXES, s.tokens(s.crop))
            for width in (v.width, s.hidden):
                check_layer_norm(torch, dev, records, gen, teacher + (width,), "", backward=False)
            check_layer_norm(torch, dev, records, gen, student, " rows 1: of", backward=True)
            check_layer_norm(torch, dev, records, gen, teacher + (v.width,), " row 0 of", backward=True)
    check_nms(torch, dev, records)


def phase_eval(torch, dev, s: Model):
    import numpy as np

    from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.models.factory import create_model

    model = create_model(s.model, device=dev, dtype=torch.bfloat16, seed=SEED)
    cfg = model.cfg

    def batch(i):
        # staged on the card, as the JAX evaluator bench stages them
        host = synthetic_panoptic_batch(
            i, batch=s.eval_batch, image_size=s.image, max_anns=MAX_ANNS, valid_anns=VALID_ANNS,
            crop_size=s.crop, mask_hw=s.grid(s.image), n_classes=N_CLASSES, seed=SEED,
        )
        return {k: (v if k == "boxes" else torch.as_tensor(v, device=dev)) for k, v in host.items()}

    warm = batch(N_BATCHES)
    batches = [batch(i) for i in range(N_BATCHES)]
    emb = class_embeddings(N_CLASSES, cfg.embed_dim, seed=SEED)
    evaluate_zero_shot(model, [warm], emb, device=dev, ann_bucket=BUCKET)  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = evaluate_zero_shot(model, batches, emb, device=dev, ann_bucket=BUCKET)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()

    ips = s.eval_batch * N_BATCHES / dt
    print(
        f"{s.key} eval {s.model} zero-shot: {N_BATCHES} batches x {s.eval_batch} images "
        f"{s.image}px, {VALID_ANNS} valid of {MAX_ANNS} anns (bucket {BUCKET}), crops "
        f"{s.crop}px, {cfg.vision.layers} blocks: {dt:.3f} s, {ips:.3f} images/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB",
        flush=True,
    )
    print(f"{s.key} eval mAcc " + json.dumps(res, sort_keys=True), flush=True)
    print(f"{s.key} eval launches " + json.dumps(launches), flush=True)
    if not res or not all(np.isfinite(v) for v in res.values()):
        fail(f"evaluator result not finite: {res}")
    expect = expected_launches(cfg.vision.layers, evals=N_BATCHES)
    if launches != expect:
        fail(f"{s.key} eval launch counts {launches}, expected {expect}")
    return model, batches[0], launches


def phase_parity(torch, dev, s: Model, model_bf16, batch):
    from clipself_tpu_torch.models.factory import create_model

    images = batch["images"]
    model_f32 = create_model(s.model, device=dev, dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        dense_k32 = model_f32.encode_dense(images, keep_shape=True)
        dense_k16 = model_bf16.encode_dense(images, keep_shape=True)
        # the plain path: the same model with the kernels' plain versions
        with plain_path():
            dense_p32 = model_f32.encode_dense(images, keep_shape=True)
    torch.cuda.synchronize()
    f32_abs = (dense_k32 - dense_p32).abs().max().item()
    f32_cos = min_row_cos(dense_k32, dense_p32)
    bf16_abs = (dense_k16.float() - dense_p32).abs().max().item()
    bf16_cos = min_row_cos(dense_k16, dense_p32)
    shape = list(dense_p32.shape)
    print(
        f"{s.key} parity dense map {shape} f32 kernels vs f32 plain: max_abs {f32_abs:.3e} "
        f"min_row_cos {f32_cos:.7f} (bar max_abs {PATH_F32_MAX_ABS})",
        flush=True,
    )
    print(
        f"{s.key} parity dense map {shape} bf16 kernels vs f32 plain: max_abs {bf16_abs:.3e} "
        f"min_row_cos {bf16_cos:.7f} (bar min_row_cos {PATH_BF16_MIN_COS})",
        flush=True,
    )
    for t in (dense_k32, dense_k16, dense_p32):
        if not torch.isfinite(t).all():
            fail("non-finite dense map")
    if not f32_abs <= PATH_F32_MAX_ABS:
        fail(f"{s.key} f32 kernel path off the plain path by {f32_abs}")
    if not bf16_cos >= PATH_BF16_MIN_COS:
        fail(f"{s.key} bf16 kernel path min row cosine {bf16_cos}")


def phase_train(torch, dev, s: Model, logs_dir, recompute=False):
    """The distill step through the trainer's entry point."""
    from clipself_tpu_torch.train import main as train_main
    from clipself_tpu_torch.train.optim import trainable_labels

    layers = s.vision.layers
    warmup = 0 if recompute else TRAIN_WARMUP
    steps = RECOMPUTE_STEPS if recompute else TRAIN_WARMUP + TRAIN_TIMED
    tag = f"{s.key} train" + (" recompute" if recompute else "")
    argv = [
        "--synthetic", "--model", s.model, "--precision", "bf16", "--device", str(dev),
        "--batch-size", str(TRAIN_BATCH), "--det-image-size", str(s.image),
        "--max-boxes", str(TRAIN_BOXES), "--lock-image-unlocked-groups", str(layers),
        "--steps-per-epoch", str(steps), "--epochs", "1", "--log-every-n-steps", "1",
        "--lr", "1e-5", "--warmup", "1", "--seed", str(SEED),
        "--logs", logs_dir, "--name", tag.replace(" ", "_"),
    ] + (["--grad-checkpointing"] if recompute else [])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_main.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    timed = hist[warmup:]
    seconds = sum(TRAIN_BATCH / h["images_per_sec"] for h in timed)
    ips = TRAIN_BATCH * len(timed) / seconds
    print(
        f"{tag} {s.model} distill step: batch {TRAIN_BATCH} at {s.image}px, {TRAIN_BOXES} boxes, "
        f"crops {s.crop}px, {layers} blocks unlocked, bf16: {len(timed)} timed steps after "
        f"{warmup} warm-up in {seconds:.3f} s, {ips:.3f} images/s "
        f"(per step {[round(h['images_per_sec'], 3) for h in timed]})",
        flush=True,
    )
    print(f"{tag} losses {json.dumps([round(x, 6) for x in losses])}", flush=True)
    print(f"{tag} peak memory {peak_gib:.3f} GiB (max_memory_allocated)", flush=True)
    print(f"{tag} launches {json.dumps(launches)}", flush=True)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"{tag} losses {losses}")
    expect = expected_launches(layers, steps=steps, recompute=recompute)
    if launches != expect:
        fail(f"{tag} launch counts {launches}, expected {expect}")
    student, teacher = run["state"].model, run["teacher"]
    if student.visual.grad_checkpointing != recompute:
        fail(f"{tag}: the student's grad_checkpointing is {student.visual.grad_checkpointing}")
    labels = trainable_labels((n for n, _ in student.named_parameters()), layers, layers)
    t_params = dict(teacher.named_parameters())
    moved = set()
    for name, p in student.named_parameters():
        if not torch.isfinite(p).all():
            fail(f"non-finite parameter {name} after training")
        same = torch.equal(p, t_params[name])
        if labels[name] == "freeze" and not same:
            fail(f"frozen parameter {name} moved")
        if labels[name] == "train" and not same:
            moved.add(name.split(".")[2])
    if moved != {str(i) for i in range(layers)}:
        fail(f"{tag}: unlocked blocks that moved: {sorted(moved)}")
    print(f"{tag} checks: losses finite, {layers} unlocked blocks moved, frozen unchanged", flush=True)
    del run, student, teacher
    return dict(images_per_sec=ips, losses=losses, peak_gib=peak_gib, launches=launches)


def phase_train_parity(torch, dev, s: Model):
    """One step's loss and trainable gradients from the same weights and
    batch (batch 1) on f32 kernels, bf16 kernels and the f32 plain path."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.data.loader import SyntheticDistillData
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import trainable_labels

    cfg = get_model_config(s.model)
    if s.parity_layers is not None:
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=s.parity_layers)
        )
    layers = cfg.vision.layers
    host = SyntheticDistillData(
        batch_size=1, det_size=s.image, crop_size=s.crop, max_anns=TRAIN_BOXES, seed=SEED
    ).batch
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}

    def one_step(dtype, plain):
        model = create_model(cfg, device=dev, dtype=dtype, seed=SEED)
        teacher = copy.deepcopy(model).requires_grad_(False)
        named = list(model.named_parameters())
        labels = trainable_labels((n for n, _ in named), layers, layers)
        for name, p in named:
            p.requires_grad_(labels[name] == "train")
        reset_counts()
        with plain_path() if plain else contextlib.nullcontext():
            loss, _ = clipself_loss(model, teacher, batch)
            loss.backward()
        # every kernel of the tower, forward and backward (the NMS kernel
        # belongs to the detector)
        if not plain and not all(v for k, v in read_counts().items() if k != "nms"):
            fail(f"kernel path missed a kernel: {read_counts()}")
        grads = {n: p.grad.float() for n, p in named if p.grad is not None}
        out = loss.item()
        del model, teacher, loss
        torch.cuda.empty_cache()
        return out, grads

    loss_p, g_p = one_step(torch.float32, plain=True)
    loss_k, g_k = one_step(torch.float32, plain=False)
    loss_h, g_h = one_step(torch.bfloat16, plain=False)
    if not (g_p.keys() == g_k.keys() == g_h.keys()) or not g_p:
        fail("the three paths produced gradients for different parameters")
    rel, cos = {}, {}
    for name, w in g_p.items():
        rel[name] = (g_k[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        cos[name] = torch.nn.functional.cosine_similarity(
            g_h[name].flatten(), w.flatten(), dim=0
        ).item()
    worst_rel = max(rel, key=rel.get)
    worst_cos = min(cos, key=cos.get)
    print(
        f"{s.key} train parity {s.model}, {layers} of {s.vision.layers} blocks, batch 1, "
        f"{len(g_p)} trainable gradients: loss f32 plain {loss_p:.7f}, f32 kernels {loss_k:.7f} "
        f"(|d| {abs(loss_k - loss_p):.3e}, bar {STEP_LOSS_MAX_ABS}), bf16 kernels {loss_h:.7f}",
        flush=True,
    )
    print(
        f"{s.key} train parity gradients: f32 kernels vs f32 plain max rel {rel[worst_rel]:.3e} "
        f"({worst_rel}; bar {STEP_GRAD_F32_MAX_REL}); bf16 kernels vs f32 plain min cosine "
        f"{cos[worst_cos]:.6f} ({worst_cos}; bar {STEP_GRAD_BF16_MIN_COS})",
        flush=True,
    )
    finite = all(torch.isfinite(g).all().item() for d in (g_p, g_k, g_h) for g in d.values())
    if not finite or not all(map(math.isfinite, (loss_p, loss_k, loss_h))):
        fail("non-finite loss or gradient in train parity")
    if not abs(loss_k - loss_p) <= STEP_LOSS_MAX_ABS:
        fail(f"f32 kernel loss off the plain loss by {abs(loss_k - loss_p)}")
    if not rel[worst_rel] <= STEP_GRAD_F32_MAX_REL:
        fail(f"f32 kernel gradient {worst_rel} off by {rel[worst_rel]} of its max")
    if not cos[worst_cos] >= STEP_GRAD_BF16_MIN_COS:
        fail(f"bf16 kernel gradient {worst_cos} cosine {cos[worst_cos]}")


def phase_model(torch, dev, s: Model, logs_dir) -> dict:
    """Phases 3 to 6 for one model; returns the launch counts by main path."""
    model_bf16, batch0, eval_launches = phase_eval(torch, dev, s)
    phase_parity(torch, dev, s, model_bf16, batch0)
    del model_bf16, batch0
    torch.cuda.empty_cache()
    paths = {f"{s.key}_eval": eval_launches}
    try:
        train = phase_train(torch, dev, s, logs_dir)
        paths[f"{s.key}_train"] = train["launches"]
        torch.cuda.empty_cache()
        if s.key == "l14":
            again = phase_train(torch, dev, s, logs_dir, recompute=True)
            paths[f"{s.key}_train_recompute"] = again["launches"]
            delta = abs(again["losses"][0] - train["losses"][0])
            print(
                f"{s.key} train recompute vs not: first loss |d| {delta:.3e} (bar "
                f"{RECOMPUTE_LOSS_MAX_ABS}), peak memory {again['peak_gib']:.3f} GiB vs "
                f"{train['peak_gib']:.3f} GiB, images/s {again['images_per_sec']:.3f} "
                f"(first steps, not warmed up) vs {train['images_per_sec']:.3f}",
                flush=True,
            )
            if not delta <= RECOMPUTE_LOSS_MAX_ABS:
                fail(f"{s.key}: the recomputing run's first loss is off by {delta}")
    finally:
        shutil.rmtree(logs_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_train_parity(torch, dev, s)
    torch.cuda.empty_cache()
    return paths


def stats(got, want, width=None) -> dict:
    """max abs, mean abs and min row cosine of two tensors; ``width`` cuts
    both into rows of that many values first (a last axis of 3 anchors is
    too narrow for a row cosine to mean anything)."""
    got, want = got.float(), want.float()
    if width is not None:
        n = got.numel() // width * width
        got, want = got.reshape(-1)[:n].reshape(-1, width), want.reshape(-1)[:n].reshape(-1, width)
    diff = (got - want).abs()
    return dict(max_abs=diff.max().item(), mean_abs=diff.mean().item(), min_cos=min_row_cos(got, want))


def matched(torch, ref, other, top=None):
    """One-to-one greedy matching at IoU > 0.5 of the reference's positive
    detections (the ``top`` best by score, or all) to the other leg's, per
    image: (reference detections, matched, matched with the same label, max
    score difference of a matched pair)."""
    from clipself_tpu_torch.detector.boxes import box_iou

    n_ref = n_match = same = 0
    drift = 0.0
    for (rb, rs, rl), (ob, os_, ol) in zip(zip(*ref), zip(*other)):
        order = torch.argsort(rs, descending=True, stable=True)
        order = order[rs[order] > 0][:top]
        iou = box_iou(rb[order].float(), ob.float())
        iou[:, os_ <= 0] = -1.0
        for j, row in zip(order.tolist(), iou):
            n_ref += 1
            m = int(row.argmax())
            if row[m] > 0.5:
                iou[:, m] = -1.0
                n_match += 1
                same += int(ol[m] == rl[j])
                drift = max(drift, abs(float(os_[m] - rs[j])))
    return n_ref, n_match, same, drift


def phase_detector(torch, dev):
    """`evaluate_detector` at the full preset; returns what the parity phase
    reuses and the launch counts of the timed run."""
    import numpy as np

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.data.synthetic import class_embeddings
    from clipself_tpu_torch.detector.classes import base_novel_mask
    from clipself_tpu_torch.detector.config import PRESETS
    from clipself_tpu_torch.detector.data import SyntheticDetectionData, collate, synthetic_eval_items
    from clipself_tpu_torch.detector.evaluate import evaluate_detector, make_predict_fn, metrics_json
    from clipself_tpu_torch.detector.fvit import create_detector
    from clipself_tpu_torch.models.factory import create_model

    cfg = PRESETS[DET_PRESET]
    layers = get_model_config(cfg.clip_model).vision.layers
    clip = create_model(cfg.clip_model, device=dev, dtype=torch.bfloat16, seed=SEED)
    det = create_detector(cfg, device=dev, seed=SEED + 1)
    emb = class_embeddings(cfg.num_classes + 1, cfg.embed_dim, seed=SEED)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    data = SyntheticDetectionData(cfg.num_classes, cfg.image_size, cfg.max_gt, seed=SEED)
    warm = synthetic_eval_items(data.batch(DET_BATCH))
    items = [it for _ in range(DET_BATCHES) for it in synthetic_eval_items(data.batch(DET_BATCH))]
    evaluate_detector(det, clip, warm, cfg, emb, device=dev, batch_size=DET_BATCH)  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = evaluate_detector(det, clip, items, cfg, emb, device=dev, batch_size=DET_BATCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    n_anchors = sum(3 * math.ceil(cfg.image_size / s) ** 2 for s in cfg.anchors.strides)
    print(
        f"detector eval {DET_PRESET} ({cfg.clip_model}, {layers} blocks): {DET_BATCHES} batches x "
        f"{DET_BATCH} images {cfg.image_size}px, {n_anchors} anchors, "
        f"{cfg.test_proposals.nms_pre} -> {cfg.test_proposals.max_per_img} proposals, "
        f"{cfg.num_classes} classes, bf16: {dt:.3f} s, {len(items) / dt:.3f} images/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB",
        flush=True,
    )
    print("detector eval metrics " + metrics_json(metrics, sort_keys=True), flush=True)
    print(f"detector eval launches {json.dumps(launches)}", flush=True)
    if set(metrics) != {"mAP", "AP50", "AP75", "AP50_base", "AP50_novel"}:
        fail(f"detector metrics {metrics}")
    # every synthetic image has ground truth of base and novel classes, so
    # no group is empty: each metric is a number in [0, 1]
    if not all(0.0 <= v <= 1.0 for v in metrics.values()):
        fail(f"detector metrics out of range: {metrics}")
    expect = expected_launches(layers, dets=DET_BATCHES)
    if launches != expect:
        fail(f"detector eval launch counts {launches}, expected {expect}")
    # one batch's raw outputs (after the counts were read)
    batch = collate(items[:DET_BATCH])
    boxes, scores, labels = make_predict_fn(
        det, clip, cfg, torch.as_tensor(emb, device=dev),
        torch.as_tensor(base_novel_mask("coco"), device=dev),
    )(torch.as_tensor(batch["images"], device=dev), torch.as_tensor(batch["valid_hw"], device=dev))
    want = (DET_BATCH, cfg.rcnn_test.max_per_img)
    live = scores > 0
    print(
        f"detector predict outputs: boxes {list(boxes.shape)}, scores {list(scores.shape)}, labels "
        f"{list(labels.shape)}; detections an image {live.sum(dim=1).tolist()}, best score "
        f"{scores.max().item():.4f}",
        flush=True,
    )
    if boxes.shape != want + (4,) or scores.shape != want or labels.shape != want:
        fail(f"detections of shape {boxes.shape}, {scores.shape}, {labels.shape}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores[live]).all() and live.any()):
        fail("non-finite or no detections")
    if not ((labels[live] >= 0) & (labels[live] < cfg.num_classes)).all() or (labels[~live] != -1).any():
        fail("detection labels out of range")
    return cfg, clip, det, emb, items, launches


def phase_detector_parity(torch, dev, cfg, clip_bf16, det, emb, items):
    from clipself_tpu_torch.detector.classes import base_novel_mask
    from clipself_tpu_torch.detector.data import collate
    from clipself_tpu_torch.detector.fvit import backbone_taps
    from clipself_tpu_torch.models.factory import create_model

    batch = collate(items[:DET_PARITY_IMAGES])
    images = torch.as_tensor(batch["images"], device=dev)
    ce = torch.as_tensor(emb, device=dev)
    bm = torch.as_tensor(base_novel_mask("coco"), device=dev)
    gen = torch.Generator().manual_seed(SEED)
    shape = (DET_PARITY_IMAGES, DET_FIXED_ROIS, 2)
    lo = torch.rand(shape, generator=gen) * 0.6 * cfg.image_size
    ext = (0.1 + 0.25 * torch.rand(shape, generator=gen)) * cfg.image_size
    rois = torch.cat([lo, torch.clamp(lo + ext, max=cfg.image_size)], -1).to(dev)
    clip_f32 = create_model(cfg.clip_model, device=dev, dtype=torch.float32, seed=SEED)
    torch.cuda.reset_peak_memory_stats()

    def leg(clip):
        """Every compared tensor of one path, and its detections."""
        reset_counts()
        with torch.inference_mode():
            taps, dense = backbone_taps(clip, images, cfg, True)
            _, smap, _ = det.features(taps)
            logits, deltas = det(taps, rois, ce)
            _, props, pscores = det.proposals(taps)
            dets = det.predict(taps, dense, ce, bm)
        torch.cuda.synchronize()
        out = dict(
            taps=torch.cat([t.reshape(-1, t.shape[-1]) for t in taps]),
            dense=dense.reshape(-1, dense.shape[-1]),
            rpn=torch.cat([m.reshape(-1) for m in smap]),
            logits=logits, deltas=deltas, props=props, pscores=pscores, dets=dets,
        )
        return out, (taps, dense), read_counts()

    k16, _, counts16 = leg(clip_bf16)
    k32, (taps32, dense32), counts32 = leg(clip_f32)
    for name, counts in (("bf16", counts16), ("f32", counts32)):
        if counts["nms"] != 3 or not counts["flash_attention"]:  # proposals, then predict's two
            fail(f"detector {name} kernel leg launches {counts}")
    with plain_path():
        p32, _, _ = leg(clip_f32)
    del clip_f32

    shapes = f"{DET_PARITY_IMAGES} images"
    rows = (
        (f"backbone taps {cfg.image_size}", "taps", None), ("dense vlm map", "dense", None),
        ("rpn objectness maps", "rpn", 1024),
        (f"bbox-head cls logits ({DET_FIXED_ROIS} fixed rois an image)", "logits", None),
        (f"bbox-head box deltas ({DET_FIXED_ROIS} fixed rois an image)", "deltas", None),
    )
    for tag, leg_out in (("bf16 kernels", k16), ("f32 kernels", k32)):
        for title, key, width in rows:
            st = stats(leg_out[key], p32[key], width)
            print(
                f"detector parity {shapes}, {tag} vs f32 plain: {title}: max_abs "
                f"{st['max_abs']:.3e} mean_abs {st['mean_abs']:.3e} min_cos {st['min_cos']:.6f}",
                flush=True,
            )
            if not all(map(math.isfinite, st.values())):
                fail(f"detector parity {tag} {title}: non-finite")
            if tag == "bf16 kernels":
                bar = PATH_BF16_MIN_COS if key == "dense" else DET_BF16_MIN_COS_FLOOR
                if not st["min_cos"] >= bar:
                    fail(f"detector {tag} {title}: min cosine {st['min_cos']} (bar {bar})")
            else:
                bar = PATH_F32_MAX_ABS if key == "dense" else DET_F32_MAX_ABS
                if not st["max_abs"] <= bar:
                    fail(f"detector {tag} {title}: max abs {st['max_abs']} (bar {bar})")

    for tag, leg_out in (("bf16 kernels", k16), ("f32 kernels", k32)):
        for top in (10, None):
            n_ref, n_match, same, drift = matched(torch, p32["dets"], leg_out["dets"], top)
            print(
                f"detector parity detections, f32 plain vs {tag}: "
                f"{'top %d an image' % top if top else 'all positive'}: {n_match}/{n_ref} matched "
                f"one to one at IoU > 0.5, {same}/{n_match} same label, max score drift {drift:.4f}",
                flush=True,
            )
            if tag == "f32 kernels" and top and not n_match == same == n_ref:
                fail("the f32 kernel path lost one of the plain path's top detections")

    # the NMS kernel alone: the same float32 taps through `predict` with the
    # kernel and with the plain NMS; everything else is the same code on
    # the same values, so proposals and detections must be equal bit for bit
    with torch.inference_mode():
        with plain_nms():
            _, props_p, pscores_p = det.proposals(taps32)
            dets_p = det.predict(taps32, dense32, ce, bm)
    pairs = zip((k32["props"], k32["pscores"], *k32["dets"]), (props_p, pscores_p, *dets_p))
    equal = [torch.equal(a, b) for a, b in pairs]
    n_props = (pscores_p > -1e9).sum(dim=1).tolist()
    n_dets = (dets_p[1] > 0).sum(dim=1).tolist()
    print(
        f"detector parity, f32 taps, NMS kernel vs plain NMS: proposals, scores, detections' boxes, "
        f"scores, labels equal bit for bit: {equal} ({n_props} proposals, {n_dets} detections)",
        flush=True,
    )
    if not all(equal):
        fail("predict with the NMS kernel differs from predict with the plain NMS")
    print(
        f"detector parity peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"({DET_PARITY_IMAGES} images; the float32 legs keep the RoI-align's y-stage in float32)",
        flush=True,
    )


def kernel_rows(records: Records, paths: dict) -> list:
    """One row per kernel: its launches on the main paths and its numbers
    at the L/14 student's shape in bfloat16 (the NMS kernel: the detector's
    RPN candidates, float32), then every record."""
    l14 = MODELS[-1]
    student = (TRAIN_BATCH, l14.tokens(l14.image))
    rows = {  # name and launch counter: source, the TPU kernel it replaces, the row's own record
        "rope_roll": (
            "rope_roll.cu", "clipself_tpu/ops/rope_roll.py:105",
            ("forward", student + (l14.vision.width,)),
        ),
        "flash_attention": (
            "flash_attention.cu", "clipself_tpu/ops/attention.py:288",
            ("forward", student + (l14.heads, l14.vision.head_width)),
        ),
        "flash_attention_bwd": (
            "flash_attention_bwd.cu", "clipself_tpu/ops/flash_bwd.py:208",
            ("backward", student + (l14.heads, l14.vision.head_width)),
        ),
        "layer_norm": (
            "layer_norm.cu", "clipself_tpu/ops/layer_norm.py:139",
            ("forward", student + (l14.vision.width,)),
        ),
        "layer_norm_bwd": (
            "layer_norm.cu", "clipself_tpu/ops/layer_norm.py:171",
            ("backward", student + (l14.vision.width,)),
        ),
        "nms": (
            "nms.cu", "clipself_tpu/ops/nms_pallas.py:87",
            ("keep mask anchors thr 0.7", (DET_BATCH, 2000, 4), "float32"),
        ),
    }
    kernels = []
    for name, (src, replaces, primary) in rows.items():
        row = {
            "name": name, "route": "cuda", "source": f"clipself_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {k: p[name] for k, p in paths.items()},
            **{k: v for k, v in records.primary(name, *primary).items() if k != "what"},
            "checked_at": records.rows[name],
        }
        if name == "rope_roll":  # its backward is the same kernel on the rolled tables
            row["backward_launches_by_path"] = {k: p["rope_roll_bwd"] for k, p in paths.items()}
        if row["launches"] == 0:
            fail(f"no main path launched {name}")
        kernels.append(row)
    return kernels


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

    records = Records()
    phase_kernels(torch, dev, records)
    logs_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_logs")
    # launches: every main path counted from 0 (each model's evaluator and
    # train runs); the backward rows launch on the train paths only
    paths = {}
    for s in MODELS:
        paths.update(phase_model(torch, dev, s, logs_dir))
        print(f"{s.key} done at {time.perf_counter() - t0:.1f} s", flush=True)
    cfg, clip, det, emb, items, paths["b16_detector"] = phase_detector(torch, dev)
    phase_detector_parity(torch, dev, cfg, clip, det, emb, items)
    del clip, det
    print(f"detector done at {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = kernel_rows(records, paths)
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
