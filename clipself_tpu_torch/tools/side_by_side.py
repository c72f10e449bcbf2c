"""The greedy-NMS, rolled-RoPE, LayerNorm-backward and flash-attention
forward and backward kernels of one tree, timed at the shapes the main paths give them,
on one CUDA card: for comparing two trees (an older commit unpacked with
`git archive` beside the working tree) in one run on one card.

    python clipself_tpu_torch/tools/side_by_side.py --root build/parent
    python clipself_tpu_torch/tools/side_by_side.py --root .

Run as a file, not with `-m`: the package is imported from ``--root``, so the
same script times either tree: the NMS through `ops.nms.nms_keep_mask`, the
RoPE through `ops.rope_roll.rolled_rope_packed` where the tree has it (one
tensor, and q and k in one launch, the table packed beforehand), else
through its `rolled_rope_fwd` on the three tables ("q,k" is then two
launches of the one-tensor kernel), the LayerNorm backward through
`ops.layer_norm.layer_norm_bwd` on the forward's statistics (float32 and
bfloat16, with its time as a multiple of its bytes bound, and the times of
dx alone and of the sums alone), the flash forward through
`ops.attention.flash_attention_fwd` with and without its LSE, and the flash
backward through `ops.attention.flash_attention_bwd` on the forward's
output and LSE (each with its time as a multiple of its operations bound,
the backward with whether two calls gave the same bits of dQ, dK and dV).
Times are CUDA-event means of 20 calls replayed from a CUDA graph after a
warm-up (the NMS and the flash kernels also as 20 eager calls: their
wrappers allocate, which a graph hides). The first line names the card and
its power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CALLS = 20
# (kind, images, boxes, IoU threshold): the detector's RPN candidates, its
# class-offset candidates, one image
NMS_SHAPES = (("anchors", 8, 2000, 0.7), ("class_offset", 8, 2000, 0.4), ("anchors", 1, 2000, 0.7))
# (images, grid side, width) at head_dim 64, bfloat16: the B/16 and L/14
# students, the L/14 teacher's crops, the detector's batch, the B/16 crops
ROPE_SHAPES = ((2, 64, 768), (2, 64, 1024), (40, 24, 1024), (8, 40, 768), (50, 14, 768))
HEAD_DIM = 64
# (shape, view) of the LayerNorm backward: the B/16 student's widths 768 and
# 2048, the L/14 student's 1024 and 2730, the L/14 teacher's crops, and the
# two strided views of the final norm that `chip_smoke.py` times
LN_SHAPES = (
    ((2, 4097, 768), ""), ((2, 4097, 2048), ""), ((2, 4097, 1024), ""), ((2, 4097, 2730), ""),
    ((40, 577, 1024), ""), ((2, 4097, 1024), "rows 1:"), ((40, 577, 1024), "row 0"),
)
LN_VIEWS = {"": lambda t: t, "rows 1:": lambda t: t[:, 1:], "row 0": lambda t: t[:, 0]}
PEAK_BYTES_S = 3.35e12  # one H100 SXM's device memory
# (shape [B, N, H, D], dtype) of the flash forward: the HF ViT-B/16 trunk's
# float32 student and its crops, the B/16 student in bfloat16 and the trunk
# at 1024^2 in float32, the pipeline's float32 microbatch (one image at
# 1024^2), one 896^2 image of the wide towers at their head dims (80:
# ViT-H-14; 88: ViT-g-14, EVA01-g-14; 104: ViT-bigG-14; 112: bigE-14,
# ViT-e-14) in bfloat16, then in float32 (the parity paths).
WIDE_HEAD_DIMS = (80, 88, 104, 112)
FLASH_FWD_SHAPES = (
    ((2, 197, 12, 64), "float32"),
    ((50, 197, 12, 64), "float32"),
    ((2, 4097, 12, 64), "bfloat16"),
    ((2, 4097, 12, 64), "float32"),
    ((1, 4097, 12, 64), "float32"),
    *(((1, 4097, 16, d), "bfloat16") for d in WIDE_HEAD_DIMS),
    *(((1, 4097, 16, d), "float32") for d in WIDE_HEAD_DIMS),
)
# ... of the flash backward: the same but the crops (no gradient), and the
# RegionCLIP B/16 step at batch 16
FLASH_BWD_SHAPES = tuple(
    s for s in FLASH_FWD_SHAPES[:5] if s != ((50, 197, 12, 64), "float32")
) + (((16, 4097, 12, 64), "bfloat16"),) + FLASH_FWD_SHAPES[5:]
# Each shape's forward and backward are timed before the next shape's, in
# this order, the wide ones last, so that two trees time the rows they share
# after the same work.
FLASH_SHAPES = tuple(dict.fromkeys(FLASH_FWD_SHAPES[:5] + FLASH_BWD_SHAPES))
# dense tensor-core bf16; float32 at float32 accuracy: three TF32 tensor-core
# products a float32 product (the split x = hi + lo, lo_a hi_b + hi_a lo_b +
# hi_a hi_b) at the dense TF32 rate of 494.7 TFLOP/s, above the 67 TFLOP/s of
# float32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12 / 3}


def device_ms(torch, fn, graph: bool) -> float:
    """Mean device time of one ``fn()`` of CALLS, eager or from a graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(CALLS):
            fn()

    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        captured.replay()
        torch.cuda.synchronize()
        run = captured.replay
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".", help="the tree whose package is timed")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("side_by_side: no CUDA device is available")
    from clipself_tpu_torch.detector.data import synthetic_nms_case
    from clipself_tpu_torch.models.rope import rope_tables
    from clipself_tpu_torch.ops import attention, layer_norm, nms, rope_roll

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"{card}; tree {args.root}", flush=True)
    out = {}
    for seed, (kind, b, n, thr) in enumerate(NMS_SHAPES):
        boxes, valid = (t.to(dev) for t in synthetic_nms_case(kind, b, n, seed))
        keep = nms.nms_keep_mask(boxes, valid, thr)
        ms = [device_ms(torch, lambda: nms.nms_keep_mask(boxes, valid, thr), graph) for graph in (True, False)]
        out[f"nms {kind} [{b}, {n}] thr {thr}"] = ms
        print(
            f"nms {kind} [{b}, {n}, 4] thr {thr}: {ms[0]:.4f} ms from a graph, {ms[1]:.4f} ms eager, "
            f"kept {keep.sum(dim=1).tolist()}",
            flush=True,
        )
    packed_form = hasattr(rope_roll, "rolled_rope_packed")
    gen = torch.Generator().manual_seed(0)
    for b, grid, w in ROPE_SHAPES:
        n = 1 + grid * grid
        tables = rope_tables(grid, grid, HEAD_DIM, 1, 16, dev)
        q, k = (torch.randn(b, n, w, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
        if packed_form:
            packed = rope_roll.pack_tables(*tables)
            one = device_ms(torch, lambda: rope_roll.rolled_rope_packed((q,), packed), graph=True)
            two = device_ms(torch, lambda: rope_roll.rolled_rope_packed((q, k), packed), graph=True)
            how = "one launch"
        else:
            one = device_ms(torch, lambda: rope_roll.rolled_rope_fwd(q, *tables), graph=True)
            two = device_ms(
                torch, lambda: (rope_roll.rolled_rope_fwd(q, *tables), rope_roll.rolled_rope_fwd(k, *tables)),
                graph=True,
            )
            how = "two launches"
        out[f"rope_roll [{b}, {n}, {w}] bf16"] = [one, two]
        print(
            f"rope_roll [{b}, {n}, {w}] bf16: one tensor {one:.4f} ms, q,k {two:.4f} ms ({how})",
            flush=True,
        )
    for shape, view in LN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = LN_VIEWS[view]((torch.randn(shape, generator=gen) * 3 + 0.5).to(dev, dt))
            dy = LN_VIEWS[view](torch.randn(shape, generator=gen).to(dev, dt)).contiguous()
            weight = (torch.randn(shape[-1], generator=gen) * 0.2 + 1.0).to(dev)
            bias = (torch.randn(shape[-1], generator=gen) * 0.1).to(dev)
            _, mu, rstd = layer_norm.layer_norm_fwd(x, weight, bias, 1e-6, return_stats=True)
            ms, dx_ms, sums_ms = (
                device_ms(torch, lambda: layer_norm.layer_norm_bwd(x, dy, mu, rstd, weight, **only), graph=True)
                for only in ({}, {"need_dwb": False}, {"need_dx": False})
            )
            # x, dy and the statistics read, dx written, the weight read and
            # dweight, dbias written once
            moved = 3 * x.numel() * x.element_size() + 8 * mu.numel() + 12 * shape[-1]
            bound = moved / PEAK_BYTES_S * 1e3
            label = f"layer_norm_bwd {view + ' of ' if view else ''}{list(shape)} -> {list(x.shape)} {str(dt)[6:]}"
            out[label] = [ms, bound, dx_ms, sums_ms]
            print(
                f"{label}: {ms:.4f} ms, bound {bound:.4f} ms ({ms / bound:.2f}x); "
                f"dx alone {dx_ms:.4f} ms, sums alone {sums_ms:.4f} ms",
                flush=True,
            )
    for (b, n, h, d), name in FLASH_SHAPES:  # each shape's forward, then its backward
        dt = getattr(torch, name)
        q, k, v, do = (torch.randn(b, n, h, d, generator=gen).to(dev, dt) for _ in range(4))
        scale = d ** -0.5
        # the two products Q K^T and P V
        bound = 4 * b * h * n * n * d / PEAK_FLOPS[name] * 1e3
        for lse in (False, True) if ((b, n, h, d), name) in FLASH_FWD_SHAPES else ():
            ms = [device_ms(torch, lambda: attention.flash_attention_fwd(q, k, v, scale, return_lse=lse), graph)
                  for graph in (True, False)]
            label = f"flash_attention_fwd{' with lse' if lse else ''} [{b}, {n}, {h}, {d}] {name}"
            out[label] = ms + [bound]
            print(
                f"{label}: {ms[0]:.4f} ms from a graph, {ms[1]:.4f} ms eager, bound {bound:.4f} ms "
                f"({ms[0] / bound:.2f}x)",
                flush=True,
            )
        if ((b, n, h, d), name) not in FLASH_BWD_SHAPES:
            del q, k, v, do
            continue
        o, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
        first = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
        second = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        del first, second
        ms = [device_ms(torch, lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale), graph)
              for graph in (True, False)]
        # five products of 2 n^2 d flops a (batch, head): S, dP, dV, dK, dQ
        bound *= 2.5
        label = f"flash_attention_bwd [{b}, {n}, {h}, {d}] {name}"
        out[label] = ms + [bound, same]
        print(
            f"{label}: {ms[0]:.4f} ms from a graph, {ms[1]:.4f} ms eager, bound {bound:.4f} ms "
            f"({ms[0] / bound:.2f}x); two calls bitwise equal: {same}",
            flush=True,
        )
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
