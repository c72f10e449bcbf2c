"""Where the F-ViT detector's bfloat16 path drifts from float32, module by
module, and what the candidate settings do to it.

    python -m clipself_tpu_torch.tools.detector_drift [--preset ov_coco_vitb16] [--json PATH]

On two synthetic images of ``--preset`` (seeded random CLIP and detector
weights), the float32 path (trunk kernels in float32, heads in float32) is
the reference. Every leg runs the trunk's taps and dense map, the heads'
`features` (pyramid, FPN, RPN maps) and the bbox head on 32 fixed rois an
image, with a forward hook on every module of the detector; each module's
output is compared with the reference's by its min row cosine (rows of the
last axis; a last axis narrower than 16 is cut into rows of 1024 values,
or one row if the output is smaller).
The legs:
  - "bf16": the bfloat16 path as it ships;
  - "bf16, no reduced-precision reduction": with
    `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` off
    (cuBLAS then keeps every split-K partial sum in float32);
  - "bf16, cuDNN deterministic": `torch.backends.cudnn.deterministic` on
    (other convolution and deconvolution algorithms);
  - "bf16 heads on f32 taps": the heads in bfloat16 on the reference's taps
    rounded to bfloat16, which isolates the heads' own drift;
  - "f32 heads on bf16 taps": the heads in float32 on the bfloat16 trunk's
    taps, which isolates the trunk's.
For the first three legs also the device time of the whole forward (taps,
features, proposals, `predict`), CUDA-event means over 5 calls after 2,
read in the same process in turns (A B C C B A, the mean of each leg's two
readings), and for the float32 path. The first line names the card and its power
limit; the last is one JSON object (also written to ``--json``).
``--device cpu --preset tiny_test`` rehearses the control flow; it has no
device time and no bfloat16 kernels to report.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from clipself_tpu_torch.data.synthetic import class_embeddings
from clipself_tpu_torch.detector.classes import base_novel_mask
from clipself_tpu_torch.detector.config import PRESETS
from clipself_tpu_torch.detector.data import SyntheticDetectionData, collate, synthetic_eval_items
from clipself_tpu_torch.detector.fvit import backbone_taps, create_detector
from clipself_tpu_torch.models.factory import create_model

IMAGES, ROIS, SEED = 2, 32, 0


def min_row_cos(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    width = got.shape[-1] if got.shape[-1] >= 16 else min(1024, got.numel())
    n = got.numel() // width * width
    a = got.reshape(-1)[:n].reshape(-1, width)
    b = want.reshape(-1)[:n].reshape(-1, width)
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


@contextlib.contextmanager
def hooked(det: torch.nn.Module, out: dict):
    """Collect each module's tensor outputs, by name, in call order."""

    def grab(name):
        def hook(module, args, result):
            many = isinstance(result, tuple)  # a list is one output: levels of one map
            for j, t in enumerate(result if isinstance(result, (list, tuple)) else [result]):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    key = f"{name}[{j}]" if many else name
                    out.setdefault(key, []).append(t.detach().float().reshape(-1, t.shape[-1]))
        return hook

    handles = [m.register_forward_hook(grab(n)) for n, m in det.named_modules() if n]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def settings(reduced: bool = True, deterministic: bool = False):
    saved = (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    torch.backends.cudnn.deterministic = deterministic
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
         torch.backends.cudnn.deterministic) = saved


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("detector_drift")
    p.add_argument("--preset", default="ov_coco_vitb16")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("detector_drift: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)

    cfg = PRESETS[args.preset]
    det = create_detector(cfg, device=dev, seed=SEED + 1)
    clips = {dt: create_model(cfg.clip_model, device=dev, dtype=dt, seed=SEED)
             for dt in (torch.float32, torch.bfloat16)}
    data = SyntheticDetectionData(cfg.num_classes, cfg.image_size, cfg.max_gt, seed=SEED)
    batch = collate(synthetic_eval_items(data.batch(IMAGES)))
    images = torch.as_tensor(batch["images"], device=dev)
    emb = class_embeddings(cfg.num_classes + 1, cfg.embed_dim, seed=SEED)
    ce = torch.as_tensor(emb / np.linalg.norm(emb, axis=-1, keepdims=True), device=dev)
    bm = torch.as_tensor(base_novel_mask("coco"), device=dev)
    gen = torch.Generator().manual_seed(SEED)
    lo = torch.rand((IMAGES, ROIS, 2), generator=gen) * 0.6 * cfg.image_size
    ext = (0.1 + 0.25 * torch.rand((IMAGES, ROIS, 2), generator=gen)) * cfg.image_size
    rois = torch.cat([lo, torch.clamp(lo + ext, max=cfg.image_size)], -1).to(dev)

    def heads(taps):
        """Module outputs of the heads on these taps."""
        out = {}
        with torch.inference_mode(), hooked(det, out):
            det.features(taps)
            det(taps, rois, ce)
        return {k: torch.cat(v) for k, v in out.items()}

    def taps_of(dtype):
        with torch.inference_mode():
            taps, dense = backbone_taps(clips[dtype], images, cfg, True)
        return taps, dense

    def forward_ms(dtype):
        if not cuda:
            return None

        def run():
            with torch.inference_mode():
                taps, dense = backbone_taps(clips[dtype], images, cfg, True)
                det.features(taps)
                det.proposals(taps)
                det.predict(taps, dense, ce, bm)
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5

    taps32, dense32 = taps_of(torch.float32)
    ref = heads(taps32)
    timed = (("bf16", {}), ("bf16, no reduced-precision reduction", {"reduced": False}),
             ("bf16, cuDNN deterministic", {"deterministic": True}))
    legs = {}
    for name, kw in timed:
        with settings(**kw):
            taps16, dense16 = taps_of(torch.bfloat16)
            legs[name] = heads(taps16)
            legs[name]["(trunk) taps"] = torch.cat([t.reshape(-1, t.shape[-1]) for t in taps16]).float()
            legs[name]["(trunk) dense"] = dense16.reshape(-1, dense16.shape[-1]).float()
    legs["bf16 heads on f32 taps"] = heads([t.to(torch.bfloat16) for t in taps32])
    legs["f32 heads on bf16 taps"] = heads([t.float() for t in taps_of(torch.bfloat16)[0]])
    # the settings' forward times in turns (A B C C B A), the mean of each
    # setting's two readings, then float32
    ms = {name: [] for name, _ in timed}
    for name, kw in timed + timed[::-1]:
        with settings(**kw):
            ms[name].append(forward_ms(torch.bfloat16))
    ms = {k: None if None in v else sum(v) / len(v) for k, v in ms.items()}
    ms["f32"] = forward_ms(torch.float32)
    ref["(trunk) taps"] = torch.cat([t.reshape(-1, t.shape[-1]) for t in taps32])
    ref["(trunk) dense"] = dense32.reshape(-1, dense32.shape[-1])

    table = {leg: {k: min_row_cos(v, ref[k]) for k, v in out.items()} for leg, out in legs.items()}
    names = list(ref)
    print(f"{args.preset}, {IMAGES} images, {ROIS} fixed rois an image: min row cosine against the "
          "float32 path, module by module", flush=True)
    print("module | " + " | ".join(legs), flush=True)
    for k in names:
        print(f"{k} | " + " | ".join(
            f"{table[leg][k]:.6f}" if k in table[leg] else "-" for leg in legs), flush=True)
    print("forward ms (taps, features, proposals, predict; 5 calls after 2): "
          + json.dumps({k: v if v is None else round(v, 3) for k, v in ms.items()}), flush=True)
    result = {"preset": args.preset, "min_row_cos": table, "forward_ms": ms}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
