"""The detector's overfit drive over seeds: where its AP50 sits along the
epochs and how far it moves with `--seed`.

    python -m clipself_tpu_torch.tools.detector_seed_sweep --root DIR \
        [--preset ov_coco_vitb16] [--seeds 0 1 2] [--epochs 160] [--every 20] \
        [--device cuda] [--json PATH] [fvit-train flags ...]

`tools/synth_det_data.py` writes the drive's set under ``--root`` (8
images, seed 7, at the preset's image size) and a class
embedding drawn from ``default_rng(0)`` (as `chip_smoke.py`'s drive draws
it). Then for each seed `fvit-train` (`detector/train.py`) runs ``--epochs``
epochs of batch 8 with ``--seed`` set to it, and `fvit-test`
(`detector/evaluate.py`) scores every ``--every``-th epoch's checkpoint on
the same files; a seed's checkpoints are deleted once scored. Flags the
tool does not know go to both CLIs (``--clip-checkpoint``) or to the
trainer alone (``--lr``, ``--wd``, ``--ratio-range``, ``--precision``).
Prints a line a checkpoint, the card's name and power limit, and last one
JSON object {"ap50": {seed: {epoch: AP50}}, "median_by_epoch": {...}}.

`sweep` takes the two CLIs' ``main`` functions, so that the JAX package's
can be swept on the same files (`tests/torch_detector_seed_sweep.py`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics

import numpy as np

_TEST_FLAGS = ("--clip-checkpoint",)


def sweep(root: str, preset: str, seeds, epochs: int, every: int, extra: list, train_main, test_main) -> dict:
    """{seed: {epoch: AP50}} of the drive on the set under ``root``;
    ``train_main`` / ``test_main``: `fvit-train` / `fvit-test` entry points
    taking an argv list."""
    from clipself_tpu_torch.detector.config import PRESETS
    from clipself_tpu_torch.tools import synth_det_data

    cfg = PRESETS[preset]
    dataset = "lvis" if "lvis" in preset else "coco"
    ann, imgs = synth_det_data.main(["--dataset", dataset, "--root", os.path.join(root, "set"),
                                     "--size", str(cfg.image_size)])
    ce = os.path.join(root, "class_embed.npy")
    np.save(ce, np.random.default_rng(0).standard_normal((cfg.num_classes + 1, cfg.embed_dim)).astype(np.float32))
    common = ["--preset", preset, "--ann-file", ann, "--image-root", imgs, "--class-embed", ce, "--batch-size", "8"]
    test_extra = [a for i, a in enumerate(extra) if a in _TEST_FLAGS or (i and extra[i - 1] in _TEST_FLAGS)]
    out = {}
    for seed in seeds:
        run_dir = os.path.join(root, f"seed{seed}")
        train_main(common + extra + ["--epochs", str(epochs), "--seed", str(seed), "--output", run_dir])
        out[seed] = {}
        for epoch in range(every, epochs + 1, every):
            ckpt = os.path.join(run_dir, f"detector_epoch{epoch - 1}.pkl")
            metrics = test_main(common + test_extra + ["--detector-checkpoint", ckpt])
            out[seed][epoch] = metrics["AP50"]
            print(f"seed {seed} epoch {epoch}: AP50 {metrics['AP50']:.4f} mAP {metrics['mAP']:.4f}", flush=True)
        shutil.rmtree(run_dir)  # a checkpoint an epoch: ~85 MB each at B/16
    return out


def summary(ap50: dict) -> dict:
    epochs = sorted({e for by_epoch in ap50.values() for e in by_epoch})
    return {"ap50": ap50, "median_by_epoch": {e: statistics.median(v[e] for v in ap50.values()) for e in epochs}}


def main(argv=None) -> dict:
    from clipself_tpu_torch.detector import evaluate as det_eval
    from clipself_tpu_torch.detector import train as det_train

    p = argparse.ArgumentParser("detector-seed-sweep")
    p.add_argument("--root", required=True)
    p.add_argument("--preset", default="ov_coco_vitb16")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--every", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    args, extra = p.parse_known_args(argv)
    device = ["--device", args.device]
    ap50 = sweep(args.root, args.preset, args.seeds, args.epochs, args.every, extra,
                 lambda a: det_train.main(a + device), lambda a: det_eval.main(a + device))
    result = summary(ap50)
    if args.device.startswith("cuda"):
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
