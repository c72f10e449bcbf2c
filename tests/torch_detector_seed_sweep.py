"""The detector's overfit drive over seeds in both packages, on the CPU at
the micro size: does the port's AP50 spread with ``--seed`` as the JAX
package's does? (Not collected by pytest: run it.)

    JAX_PLATFORMS=cpu python tests/torch_detector_seed_sweep.py --root DIR \
        --package jax|torch [--seeds 0 1 2 3 4] [--epochs 400] [--every 100]

`clipself_tpu_torch/tools/detector_seed_sweep.py::sweep` with the chosen
package's `fvit-train` and `fvit-test` mains: preset `tiny_test` on the
port tool's 8-image set at 64 px, the flags of the JAX twin
`tests/test_detector_overfit.py::test_detector_cli_overfits_micro_set`
(batch 8, lr 3e-3, no weight decay, ratio 1, fp32 training; `fvit-test` in
bf16 as both CLIs run it), and one vision-only CLIP `.pt` (the port's
`tiny_test` trunk at its default seed) as ``--clip-checkpoint`` of both, so
that both packages train on the same trunk and the same files. The last line is
the tool's JSON object.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from clipself_tpu_torch.detector.config import PRESETS  # noqa: E402
from clipself_tpu_torch.models.factory import create_model  # noqa: E402
from clipself_tpu_torch.tools.detector_seed_sweep import summary, sweep  # noqa: E402

FLAGS = ["--lr", "3e-3", "--wd", "0.0", "--ratio-range", "1.0", "1.0", "--precision", "fp32", "--log-every", "1000"]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--package", choices=["jax", "torch"], required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--every", type=int, default=100)
    args = p.parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    pt = os.path.join(args.root, "visual.pt")
    clip = create_model(PRESETS["tiny_test"].clip_model, device="cpu", dtype=torch.float32)
    torch.save({k: v for k, v in clip.state_dict().items() if k.startswith("visual.")}, pt)
    if args.package == "jax":
        from clipself_tpu.detector import evaluate, train

        train_main, test_main = train.main, evaluate.main
    else:
        from clipself_tpu_torch.detector import evaluate, train

        def train_main(a):
            return train.main(a + ["--device", "cpu"])

        def test_main(a):
            return evaluate.main(a + ["--device", "cpu"])

    ap50 = sweep(args.root, "tiny_test", args.seeds, args.epochs, args.every, FLAGS + ["--clip-checkpoint", pt],
                 train_main, test_main)
    result = summary(ap50)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
