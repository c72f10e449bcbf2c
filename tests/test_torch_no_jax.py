"""The port imports no JAX, Flax, PIL or JAX-package module: in a fresh
interpreter (this test process has JAX loaded by conftest), import every
module of the port, run the tiny evaluator and one train step on the CPU."""

import json
import math
import os
import subprocess
import sys

_SCRIPT = r"""
import json, sys
import torch
import clipself_tpu_torch.core.config
import clipself_tpu_torch.data.synthetic as synthetic
import clipself_tpu_torch.eval.zero_shot as zero_shot
import clipself_tpu_torch.models.factory as factory
import clipself_tpu_torch.models.torch_io
import clipself_tpu_torch.ops._build
import clipself_tpu_torch.ops.attention
import clipself_tpu_torch.ops.layer_norm
import clipself_tpu_torch.ops.rope_roll
import clipself_tpu_torch.data.loader
import clipself_tpu_torch.tools.profile_paths
import clipself_tpu_torch.train.checkpoint
import clipself_tpu_torch.train.ensemble
import clipself_tpu_torch.train.main as train_main
import clipself_tpu_torch.train.methods
import clipself_tpu_torch.train.optim
import clipself_tpu_torch.train.step
import clipself_tpu_torch.utils.meters

model = factory.create_model("EVA02-CLIP-Tiny-Test", device="cpu", dtype=torch.float32, seed=0)
batch = synthetic.synthetic_panoptic_batch(
    0, batch=2, image_size=32, max_anns=8, valid_anns=5, crop_size=32, mask_hw=4, n_classes=7
)
res = zero_shot.evaluate_zero_shot(
    model, [batch], synthetic.class_embeddings(7, 64), device="cpu", ann_bucket=0
)
run = train_main.main([
    "--device", "cpu", "--synthetic", "--model", "EVA02-CLIP-Tiny-Test", "--batch-size", "1",
    "--det-image-size", "32", "--max-boxes", "2", "--steps-per-epoch", "1", "--epochs", "1",
    "--grad-checkpointing",
    "--logs", sys.argv[1], "--name", "no_jax",
])
loss = run["history"][-1]["loss"]
banned = ("jax", "jaxlib", "flax", "PIL", "optax", "orbax", "clipself_tpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(json.dumps({"n_results": len(res), "loss": loss, "loaded": loaded}))
"""


def test_port_runs_without_jax(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path)], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n_results"] == 12
    assert math.isfinite(out["loss"])
    assert out["loaded"] == []
