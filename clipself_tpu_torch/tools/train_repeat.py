"""Does the distill step repeat itself? `train.main` run several times from
the same seeded weights and synthetic batch, each run in this process, with
or without a one-process launch (a (1, 1, 1) mesh: a world-size-1 NCCL group,
FSDP2 and the tensor-parallel plan); prints each run's losses and the
pairwise differences: the losses, the first step's gradient of one
parameter (before AdamW) and that parameter after the run.

    python -m clipself_tpu_torch.tools.train_repeat --runs plain plain sharded

Defaults: EVA02-CLIP-B-16 at 1024², batch 2, 20 crops, bf16, 6 steps, every
block unlocked, block 11's `mlp.w3`. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import socket
import sys
import time

import torch


@contextlib.contextmanager
def one_process_launch():
    """The launcher's variables of one process for the call, and the group
    `train.main` starts destroyed after it."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if dist.is_initialized():
            dist.destroy_process_group()


def run_once(argv: list[str], name: str, sharded: bool) -> dict:
    """One run of `train.main` with ``argv``, under `one_process_launch`
    where ``sharded``: its logged steps ("history"), losses, the first
    step's gradient of ``name`` and ``name`` after the run (float32 on the
    host), the mesh's shape (None without one) and how many modules carry
    a tensor-parallel group."""
    from clipself_tpu_torch.parallel.mesh import full_leaf
    from clipself_tpu_torch.train import main as train_main
    from clipself_tpu_torch.train.optim import Optimizer

    update, first = Optimizer.step, []

    def step(opt, count):
        if count == 0:
            g = dict(zip(opt.names, opt.params))[name].grad
            g = g if opt.mesh is None else full_leaf(name, g, opt.mesh)
            first.append(g.float().cpu().clone())
        update(opt, count)

    Optimizer.step = step
    try:
        with one_process_launch() if sharded else contextlib.nullcontext():
            run = train_main.main(argv)
            mesh, model = run["mesh"], run["state"].model
            p = dict(model.named_parameters())[name]
            after = (p if mesh is None else full_leaf(name, p, mesh)).float().cpu().clone()
    finally:
        Optimizer.step = update
    return {
        "history": run["history"], "losses": [h["loss"] for h in run["history"]], "grad": first[0],
        "after": after, "mesh": None if mesh is None else mesh.shape,
        "tp_modules": sum(getattr(m, "tp", None) is not None for m in model.modules()),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser("train_repeat")
    p.add_argument("--runs", nargs="+", choices=["plain", "sharded"], default=["plain", "plain", "sharded"])
    p.add_argument("--model", default="EVA02-CLIP-B-16")
    p.add_argument("--det-image-size", type=int, default=1024)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--param", default="visual.blocks.11.mlp.w3.weight")
    p.add_argument("--device", default="cuda")
    p.add_argument("--logs", default="build/train_repeat_logs")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("train_repeat: no CUDA card", file=sys.stderr)
        return 1
    from clipself_tpu_torch.core.config import get_model_config

    layers = get_model_config(args.model).vision.layers
    base = [
        "--synthetic", "--model", args.model, "--precision", "bf16", "--device", args.device,
        "--batch-size", "2", "--det-image-size", str(args.det_image_size), "--max-boxes", "20",
        "--lock-image-unlocked-groups", str(layers), "--steps-per-epoch", str(args.steps), "--epochs", "1",
        "--log-every-n-steps", "1", "--lr", "1e-5", "--warmup", "1", "--seed", "0", "--logs", args.logs,
    ]
    if torch.device(args.device).type == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    results = []
    for i, kind in enumerate(args.runs):
        t0 = time.perf_counter()
        r = run_once(base + ["--name", f"run{i}"], args.param, kind == "sharded")
        results.append((f"{kind}{i}", r))
        print(f"{kind}{i}: {time.perf_counter() - t0:.1f} s, losses {[round(x, 7) for x in r['losses']]}", flush=True)
    for (a, ra), (b, rb) in itertools.combinations(results, 2):
        later = max(abs(x - y) / abs(y) for x, y in zip(ra["losses"][1:], rb["losses"][1:]))
        grad = ((ra["grad"] - rb["grad"]).abs().max() / rb["grad"].abs().max()).item()
        after = (ra["after"] - rb["after"]).abs().max().item()
        print(f"{a} vs {b}: first loss |d| {abs(ra['losses'][0] - rb['losses'][0]):.3e}, first-step gradient "
              f"max rel {grad:.3e}, later losses max rel {later:.3e}, {args.param} after the run max |d| "
              f"{after:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
