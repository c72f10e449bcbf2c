"""Which collectives run where the card is shared: two processes on one CUDA
card over gloo with CUDA tensors, then a world-size-1 NCCL group in this
process. Prints one result a check (`all_reduce`, `broadcast`,
`all_gather`, `all_gather_into_tensor`, `reduce_scatter_tensor` and one
FSDP2 step, the collectives `fully_shard` needs); it decides how the mesh
paths are held on a machine with one card.

    python -m clipself_tpu_torch.tools.collectives_probe
"""

from __future__ import annotations

import socket
import subprocess
import sys

import torch
import torch.distributed as dist
from torch import nn


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def checks(rank: int, world: int, dev: torch.device) -> dict:
    """Each collective on ``dev``: "ok" or the error it raised."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    out = {}

    def run(name, fn):
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as e:  # a probe reports every failure and goes on
            out[name] = f"FAIL {type(e).__name__}: {str(e).splitlines()[0][:160]}"

    x = torch.full((8,), float(rank + 1), device=dev)

    def fsdp_step():
        m = nn.Sequential(nn.Linear(16, 16), nn.Linear(16, 4)).to(dev)
        mesh = init_device_mesh("cuda", (world,))
        fully_shard(m[0], mesh=mesh)
        fully_shard(m, mesh=mesh)
        m(torch.randn(4, 16, device=dev)).sum().backward()

    run("all_reduce", lambda: dist.all_reduce(x))
    run("broadcast", lambda: dist.broadcast(x, 0))
    run("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x))
    run("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(torch.empty(8 * world, device=dev), x))
    run("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(torch.empty(8 // world, device=dev), x))
    run("fsdp2_step", fsdp_step)
    return out


def _rank(rank: int, world: int, port: int, queue) -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
        queue.put((rank, checks(rank, world, dev)))
    except Exception as e:  # reported by the parent
        queue.put((rank, {"init": f"FAIL {e}"}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("collectives_probe: no CUDA card", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for _ in procs:
            rank, res = queue.get(timeout=120)
            print(f"gloo, two processes on one card, rank {rank}: {res}", flush=True)
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_port()}", rank=0, world_size=1)
    try:
        print(f"nccl, world size 1: {checks(0, 1, torch.device('cuda', 0))}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
