"""The mesh paths on the card, two ranks at EVA02-CLIP-B/16's full width (2
of its 12 blocks, 448^2 images, 4 crops an image at 224^2, float32): dp 2
and tp 2 against the same step in one process. Over NCCL where the machine
has two cards; on one card the two ranks share it over gloo (two processes
on one H100 run every collective FSDP2 needs over gloo with CUDA tensors:
`python -m clipself_tpu_torch.tools.collectives_probe`). Marked `cuda`:
skipped without a card.

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py -q

Tolerances: float32 kernels and products summed in other groupings (a
row-parallel sum, a two-rank gradient average), and the flash backward's dQ
and the RoI-align backward summed by atomics, in no fixed order even in one
process: the losses of both steps 1e-5 relative, the first step's gradient
of `mlp.w3` 1e-5 of its largest entry. The weights after AdamW are not
compared: Adam divides by sqrt(v) + eps, so an entry whose gradient is near
zero turns that noise into a visible update (a single process does not
repeat them either). Each rank launches the flash, RoPE and LayerNorm
kernels."""

import copy
import dataclasses
import socket
import traceback

import pytest
import torch

STEPS, BATCH, IMAGE, CROPS, LAYERS = 2, 2, 448, 4, 2
W3 = "visual.blocks.1.mlp.w3.weight"
LOSS_REL, GRAD_REL = 1e-5, 1e-5


def _cfg():
    from clipself_tpu_torch.core.config import get_model_config

    cfg = get_model_config("EVA02-CLIP-B-16")
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=LAYERS))


def _run(device, mesh_shape=None):
    """Two distill steps; the losses, the first step's full w3 gradient and
    the kernel launches."""
    from functools import partial

    from clipself_tpu_torch.data.loader import SyntheticDistillData
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.ops import attention, layer_norm, rope_roll
    from clipself_tpu_torch.parallel.mesh import create_mesh, full_leaf, shard_batch, shard_model
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import Optimizer, make_schedule, set_trainable
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    cfg = _cfg()
    model = create_model(cfg, device=device, dtype=torch.float32, seed=0)
    teacher = copy.deepcopy(model).requires_grad_(False)
    host = SyntheticDistillData(batch_size=BATCH, det_size=IMAGE, crop_size=224, max_anns=CROPS).batch
    mesh = None
    if mesh_shape is not None:
        mesh = create_mesh(mesh_shape, device)
        set_trainable(model, LAYERS, LAYERS)
        shard_model(model, cfg, mesh)
        shard_model(teacher, cfg, mesh)
        host = shard_batch(mesh, host)
    opt = Optimizer(model, make_schedule("const", 1e-5, 0, STEPS), unlocked_groups=LAYERS,
                    num_layers=LAYERS, mesh=mesh)
    state = TrainState(model, opt)
    grads, update = [], opt.step

    def step_after_reading_the_gradient(count):
        if count == 0:
            g = dict(zip(opt.names, opt.params))[W3].grad
            grads.append((g if mesh is None else full_leaf(W3, g, mesh)).detach().cpu().numpy().copy())
        update(count)

    opt.step = step_after_reading_the_gradient
    group = None if mesh is None else mesh.batch_group
    step = make_train_step(partial(clipself_loss, group=group), teacher, mesh=mesh)
    batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    counters = (attention.LAUNCHES, attention.BWD_LAUNCHES, rope_roll.LAUNCHES, layer_norm.LAUNCHES,
                layer_norm.BWD_LAUNCHES)
    for c in counters:
        c.reset()
    losses = [float(step(state, batch)["loss"]) for _ in range(STEPS)]
    return losses, grads[0], [c.count for c in counters]


def _rank(rank, port, mesh_shape, backend, queue):
    import torch.distributed as dist

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
        queue.put((rank, _run(device, mesh_shape)))
    except Exception:  # handed to the test process, which raises it
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def single():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _run(torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (1, 1, 2)], ids=["dp2", "tp2"])
def test_two_ranks_match_one_process(single, mesh_shape):
    import torch.multiprocessing as mp

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, mesh_shape, backend, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=600) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [v for v in got.values() if isinstance(v, str)]
    assert not errors, errors[0]
    losses, w3, launches = single
    for rank in (0, 1):
        r_losses, r_w3, r_launches = got[rank]
        for a, b in zip(r_losses, losses):
            assert abs(a - b) <= LOSS_REL * abs(b), (rank, r_losses, losses)
        assert abs(r_w3 - w3).max() <= GRAD_REL * abs(w3).max(), rank
        assert all(r_launches), (rank, r_launches)
