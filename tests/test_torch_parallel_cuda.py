"""The mesh paths on the card, two ranks at EVA02-CLIP-B/16's full width (2
of its 12 blocks, 448^2 images, 4 crops an image at 224^2, float32): dp 2
and tp 2 against the same step in one process; the OpenCLIP ViT at tp 2:
ViT-L-14-336's step at 896^2 (2 of its 24 blocks, 8 of its 16 heads a
rank) and ViT-B-16's v1 evaluator batch at 1024^2. Over NCCL where the machine
has two cards; on one card the two ranks share it over gloo (two processes
on one H100 run every collective FSDP2 needs over gloo with CUDA tensors:
`python -m clipself_tpu_torch.tools.collectives_probe`). Marked `cuda`:
skipped without a card.

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py -q

Tolerances: float32 kernels and products summed in other groupings (a
row-parallel sum, a two-rank gradient average): the losses of both steps
1e-5 relative, the first step's gradient of `mlp.w3` 1e-5 of its largest
entry. The weights after AdamW are not compared: Adam divides by sqrt(v) +
eps, so an entry whose gradient is near zero turns a last-bit difference of
the average into a visible update. Each rank launches the flash, RoPE and
LayerNorm kernels.

The detector trainer: `detector.train.main --synthetic` at `ov_coco_vitb16`
(the B/16 trunk at 640^2), global batch 8, float32, on a `data` mesh of the
two ranks (the launcher's variables set, the group started over gloo or
NCCL as above) against one process, cuDNN's TF32 off in both (a float32
convolution would otherwise round its inputs to TF32, differently for
batches of 4 and of 8): the first loss within 1e-6 relative (the same
float32 operations on 4 images a rank; each rank's share of the loss summed
over the two), the heads after the two steps within 1e-5 (the CPU mesh bar
of `tests/test_torch_parallel.py`); rank 0 alone writes the checkpoint.

The GPipe pipeline (`parallel/pipeline.py`): EVA02-CLIP-L-14-336's 24 blocks
at 896^2 over 2 stages of 12, batch 2 in 2 microbatches of one image,
float32, its weights and tokens drawn on the card from seeded CUDA
generators in each process, against the 24 blocks in turn in one process:
the output within 1e-5 and every stage leaf's gradient of a sum-of-squares
loss within 1e-4 of each tensor's largest entry (the same float32 kernels;
the products' row counts and the two microbatches' gradient sums differ);
each rank launches each kernel once a block and microbatch it computes,
four LayerNorms a block, each way."""

import copy
import dataclasses
import socket
import traceback

import numpy as np
import pytest
import torch

from torch_threads import capped_threads  # noqa: F401  (module fixture)

STEPS, BATCH, IMAGE, CROPS, LAYERS = 2, 2, 448, 4, 2
W3 = "visual.blocks.1.mlp.w3.weight"
LOSS_REL, GRAD_REL = 1e-5, 1e-5
DET_FIRST_LOSS_REL, DET_HEADS_ATOL = 1e-6, 1e-5
DET_ARGV = ["--synthetic", "--preset", "ov_coco_vitb16", "--batch-size", "8", "--epochs", "1",
            "--steps-per-epoch", "2", "--log-every", "1", "--precision", "fp32"]


# the pipeline: the model and image size, stages and microbatches, the bars
PP_CASE, PP_STAGES, PP_MICROBATCHES = ("EVA02-CLIP-L-14-336", 896), 2, 2
PP_OUT_REL, PP_GRAD_REL = 1e-5, 1e-4

# the tensor-parallel OpenCLIP ViT step: ViT-L-14-336 at 896^2 (8 of its 16
# heads on each rank), 4 crops at its 336^2, and the weight whose first
# gradient is compared; ViT-B-16's v1 evaluator batch at 1024^2
VIT_L14 = ("ViT-L-14-336", 896, 336, "visual.transformer.resblocks.1.mlp.c_proj.weight")
V1_IMAGE, V1_BOXES, V1_REL = 1024, 20, 1e-5


def _cfg(name="EVA02-CLIP-B-16"):
    from clipself_tpu_torch.core.config import get_model_config

    cfg = get_model_config(name)
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=LAYERS))


def _run(device, mesh_shape=None, case=("EVA02-CLIP-B-16", IMAGE, 224, W3)):
    """Two distill steps of ``case`` (model, image size, crop size, the
    weight read); the losses, the first step's full gradient of that weight
    and the kernel launches."""
    from functools import partial

    from clipself_tpu_torch.data.loader import SyntheticDistillData
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.ops import attention, layer_norm, rope_roll
    from clipself_tpu_torch.parallel.mesh import create_mesh, full_leaf, shard_batch, shard_model
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import Optimizer, make_schedule, set_trainable
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    name, image, crop, weight = case
    cfg = _cfg(name)
    model = create_model(cfg, device=device, dtype=torch.float32, seed=0)
    teacher = copy.deepcopy(model).requires_grad_(False)
    host = SyntheticDistillData(batch_size=BATCH, det_size=image, crop_size=crop, max_anns=CROPS).batch
    mesh = None
    if mesh_shape is not None:
        mesh = create_mesh(mesh_shape, device)
        set_trainable(model, LAYERS, LAYERS)
        shard_model(model, mesh)
        shard_model(teacher, mesh)
        host = shard_batch(mesh, host)
    opt = Optimizer(model, make_schedule("const", 1e-5, 0, STEPS), unlocked_groups=LAYERS,
                    num_layers=LAYERS, mesh=mesh)
    state = TrainState(model, opt)
    grads, update = [], opt.step

    def step_after_reading_the_gradient(count):
        if count == 0:
            g = dict(zip(opt.names, opt.params))[weight].grad
            grads.append((g if mesh is None else full_leaf(weight, g, mesh)).detach().cpu().numpy().copy())
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


def _v1_batch(device, mesh_shape=None):
    """ViT-B-16's evaluator call at extract type v1 on one batch of 2 images
    at 1024^2 with 20 boxes and masks (`encode_rois_and_masks` with
    mask-attention pooling, as `eval/zero_shot.py` calls it), then its crops'
    embeddings, in float32; the features on the host and the launches."""
    from clipself_tpu_torch.data.synthetic import synthetic_panoptic_batch
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.ops import attention, layer_norm
    from clipself_tpu_torch.parallel.mesh import create_mesh, shard_model

    from clipself_tpu_torch.core.config import get_model_config

    cfg = get_model_config("ViT-B-16")
    model = create_model(cfg, device=device, dtype=torch.float32, seed=0).requires_grad_(False)
    if mesh_shape is not None:
        shard_model(model, create_mesh(mesh_shape, device))
    grid = V1_IMAGE // cfg.vision.patch_size
    b = synthetic_panoptic_batch(0, batch=2, image_size=V1_IMAGE, max_anns=V1_BOXES, valid_anns=V1_BOXES,
                                 crop_size=224, mask_hw=grid, n_classes=8)
    images, boxes, masks, crops = (torch.as_tensor(b[k], device=device) for k in ("images", "boxes", "gt_masks", "crops"))
    for c in (attention.LAUNCHES, layer_norm.LAUNCHES):
        c.reset()
    with torch.no_grad():
        rois, pooled = model.encode_rois_and_masks(images, boxes[..., :4], masks, extract_type="v1", mask_attn=True)
        emb = model.encode_image(crops.flatten(0, 1), normalize=True)
    out = {k: t.float().cpu().numpy() for k, t in (("rois", rois), ("masks", pooled), ("crops", emb))}
    return out, [attention.LAUNCHES.count, layer_norm.LAUNCHES.count]


def _rank(rank, port, mesh_shape, backend, queue, fn=_run, *args):
    import torch.distributed as dist

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
        queue.put((rank, fn(device, mesh_shape, *args)))
    except Exception:  # handed to the test process, which raises it
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _two_ranks(mesh_shape, fn=_run, *args) -> dict:
    """``fn(device, mesh_shape, *args)`` on two spawned ranks: rank -> result."""
    import torch.multiprocessing as mp

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, mesh_shape, backend, queue, fn) + args) for r in range(2)]
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
    return got


@pytest.fixture(scope="module")
def single():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _run(torch.device("cuda", 0))


def _match(got, single, rope=True):
    """Each rank's losses and first gradient against one process's, at the
    bars above, and every kernel launched on each rank (the RoPE kernel
    only where the tower has RoPE)."""
    losses, w3, launches = single
    for rank in (0, 1):
        r_losses, r_w3, r_launches = got[rank]
        for a, b in zip(r_losses, losses):
            assert abs(a - b) <= LOSS_REL * abs(b), (rank, r_losses, losses)
        assert abs(r_w3 - w3).max() <= GRAD_REL * abs(w3).max(), rank
        assert all(r_launches if rope else r_launches[:2] + r_launches[3:]), (rank, r_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (1, 1, 2)], ids=["dp2", "tp2"])
def test_two_ranks_match_one_process(single, mesh_shape):
    got = _two_ranks(mesh_shape)
    _match(got, single)
    assert all(single[2])
    for rank in (0, 1):
        assert got[rank][2] == single[2], (rank, got[rank][2], single[2])


@pytest.mark.cuda
def test_vit_l14_336_step_at_tp2_matches_one_process():
    """ViT-L-14-336 (2 of its blocks) at 896^2 on a (1, 1, 2) mesh, 8 of its
    16 heads of 64 on each rank, against one process: the distill bars
    above; each rank launches what the one process launches (no RoPE)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    single = _run(torch.device("cuda", 0), case=VIT_L14)
    torch.cuda.empty_cache()
    got = _two_ranks((1, 1, 2), _run, VIT_L14)
    _match(got, single, rope=False)
    for rank in (0, 1):
        assert got[rank][2] == single[2] and single[2][2] == 0, (rank, got[rank][2], single[2])


@pytest.mark.cuda
def test_vit_b16_v1_evaluator_batch_at_tp2_matches_one_process():
    """ViT-B-16's v1 evaluator batch (mask-attention pooling over a rank's 6
    of the 12 heads, its crops through the flash kernel at 6 heads) on a
    (1, 1, 2) mesh against one process, float32: the RoI, mask and crop
    features within 1e-5 of each tensor's largest entry (the row-parallel
    sums in another grouping); each rank launches what one process does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want, launches = _v1_batch(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    got = _two_ranks((1, 1, 2), _v1_batch)
    for rank in (0, 1):
        feats, r_launches = got[rank]
        assert r_launches == launches and all(launches), (rank, r_launches, launches)
        for k, w in want.items():
            np.testing.assert_allclose(feats[k], w, rtol=0, atol=V1_REL * np.abs(w).max(), err_msg=f"{rank} {k}")


def _det_run(device, out: str):
    """`detector.train.main` on ``DET_ARGV``: the logged losses, the heads
    after the run on the host, the mesh's shape and the files written."""
    import os

    from clipself_tpu_torch.detector import train

    torch.backends.cudnn.allow_tf32 = False
    run = train.main(DET_ARGV + ["--device", str(device), "--output", out])
    # as NumPy arrays: a tensor sent from a rank lives in its shared memory
    heads = {k: v.detach().cpu().numpy() for k, v in run["state"].model.state_dict().items()}
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    return [h["metrics"]["loss"] for h in run["history"]], heads, run["mesh"], files


def _det_rank(rank, port, backend, out, queue):
    import os

    import torch.distributed as dist

    local = rank if backend == "nccl" else 0
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(local), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
        queue.put((rank, _det_run(device, os.path.join(out, f"rank{rank}"))))
    except Exception:  # handed to the test process, which raises it
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
def test_detector_trainer_on_two_ranks_matches_one_process(tmp_path):
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        single = _det_run(torch.device("cuda", 0), str(tmp_path / "single"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_det_rank, args=(r, port, backend, str(tmp_path), queue)) for r in range(2)]
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
    losses, heads, mesh, files = single
    assert mesh is None and files == ["detector_epoch0.pkl"] and len(losses) == 2
    for rank in (0, 1):
        r_losses, r_heads, r_mesh, r_files = got[rank]
        assert r_mesh == (2, 1, 1)
        assert r_files == (["detector_epoch0.pkl"] if rank == 0 else [])
        assert abs(r_losses[0] - losses[0]) <= DET_FIRST_LOSS_REL * abs(losses[0]), (rank, r_losses, losses)
        assert r_heads.keys() == heads.keys()
        for name, want in heads.items():
            np.testing.assert_allclose(r_heads[name], want, rtol=0, atol=DET_HEADS_ATOL, err_msg=name)


def _pp_run(device, mesh_shape=None):
    """The pipeline's inputs on ``device`` and, in a process group, this
    rank's stage through `pipeline_apply` (otherwise every block in turn):
    the output and the gradients of a sum-of-squares loss on the host, and
    the kernel launches."""
    from torch.func import functional_call

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.models.eva_vit import EvaBlock, EvaViT
    from clipself_tpu_torch.ops import attention, layer_norm, rope_roll
    from clipself_tpu_torch.parallel.pipeline import pipeline_apply, stack_block_params, stage_params

    name, image = PP_CASE
    cfg = get_model_config(name)
    tower = EvaViT(cfg.vision, cfg.embed_dim).to(device)
    tower.init_weights(torch.Generator(device=device).manual_seed(0))
    stacked, layers = stack_block_params({k: v.detach() for k, v in tower.state_dict().items()})
    del tower
    grid = image // cfg.vision.patch_size
    block = EvaBlock(cfg.vision).to(device)

    def apply_block(blk, x):
        return functional_call(block, blk, (x, (grid, grid)))

    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((2, grid * grid + 1, cfg.vision.width), generator=gen, device=device)
    counters = (attention.LAUNCHES, attention.BWD_LAUNCHES, rope_roll.LAUNCHES, rope_roll.BWD_LAUNCHES,
                layer_norm.LAUNCHES, layer_norm.BWD_LAUNCHES)
    for c in counters:
        c.reset()
    if torch.distributed.is_initialized():
        leaves = {k: v.clone().requires_grad_() for k, v in stage_params(stacked).items()}
        y = pipeline_apply(leaves, apply_block, x, PP_MICROBATCHES)
    else:
        leaves = {k: v.requires_grad_() for k, v in stacked.items()}
        y = x
        for i in range(layers):
            y = apply_block({k: v[i] for k, v in leaves.items()}, y)
    y.square().sum().backward()
    torch.cuda.synchronize()
    grads = {k: v.grad.cpu().numpy() for k, v in leaves.items()}
    return y.detach().cpu().numpy(), grads, [c.count for c in counters]


@pytest.mark.cuda
def test_pipeline_of_eva02_l14_336_on_two_ranks_matches_one_process():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out, grads, _ = _pp_run(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    got = _two_ranks(None, _pp_run)
    layers = next(iter(grads.values())).shape[0]
    per = layers // PP_STAGES
    n = per * PP_MICROBATCHES  # each block of the stage on each microbatch's tick
    for rank in (0, 1):
        r_out, r_grads, r_launches = got[rank]
        assert r_launches == [n, n, n, n, 4 * n, 4 * n], (rank, r_launches)
        np.testing.assert_allclose(r_out, out, rtol=0, atol=PP_OUT_REL * np.abs(out).max(), err_msg=str(rank))
        assert r_grads.keys() == grads.keys()
        for k, g in grads.items():
            want = g[rank * per:(rank + 1) * per]
            np.testing.assert_allclose(r_grads[k], want, rtol=0, atol=PP_GRAD_REL * np.abs(want).max(),
                                       err_msg=f"{rank} {k}")
