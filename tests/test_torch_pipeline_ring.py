"""The port's GPipe pipeline (`clipself_tpu_torch/parallel/pipeline.py`) and
ring attention (`clipself_tpu_torch/ops/ring_attention.py`) on the CPU,
held against the JAX package's `pipeline_apply` and `ring_attention` on its
simulated 8-device mesh (`tests/conftest.py`), case for case with
`tests/test_pipeline.py` and `tests/test_ring_attention.py` on their numpy
seeds. One 8-rank gloo group, spawned once for the module
(`tests/torch_parallel_cases.py::pipeline_ring_cases`), runs every case; a
case over a group of S ranks runs on each run of S consecutive ranks at
once. This process computes the JAX references while the ranks run.

Bars, the JAX tests' own: the pipeline against JAX and the sequential
blocks 1e-6 (toy blocks) and 1e-5 (the tiny EVA tower's blocks, JAX seed-0
weights through `state_dict_from_jax`); the toy gradients at 4 stages 1e-5;
the ring against JAX and the XLA full attention 2e-5 at rings 2, 4 and 8
and beside a data axis, its gradients at ring 4 5e-5. Beyond the JAX tests:
the pipeline's gradients with stage 0 frozen and an input that needs no
gradient (its exchanges must still pair up) against JAX's 1e-5; the EVA
blocks' gradients through the pipeline against the same blocks in turn on
the rank, 1e-5 of each tensor's largest entry (the same float32 operations,
the pipeline's selections and zero sums aside); the stack EQUAL to JAX's;
the shape errors in the JAX package's words; `ppermute` EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch
import torch_parallel_cases as cases
from test_pipeline import _apply_toy, _sequential, _toy_blocks
from test_ring_attention import _qkv
from clipself_tpu.core.config import get_model_config as jax_model_config
from clipself_tpu.models.eva_vit import EvaBlock as JaxEvaBlock
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.ops.attention import multi_head_attention
from clipself_tpu.ops.ring_attention import _ring_local, ring_attention
from clipself_tpu.parallel.mesh import create_mesh
from clipself_tpu.parallel.pipeline import pipeline_apply, stack_block_params, unstack_block_params
from clipself_tpu_torch.models.torch_io import state_dict_from_jax
from clipself_tpu_torch.parallel import pipeline as ppipeline

from torch_threads import capped_threads  # noqa: F401  (module fixture)

WORLD = 8
PIPE_TOL, EVA_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-5
RING_TOL, RING_GRAD_TOL = 2e-5, 5e-5


def _flat(blocks: dict) -> dict:
    """`_toy_blocks`' JAX tree as a state dict of the port's names."""
    return {f"blocks.{i}.{n}": np.asarray(v) for i in range(len(blocks)) for n, v in blocks[f"blocks_{i}"].items()}


@pytest.fixture(scope="module")
def run():
    """The ranks' results and this process's JAX references."""
    toy = _toy_blocks()
    pipe_x = np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32)
    grad_x = np.random.default_rng(2).normal(size=(8, 16)).astype(np.float32)
    cfg = jax_model_config(cases.NAME)
    _, params = jax_create_model(cfg, dtype=jnp.float32, seed=0)
    grid = (cfg.vision.grid_size, cfg.vision.grid_size)
    tokens = np.random.default_rng(3).normal(size=(4, grid[0] * grid[1] + 1, cfg.vision.width)).astype(np.float32)
    qkv = {n: np.asarray(t) for n, t in zip("qkv", _qkv())}
    grad_qkv = {n: np.asarray(t) for n, t in zip("qkv", _qkv(seed=1))}
    data_qkv = {n: np.asarray(t) for n, t in zip("qkv", _qkv(b=4, seed=2))}
    payload = {
        "toy": _flat(toy), "pipe_x": pipe_x, "grad_x": grad_x, "tokens": tokens,
        "state_dict": {k: v for k, v in state_dict_from_jax(params).items() if k.startswith("visual.blocks.")},
        "ring_qkv": qkv, "ring_grad_qkv": grad_qkv, "ring_data_qkv": data_qkv,
    }
    group = cases.Group(WORLD, payload, cases="pipeline_ring_cases")

    ref = {}
    stacked, n = stack_block_params(toy)
    x = jnp.asarray(pipe_x)
    ref["sequential"] = np.asarray(_sequential(toy, x, n))
    ref["pipeline"] = {
        (s, m): np.asarray(pipeline_apply(create_mesh(s, axis_names=("pp",)), stacked, _apply_toy, x, m))
        for s, m in cases.PIPELINES
    }
    mesh = create_mesh(cases.GRAD_STAGES, axis_names=("pp",))
    gx = jnp.asarray(grad_x)
    ref["toy_grads"] = jax.grad(
        lambda st, x: jnp.sum(pipeline_apply(mesh, st, _apply_toy, x, cases.GRAD_STAGES) ** 2), argnums=(0, 1)
    )(stacked, gx)
    g_seq, gx_seq = jax.grad(lambda p, x: jnp.sum(_sequential(p, x, n) ** 2), argnums=(0, 1))(toy, gx)
    ref["toy_grads_seq"] = (stack_block_params(g_seq)[0], gx_seq)

    vparams = dict(params["visual"])
    block = JaxEvaBlock(cfg.vision, dtype=jnp.float32, attn_impl="xla")

    def apply_block(blk, h):
        return block.apply({"params": blk}, h, grid)

    jt = jnp.asarray(tokens)
    ref["eva"] = np.asarray(pipeline_apply(
        create_mesh(cases.EVA_STAGES, axis_names=("pp",)), stack_block_params(vparams)[0], apply_block, jt,
        cases.EVA_STAGES,
    ))
    for i in range(cfg.vision.layers):
        jt = apply_block(vparams[f"blocks_{i}"], jt)
    ref["eva_sequential"] = np.asarray(jt)

    q, k, v = (jnp.asarray(qkv[c]) for c in "qkv")
    scale = qkv["q"].shape[-1] ** -0.5
    ref["full"] = np.asarray(multi_head_attention(q, k, v, scale, impl="xla"))
    ref["ring"] = {
        size: np.asarray(ring_attention(create_mesh(size, axis_names=("sp",)), q, k, v, scale))
        for size in cases.RINGS
    }
    q, k, v = (jnp.asarray(grad_qkv[c]) for c in "qkv")
    ring_mesh = create_mesh(cases.GRAD_RING, axis_names=("sp",))
    ref["ring_grads"] = jax.grad(
        lambda q, k, v: jnp.sum(ring_attention(ring_mesh, q, k, v, scale) ** 2), argnums=(0, 1, 2)
    )(q, k, v)
    ref["full_grads"] = jax.grad(
        lambda q, k, v: jnp.sum(multi_head_attention(q, k, v, scale, impl="xla") ** 2), argnums=(0, 1, 2)
    )(q, k, v)
    q, k, v = (jnp.asarray(data_qkv[c]) for c in "qkv")
    ref["data_full"] = np.asarray(multi_head_attention(q, k, v, scale, impl="xla"))
    data_mesh = create_mesh(WORLD, axis_names=("data", "sp"), shape=cases.DATA_SP)
    spec = P("data", "sp")
    ref["ring_data"] = np.asarray(jax.shard_map(
        lambda q, k, v: _ring_local(q, k, v, scale, "sp"), mesh=data_mesh, in_specs=(spec, spec, spec),
        out_specs=spec,
    )(*(jax.device_put(t, NamedSharding(data_mesh, spec)) for t in (q, k, v))))

    errors = {}
    for name, call in (
        ("blocks", lambda: pipeline_apply(mesh, {"w": jnp.zeros((6, 2))}, _apply_toy, x, 4)),
        ("batch", lambda: pipeline_apply(create_mesh(2, axis_names=("pp",)), stacked, _apply_toy, x, 3)),
    ):
        with pytest.raises(AssertionError) as e:
            call()
        errors[name] = str(e.value)
    ref["errors"] = errors
    return {"ranks": group.results(), "ref": ref}


def _stage_rows(tree: dict, stage: int, stages: int) -> dict:
    """Stage ``stage``'s rows of each stacked JAX leaf."""
    return {k: np.asarray(v)[stage * len(v) // stages:(stage + 1) * len(v) // stages] for k, v in tree.items()}


def _gathered(ranks: list, key, size: int, axis: int = 1) -> list:
    """Each group of ``size`` consecutive ranks' shards of ``key`` joined
    along ``axis``, group by group."""
    return [np.concatenate([ranks[r][key] if not callable(key) else key(ranks[r])
                            for r in range(first, first + size)], axis)
            for first in range(0, WORLD, size)]


@pytest.mark.parametrize("blocks", [8, 12])
def test_stack_equals_jax_and_round_trips(blocks):
    """The stack in the numeric order of the names (blocks.10 after
    blocks.9), EQUAL to JAX's, and back."""
    toy = _toy_blocks(n_blocks=blocks)
    # in the names' string order: blocks.10 and blocks.11 come before blocks.2
    params = {k: torch.tensor(v) for k, v in sorted(_flat(toy).items())}
    stacked, n = ppipeline.stack_block_params(params)
    want, jn = stack_block_params(toy)
    assert n == jn == blocks
    for name in ("w", "b"):
        np.testing.assert_array_equal(stacked[name].numpy(), np.asarray(want[name]))
    back = ppipeline.unstack_block_params(stacked)
    assert back.keys() == params.keys()
    for key, t in params.items():
        np.testing.assert_array_equal(back[key].numpy(), t.numpy())
    jback = unstack_block_params(want)
    np.testing.assert_array_equal(back["blocks.1.w"].numpy(), np.asarray(jback["blocks_1"]["w"]))


@pytest.mark.parametrize("stages,microbatches", cases.PIPELINES)
def test_pipeline_matches_jax_and_sequential(run, stages, microbatches):
    want = run["ref"]["pipeline"][stages, microbatches]
    for rank, r in enumerate(run["ranks"]):
        got = r["pipeline"][stages, microbatches]
        np.testing.assert_allclose(got, want, atol=PIPE_TOL, rtol=0, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, run["ref"]["sequential"], atol=PIPE_TOL, rtol=0, err_msg=f"rank {rank}")


def test_pipeline_gradients_match_jax(run):
    """Each stage's gradient, and x's on the ranks of stage 0 (zero on the
    others), against JAX's through its pipeline and the sequential blocks."""
    (g_pp, gx_pp), (g_seq, gx_seq) = run["ref"]["toy_grads"], run["ref"]["toy_grads_seq"]
    s = cases.GRAD_STAGES
    for rank, r in enumerate(run["ranks"]):
        stage, got = rank % s, r["toy_grads"]
        for want in (_stage_rows(g_pp, stage, s), _stage_rows(g_seq, stage, s)):
            assert got["grads"].keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got["grads"][k], want[k], atol=GRAD_TOL, rtol=0, err_msg=f"{rank} {k}")
        if stage == 0:
            np.testing.assert_allclose(got["x"], np.asarray(gx_pp), atol=GRAD_TOL, rtol=0)
            np.testing.assert_allclose(got["x"], np.asarray(gx_seq), atol=GRAD_TOL, rtol=0)
        else:
            assert not got["x"].any(), rank


def test_pipeline_pairs_up_with_a_frozen_first_stage(run):
    """Stage 0 frozen and x needing no gradient: every exchange still has a
    backward on every rank, and the later stages' gradients are JAX's."""
    g_pp, _ = run["ref"]["toy_grads"]
    s = cases.GRAD_STAGES
    for rank, r in enumerate(run["ranks"]):
        stage, got = rank % s, r["frozen_first_grads"]
        assert got["x"] is None
        if stage == 0:
            assert all(g is None for g in got["grads"].values()), rank
            continue
        for k, want in _stage_rows(g_pp, stage, s).items():
            np.testing.assert_allclose(got["grads"][k], want, atol=GRAD_TOL, rtol=0, err_msg=f"{rank} {k}")


def test_pipeline_on_eva_blocks(run):
    """Two stages over the tiny tower's real EVA blocks (JAX seed-0 weights)
    equal JAX's pipeline and its sequential trunk."""
    for rank, r in enumerate(run["ranks"]):
        np.testing.assert_allclose(r["eva"], run["ref"]["eva"], atol=EVA_TOL, rtol=0, err_msg=f"rank {rank}")
        np.testing.assert_allclose(r["eva"], run["ref"]["eva_sequential"], atol=EVA_TOL, rtol=0,
                                   err_msg=f"rank {rank}")


def test_pipeline_gradients_on_eva_blocks_match_the_blocks_in_turn(run):
    for rank, r in enumerate(run["ranks"]):
        assert len(r["eva_grads"]) > 10
        for k, (got, want) in r["eva_grads"].items():
            assert np.abs(want).max() > 0, k
            np.testing.assert_allclose(got, want, atol=EVA_TOL * np.abs(want).max(), rtol=0, err_msg=f"{rank} {k}")


@pytest.mark.parametrize("ring", cases.RINGS)
def test_ring_matches_jax_and_full_attention(run, ring):
    for got in _gathered(run["ranks"], lambda r: r["ring"][ring], ring):
        np.testing.assert_allclose(got, run["ref"]["ring"][ring], atol=RING_TOL, rtol=0)
        np.testing.assert_allclose(got, run["ref"]["full"], atol=RING_TOL, rtol=0)


def test_ring_gradients_match_jax(run):
    size = cases.GRAD_RING
    for i, name in enumerate("qkv"):
        for got in _gathered(run["ranks"], lambda r: r["ring_grads"][i], size):
            np.testing.assert_allclose(got, np.asarray(run["ref"]["ring_grads"][i]), atol=RING_GRAD_TOL, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(got, np.asarray(run["ref"]["full_grads"][i]), atol=RING_GRAD_TOL, rtol=0,
                                       err_msg=name)


def test_ring_composes_with_data_axis(run):
    """(data 2, sp 4): each data row's ring of 4 ranks holds its rows of the
    batch; joined, they equal JAX's shard_map of `_ring_local` and the full
    attention."""
    got = np.concatenate(_gathered(run["ranks"], "ring_data", cases.DATA_SP[1]), 0)
    np.testing.assert_allclose(got, run["ref"]["ring_data"], atol=RING_TOL, rtol=0)
    np.testing.assert_allclose(got, run["ref"]["data_full"], atol=RING_TOL, rtol=0)


def test_shape_errors_name_what_the_jax_package_names(run):
    for rank, r in enumerate(run["ranks"]):
        errors = r["errors"]
        assert errors["blocks"] == run["ref"]["errors"]["blocks"] == "6 blocks must divide into 4 stages"
        assert errors["batch"] == run["ref"]["errors"]["batch"] == "batch 16 must divide into 3 microbatches"
        assert errors["sequence"] == "a sequence of 63 must divide over 2 ranks", rank


def test_ppermute_sends_forward_and_its_gradient_back(run):
    """Rank r receives rank r - 1's tensor; the gradient of rank r + 1's
    loss (its received tensor times r + 2) comes back to rank r."""
    for rank, r in enumerate(run["ranks"]):
        y, grad = r["ppermute"]
        np.testing.assert_array_equal(y, np.full(3, (rank - 1) % WORLD, np.float32))
        np.testing.assert_array_equal(grad, np.full(3, (rank + 1) % WORLD + 1, np.float32))
