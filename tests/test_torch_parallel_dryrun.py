"""The recipe-shape multi-process dryrun of the port on the CPU: the JAX
package's `__graft_entry__.py::dryrun_multichip(8, full)` (`:37-190`) with 8
gloo ranks of the port in place of 8 simulated devices. EVA02-CLIP-B-16 at
full width and depth with the JAX package's seed-0 weights, 4 images at 512²
with 20 crops each at 224² (`default_rng(0)`, as the dryrun draws them), one
clipself step on the (data 2, fsdp 2, model 2) mesh, against the JAX
single-device loss of the same weights and batch (`MULTICHIP_r05.json`
read 1.004351 for the JAX mesh). Tolerance: 1e-5 relative (float32 sums in
other groupings over a full B/16 step). Marked `slow` (outside tier-1): it
holds eight B/16 processes and one JAX single-device step at once, tens of
GiB.

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_parallel_dryrun.py -q -s
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_cases as cases
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.train import methods as jmethods
from clipself_tpu.train import optim as joptim
from clipself_tpu.train import step as jstep
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models.torch_io import state_dict_from_jax

MODEL, IMAGE, CROPS, CROP, BATCH = "EVA02-CLIP-B-16", 512, 20, 224, 4
LOSS_REL = 1e-5


def _dryrun_batch():
    """`dryrun_multichip`'s batch (`__graft_entry__.py:141-153`)."""
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 0.5, size=(BATCH, CROPS, 2)).astype(np.float32)
    hi = np.clip(lo + rng.uniform(0.05, 0.5, size=(BATCH, CROPS, 2)), 0, 1).astype(np.float32)
    return {
        "images": rng.normal(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
        "boxes": np.concatenate([lo, hi, np.ones((BATCH, CROPS, 1), np.float32)], -1),
        "crops": rng.normal(size=(BATCH, CROPS, CROP, CROP, 3)).astype(np.float32),
    }


@pytest.mark.slow
def test_recipe_shape_step_on_eight_ranks_matches_the_jax_single_device_loss():
    jmodel, params = jax_create_model(MODEL, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)
    batch = _dryrun_batch()
    t0 = time.perf_counter()
    group = cases.Group(8, {"model": MODEL, "state_dict": state_dict_from_jax(params), "batch": batch},
                        cases="dryrun_case")
    layers = get_model_config(MODEL).vision.layers
    sched = joptim.make_schedule("cosine", 1e-5, warmup=2, total_steps=10)
    tx = joptim.build_optimizer(params, sched, wd=0.1, unlocked_groups=layers, num_layers=layers)
    state = jstep.TrainState.create(jax.tree.map(jnp.asarray, params), tx)
    step = jstep.make_train_step(jmodel, tx, jmethods.clipself_loss)
    _, metrics = step(state, jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    want = float(metrics["loss"])
    got = group.results(timeout=3600.0)
    loss = got[0]["loss"]
    print(f"port (2, 2, 2) on 8 gloo ranks: loss {loss:.6f} (step {got[0]['seconds']:.1f} s); JAX single "
          f"device {want:.6f}; rel {abs(loss - want) / abs(want):.2e}; {time.perf_counter() - t0:.1f} s in all")
    assert all(r["loss"] == loss for r in got)
    assert abs(loss - want) <= LOSS_REL * abs(want)
