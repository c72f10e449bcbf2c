"""The two tiny CoCas that `test_torch_coca.py` and
`test_torch_coca_generate.py` hold the port against the JAX package on, in
float32 on the CPU:

  - "eva": `EVA02-CLIP-Tiny-Test` (2 blocks, width 64, RoPE, 32^2 images)
    with the `embed_cls` text tower and a 2-layer decoder of 2 heads, as
    `tests/test_model_zoo.py:128-148` builds it: the caption's image tokens
    are the tower's 16 final-norm patch tokens;
  - "vit": `ViT-Tiny-Test` (2 blocks, width 64) with the attentional pooler
    (5 queries, 2 heads): the image embedding is the first pooled token,
    the caption's image tokens the other 4.

Both have a 16-token context (17 positions with the CLS token) and the
512-token vocabulary of the tiny configs. Their weights are seeded noise
on the shapes of `jax.eval_shape` of the JAX init (no init is compiled),
carried over with `state_dict_from_jax` and loaded strictly."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core import config as jconfig
from clipself_tpu.models.coca import CoCa as JCoCa
from clipself_tpu_torch.core import config
from clipself_tpu_torch.models.coca import CoCa
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax

CTX = 16
SOT, EOT = 1, 2
CASES = ("eva", "vit")


def coca_config(case: str, pkg=config):
    """The tiny CoCa config of ``case`` from one package's config module."""
    base = pkg.get_model_config("EVA02-CLIP-Tiny-Test" if case == "eva" else "ViT-Tiny-Test")
    vision = base.vision
    if case == "vit":
        vision = dataclasses.replace(vision, attentional_pool=True, n_queries=5, attn_pooler_heads=2)
    return dataclasses.replace(
        base,
        vision=vision,
        text=dataclasses.replace(base.text, embed_cls=True, context_length=CTX),
        multimodal=pkg.MultimodalConfig(
            context_length=CTX, vocab_size=base.text.vocab_size, width=base.embed_dim, heads=2, layers=2,
        ),
    )


def inputs(seed: int = 0):
    """Two images [2, 32, 32, 3] and two id rows [2, CTX]: the first full,
    the second padded with the pad id 0 from position 9 on."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    txt = rng.integers(3, 512, (2, CTX)).astype(np.int32)
    txt[:, 0] = SOT
    txt[1, 8] = EOT
    txt[1, 9:] = 0
    return img, txt


def noisy_params(shapes, seed: int):
    """Seeded noise on every leaf of a flax shape tree: LayerNorm scales
    around 1, biases and vectors of spread 0.1, kernels and tables of
    spread 1/sqrt(fan-in), `logit_scale` around log(1/0.07)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.2 * n
        if name == "logit_scale":
            return np.float32(np.log(1 / 0.07)) + 0.1 * n
        if len(s.shape) < 2:
            return 0.1 * n
        return n / np.float32(np.sqrt(np.prod(s.shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def build(case: str):
    """(JAX model, params as NumPy, port model with those weights, port
    config, JAX config) of ``case``."""
    jcfg, cfg = coca_config(case, jconfig), coca_config(case)
    jmodel = JCoCa(jcfg, dtype=jnp.float32)
    img, txt = inputs()
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img, txt))["params"]
    params = noisy_params(shapes, seed=7 if case == "eva" else 8)
    model = CoCa(cfg, torch.float32).eval()
    load_weights(model, state_dict_from_jax(params, cfg))
    return jmodel, params, model, cfg, jcfg
