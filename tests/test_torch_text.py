"""The port's text tower (`clipself_tpu_torch/models/text_transformer.py`,
`CLIP.encode_text`, the masked attention of `ops/attention.py`, the text keys
of `models/torch_io.py`) against the JAX package's, float32 on the CPU with
the same weights (`state_dict_from_jax`) and the same seeded token ids.
Tolerance: 1e-4 absolute, the port's f32 bound (the tiny tower reads ~2e-6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.models.factory import get_tokenizer as jget_tokenizer
from clipself_tpu.ops.attention import _xla_attention
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.factory import create_model, get_tokenizer
from clipself_tpu_torch.models.text_transformer import TextTransformer
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.ops.attention import attention_masked

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
TOL = 1e-4


def _cfgs(get):
    """The tiny config and its text variants, from one package's registry."""
    cfg = get(NAME)
    return {
        "base": cfg,
        "layer_scale": dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, ls_init_value=0.5)),
        "no_mask": dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, attn_mask=False)),
        "quick_gelu": dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, quick_gelu=True)),
    }


def _tokens(seed: int, batch: int = 5, ctx: int = 16, vocab: int = 512) -> np.ndarray:
    """Token rows as `tokenize` lays them out: SOT, ids, EOT (the largest
    id), zero padding; one row fills the whole context."""
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, ctx), np.int32)
    for i in range(batch):
        n = ctx if i == 0 else int(rng.integers(2, ctx))
        out[i, :n] = rng.integers(1, vocab - 2, n)
        out[i, 0], out[i, n - 1] = vocab - 2, vocab - 1
    return out


@pytest.fixture(scope="module")
def towers():
    """variant -> (jax model, params as numpy, port CLIP with those weights);
    the layer-scale variant's gamma is drawn away from its init value."""
    jcfgs, cfgs = _cfgs(jget_model_config), _cfgs(get_model_config)
    _, base = jax_create_model(jcfgs["base"], dtype=jnp.float32, seed=0)
    base = jax.tree.map(np.asarray, base)
    rng = np.random.default_rng(1)
    out = {}
    for key, jcfg in jcfgs.items():
        # one init: the variants share the base tree (layer scale adds gammas)
        jmodel, _ = jax_create_model(jcfg, dtype=jnp.float32, init=False)
        params = base
        if key == "layer_scale":
            params = {**base, "text": dict(base["text"])}
            for i in range(jcfg.text.layers):
                blk = params["text"][f"resblocks_{i}"] = dict(base["text"][f"resblocks_{i}"])
                for ls in ("ls_1", "ls_2"):
                    blk[ls] = {"gamma": rng.uniform(0.2, 1.5, jcfg.text.width).astype(np.float32)}
        model = CLIP(cfgs[key], torch.float32).eval()
        load_weights(model, state_dict_from_jax(params))
        out[key] = (jmodel, params, model)
    return out


@pytest.fixture(scope="module")
def jax_encode_text():
    """One jitted `encode_text` per (model, normalize), shared by the cases."""
    return jax.jit(
        lambda model, params, tokens, normalize: model.apply(
            {"params": params}, tokens, normalize, method="encode_text"
        ),
        static_argnums=(0, 3),
    )


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
def test_encode_text_matches_jax(towers, jax_encode_text, normalize):
    jmodel, params, model = towers["base"]
    tokens = _tokens(0)
    want = np.asarray(jax_encode_text(jmodel, params, jnp.asarray(tokens), normalize))
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(tokens), normalize=normalize).numpy()
    assert got.shape == want.shape == (5, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", ["layer_scale", "no_mask", "quick_gelu"])
def test_encode_text_variants_match_jax(towers, jax_encode_text, variant):
    jmodel, params, model = towers[variant]
    tokens = _tokens(1)
    want = np.asarray(jax_encode_text(jmodel, params, jnp.asarray(tokens), False))
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if variant == "layer_scale":
        assert model.text.transformer.resblocks[0].ls_1.gamma.std() > 0.1  # not the init value


def test_features_match_jax(towers):
    jmodel, params, model = towers["base"]
    tokens = _tokens(2)
    want = np.asarray(
        jmodel.apply({"params": params}, jnp.asarray(tokens),
                     method=lambda m, t: m.text.features(t))
    )
    with torch.no_grad():
        got = model.text.features(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (5, 16, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_clip_forward_matches_jax(towers):
    jmodel, params, model = towers["base"]
    rng = np.random.default_rng(3)
    image = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = _tokens(3, batch=2)
    want = jmodel.apply({"params": params}, jnp.asarray(image), jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(image), torch.from_numpy(tokens))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_eot_pooling_takes_the_first_maximum(towers):
    """A row whose highest id repeats pools at its first position, as
    `jnp.argmax` does; `torch.argmax` documents the same."""
    jmodel, params, model = towers["base"]
    tokens = _tokens(4)
    tokens[1, 3] = tokens[1, 9] = 511  # two maxima in row 1
    tokens[1, 10:] = 0
    with torch.no_grad():
        feats = model.text.features(torch.from_numpy(tokens))
        got = model.text.project(feats, torch.from_numpy(tokens))
        at3, at9 = feats[1, [3, 9]] @ model.text.text_projection
    torch.testing.assert_close(got[1], at3, rtol=0, atol=1e-6)
    assert (got[1] - at9).abs().max() > 1e-3
    want = jmodel.apply({"params": params}, jnp.asarray(tokens), False, method="encode_text")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert int(torch.tensor([1, 7, 3, 7, 7]).argmax()) == 1


def test_state_dict_from_jax_equals_export_state_dict_with_text(towers):
    """Every key of the whole CLIP, text included, equal bit for bit to the
    JAX package's export; the port's module tree has exactly these keys."""
    for key in ("base", "layer_scale"):
        _, params, model = towers[key]
        ref = jtorch_io.export_state_dict(params, _cfgs(jget_model_config)[key])
        sd = state_dict_from_jax(params)
        assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
        assert any(k.startswith("text.transformer.resblocks.1.") for k in sd)
        for k, v in sd.items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_load_weights_is_strict_over_the_whole_clip(towers, tmp_path):
    _, params, _ = towers["base"]
    sd = state_dict_from_jax(params)
    model = create_model(NAME, device="cpu", dtype=torch.float32, seed=7)
    # the open_clip hub layout: text keys without the `text.` prefix
    hub = {(k[len("text."):] if k.startswith("text.") else k): v for k, v in sd.items()}
    torch.save({"state_dict": hub}, tmp_path / "hub.pt")
    load_weights(model, str(tmp_path / "hub.pt"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    no_text = {k: v for k, v in sd.items() if not k.startswith("text.")}
    with pytest.raises(KeyError, match="none of the .* text-tower keys"):
        load_weights(model, no_text)
    one_missing = dict(sd)
    del one_missing["text.transformer.resblocks.0.attn.in_proj_bias"]
    with pytest.raises(RuntimeError, match="in_proj_bias"):
        load_weights(model, one_missing)
    with pytest.raises(RuntimeError, match="text.cls_emb"):
        load_weights(model, {**sd, "text.cls_emb": torch.zeros(64)})


@pytest.mark.parametrize("masked", [True, False], ids=["causal", "no_mask"])
def test_attention_masked_matches_xla_attention(masked):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((3, 16, 2, 32)).astype(np.float32) for _ in range(3))
    n = q.shape[1]
    mask = np.triu(np.full((n, n), -np.inf, np.float32), k=1)[None, None] if masked else None
    want = _xla_attention(*(jnp.asarray(a) for a in (q, k, v)), 32 ** -0.5,
                          None if mask is None else jnp.asarray(mask))
    got = attention_masked(*(torch.from_numpy(a) for a in (q, k, v)), 32 ** -0.5,
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_text_init_follows_the_jax_distributions(towers):
    """Seeded random text weights: flax `nn.Embed`'s normal(1/sqrt(width)),
    normal(0.01) positions, normal(width^-0.5) projection, lecun-normal
    kernels, zero biases, unit LayerNorm scales; the visual draw comes first
    and is the same with or without the text tower."""
    _, params, _ = towers["base"]
    a = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    b = create_model(NAME, device="cpu", dtype=torch.float32, seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    ref = state_dict_from_jax(params)
    for k in ("text.token_embedding.weight", "text.positional_embedding",
              "text.text_projection", "text.transformer.resblocks.0.attn.in_proj_weight",
              "text.transformer.resblocks.1.mlp.c_proj.weight"):
        assert abs(sd[k].std().item() / ref[k].std().item() - 1.0) < 0.1, k
    assert torch.equal(sd["text.ln_final.weight"], torch.ones(64))
    assert not sd["text.transformer.resblocks.0.attn.in_proj_bias"].any()


def test_tokenizer_choice_and_refusals():
    """`get_tokenizer`: the BPE `tokenize` at the config's context length
    (one more for a CoCa config), as the JAX package's; an HF tower's
    tokenizer raises naming the hub vocabulary that is not in the repository;
    the CLIP text tower refuses an HF config (`HFTextTower` builds it);
    the CoCa text tower (`embed_cls`) builds with its CLS token and one
    more position."""
    for name in (NAME, "coca_base"):
        got = get_tokenizer(name)(["a photo of a cat"])
        want = jget_tokenizer(name)(["a photo of a cat"])
        np.testing.assert_array_equal(got, want)
    assert get_tokenizer(NAME)(["x"]).shape == (1, 16)
    with pytest.raises(OSError, match="'roberta-base'.*vocabulary"):
        get_tokenizer("roberta-ViT-B-32")
    cfg = get_model_config(NAME).text
    cls_tower = TextTransformer(dataclasses.replace(cfg, embed_cls=True), 64)
    assert cls_tower.cls_emb.shape == (cfg.width,)
    assert cls_tower.positional_embedding.shape == (cfg.context_length + 1, cfg.width)
    with pytest.raises(ValueError, match="HFTextTower"):
        TextTransformer(dataclasses.replace(cfg, hf_model_name="roberta-base"), 64)
