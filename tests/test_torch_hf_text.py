"""The port's HF text towers (`clipself_tpu_torch/models/{hf_configs,hf_bert,hf_t5,hf_text}.py`,
their branches of `models/{clip,coca,factory,torch_io}.py` and `tokenizer.py`)
against the JAX package's Flax `HFTextTower`, float32 on the CPU, and against
transformers' torch classes as a second witness.

Each model type ('bert', 'roberta', 'xlm-roberta', 't5', 'mt5') is a
2-layer tower of width 32 (T5: 4 heads of 8) with a 100-token vocabulary,
with a 'linear' and an 'mlp' projection, under the three poolers; its JAX
side runs once a (type, projection) and pooler, eagerly. Ids: a full row, two rows padded with the type's pad id (1 for
RoBERTa and XLM-R, 0 for BERT and T5) and a row that is all padding. Every
flax leaf is seeded noise (kernels of spread fan_in^-0.5, norm scales
around 1, embeddings of spread 1, other leaves 0.1), carried over with
`state_dict_from_jax` and loaded strictly.

Tolerances: outputs and losses sum the same float32 products in another
order through two layers: 1e-4 absolute; gradients 1e-4 of each tensor's
largest entry plus 1e-6; tables (state dicts, configs, buckets) EQUAL.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core import config as jconfig
from clipself_tpu.models.clip import CLIP as JCLIP
from clipself_tpu.models.coca import CoCa as JCoCa
from clipself_tpu.models.coca import coca_loss as jcoca_loss
from clipself_tpu.models.hf_text import HFTextTower as JHFTextTower
from clipself_tpu.train import contrastive as jcontrastive
from clipself_tpu_torch import tokenizer
from clipself_tpu_torch.core import config
from clipself_tpu_torch.core.config import TextConfig, get_model_config, list_models
from clipself_tpu_torch.models import hf_configs, hf_t5, torch_io
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.coca import CoCa, coca_loss
from clipself_tpu_torch.models.factory import create_model, get_tokenizer, model_class
from clipself_tpu_torch.models.hf_text import HFTextTower, load_hf_trunk_params
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.train.contrastive import clip_loss

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-4
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-6
EMBED, N = 16, 12
_BERT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
             vocab_size=100, max_position_embeddings=40)
_T5 = dict(d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4, vocab_size=100)
TINY = {"bert": _BERT, "roberta": _BERT, "xlm-roberta": _BERT, "t5": _T5, "mt5": _T5}
POOLERS = ("mean_pooler", "cls_pooler", "last_pooler")
PROJS = ("linear", "mlp")
HUB_CONFIGS = ("coca_roberta-ViT-B-32", "mt5-base-ViT-B-32", "mt5-xl-ViT-H-14", "roberta-ViT-B-32",
               "xlm-roberta-base-ViT-B-32", "xlm-roberta-large-ViT-H-14")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def noise(shapes, seed: int):
    """Seeded float32 leaves on a flax shape tree (see the module docstring)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale" or (name == "weight" and len(s.shape) == 1):
            return 1.0 + 0.1 * z
        return z if name == "embedding" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pad_id(typ: str) -> int:
    return 1 if typ in ("roberta", "xlm-roberta") else 0


def ids(typ: str, seed: int = 0) -> np.ndarray:
    """[4, N]: a full row, rows padded from 7 and from 3, a row all padding."""
    out = np.random.default_rng(seed).integers(3, 100, (4, N)).astype(np.int32)
    out[1, 7:] = out[2, 3:] = out[3] = pad_id(typ)
    return out


def text_cfg(typ: str, proj: str = "linear", pooler: str = "mean_pooler") -> TextConfig:
    return TextConfig(hf_model_name=typ, hf_model_config=TINY[typ], proj=proj, pooler_type=pooler,
                      context_length=N)


def jtower(typ: str, proj: str, pooler: str) -> JHFTextTower:
    return JHFTextTower(typ, output_dim=EMBED, pooler_type=pooler, proj=proj, hf_config_kwargs=TINY[typ])


def port_tower(typ: str, proj: str, pooler: str, params) -> HFTextTower:
    """The port's tower with the flax ``params`` of a JAX tower, through
    `state_dict_from_jax` and a strict load."""
    sd = state_dict_from_jax({"text": params, "logit_scale": np.float32(0.0)})
    tower = HFTextTower(text_cfg(typ, proj, pooler), EMBED).eval()
    tower.load_state_dict({k[len("text."):]: v for k, v in sd.items() if k.startswith("text.")}, strict=True)
    return tower


_TOWERS: dict = {}


def towers(typ: str, proj: str):
    """(flax params, {pooler: the JAX tower's `forward_tokens`: the pooled
    projection, which is its `__call__`'s output, and the hidden states}),
    made once a (type, projection); the JAX side runs eagerly (at these
    sizes a compile costs more than the run)."""
    key = (typ, proj)
    if key not in _TOWERS:
        x = ids(typ)
        shapes = jax.eval_shape(lambda: jtower(typ, proj, "mean_pooler").init(jax.random.PRNGKey(0), x))
        params = noise(shapes["params"], seed=sum(map(ord, typ + proj)))
        refs = {pooler: tuple(np.asarray(a) for a in jtower(typ, proj, pooler).apply(
            {"params": params}, x, method="forward_tokens")) for pooler in POOLERS}
        _TOWERS[key] = (params, refs)
    return _TOWERS[key]


def _close(got, want, tol=TOL):
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("pooler", POOLERS)
@pytest.mark.parametrize("proj", PROJS)
@pytest.mark.parametrize("typ", list(TINY))
def test_text_tower_matches_jax(typ, proj, pooler):
    """`forward` and `forward_tokens` (the pooled projection and the hidden
    states, without the CLS slot under `cls_pooler`) against the JAX tower,
    on mixed padding and a row that is all padding (finite on both sides)."""
    params, refs = towers(typ, proj)
    tower = port_tower(typ, proj, pooler, params)
    x = torch.from_numpy(ids(typ))
    with torch.no_grad():
        out = tower(x)
        pooled, hidden = tower.forward_tokens(x)
    want_pooled, want_hidden = refs[pooler]
    assert np.isfinite(want_pooled).all() and torch.isfinite(out).all()
    _close(out, want_pooled)
    _close(pooled, want_pooled)
    _close(hidden, want_hidden)
    assert hidden.shape[1] == N - (pooler == "cls_pooler")


@pytest.mark.parametrize("proj", PROJS)
@pytest.mark.parametrize("typ", list(TINY))
def test_state_dict_round_trip(typ, proj):
    """JAX params -> the port's state dict, loaded strictly -> back, leaf by
    leaf through `flax_to_torch_key`: EQUAL to the JAX params; the key set
    is the tower's (a T5 trunk's `encoder.embed_tokens` is `shared`)."""
    params, _ = towers(typ, proj)
    tower = port_tower(typ, proj, "mean_pooler", params)
    sd = {f"text.{k}": v for k, v in tower.state_dict().items()}
    flat = torch_io._flatten({"text": params})
    keys = set()
    for path, leaf in flat.items():
        key, transform = torch_io.flax_to_torch_key(path)
        back = sd[key].numpy()
        back = back.T if transform == "linear" else back
        np.testing.assert_array_equal(back, leaf, err_msg=key)
        keys.add(key)
    if typ in ("t5", "mt5"):
        keys.add("text.transformer.encoder.embed_tokens.weight")
        assert torch.equal(sd["text.transformer.encoder.embed_tokens.weight"], sd["text.transformer.shared.weight"])
    assert keys == set(sd)


def _hf_torch(typ: str):
    """The transformers torch trunk of ``typ`` at the tiny widths."""
    import transformers as tf

    c = tf.AutoConfig.for_model(typ, **TINY[typ])
    c._attn_implementation = "eager"
    cls = {"bert": tf.BertModel, "roberta": tf.RobertaModel, "xlm-roberta": tf.XLMRobertaModel,
           "t5": tf.T5EncoderModel, "mt5": tf.MT5EncoderModel}[typ]
    torch.manual_seed(0)
    return cls(c).eval()


@pytest.mark.parametrize("typ", list(TINY))
def test_trunk_equals_transformers(typ):
    """The second witness: transformers' torch model loaded strictly with
    the port's trunk state dict gives the port's hidden states (and pooler
    output) on the rows that hold a token; `load_hf_trunk_params` takes
    transformers' own weights back into a port tower."""
    pytest.importorskip("transformers")
    params, _ = towers(typ, "linear")
    tower = port_tower(typ, "linear", "cls_pooler", params)
    hf = _hf_torch(typ)
    hf.load_state_dict(tower.transformer.state_dict(), strict=True)
    x = torch.from_numpy(ids(typ)[:3]).long()
    mask = (x != pad_id(typ)).long()
    with torch.no_grad():
        want = hf(input_ids=x, attention_mask=mask)
        hidden, pooled, _ = tower._trunk(x)
        _close(hidden, want.last_hidden_state.numpy())
        if typ not in ("t5", "mt5"):
            _close(pooled, want.pooler_output.numpy())
        fresh = _hf_torch(typ)
        model = CLIP(_clip_cfgs(typ, "linear", "mean_pooler")[1], torch.float32).eval()
        load_hf_trunk_params(model, fresh.state_dict())
        _close(model.text._trunk(x)[0], fresh(input_ids=x, attention_mask=mask).last_hidden_state.numpy())


def test_load_hf_trunk_params_refuses_another_structure():
    model = CLIP(_clip_cfgs("roberta", "linear", "mean_pooler")[1], torch.float32)
    sd = dict(model.text.transformer.state_dict())
    sd["encoder.layer.0.output.dense.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shapes differ"):
        load_hf_trunk_params(model, sd)
    sd.pop("pooler.dense.bias")
    with pytest.raises(ValueError, match="missing"):
        load_hf_trunk_params(model, sd)


def _clip_cfgs(typ: str, proj: str, pooler: str):
    """(JAX, port) CLIP configs of ViT-Tiny-Test with the tiny HF text tower."""
    out = []
    for pkg in (jconfig, config):
        base = pkg.get_model_config("ViT-Tiny-Test")
        text = dataclasses.replace(base.text, hf_model_name=typ, hf_model_config=TINY[typ], proj=proj,
                                   pooler_type=pooler)
        out.append(dataclasses.replace(base, text=text, name=f"tiny-{typ}"))
    return out


@pytest.mark.parametrize("typ,proj,pooler", [("roberta", "mlp", "mean_pooler"), ("mt5", "linear", "last_pooler")])
def test_clip_loss_gradient_through_the_text_tower(typ, proj, pooler):
    """`clip_loss` of fixed image features against `CLIP.encode_text`, and
    its gradient in every text parameter, against `jax.grad`. The rows hold
    a token each: an all-padding row's mean-pooled feature is zero, where
    the JAX package's `l2_normalize` has a NaN gradient."""
    jcfg, cfg = _clip_cfgs(typ, proj, pooler)
    jmodel = JCLIP(jcfg, dtype=jnp.float32)
    x = ids(typ)[:3]
    img = np.zeros((1, 32, 32, 3), np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img, x))["params"]
    params = noise(shapes, seed=3)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, 64)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)

    def loss(p):
        t = jmodel.apply({"params": p}, x, True, method="encode_text")
        return jcontrastive.clip_loss(feats, t, jnp.float32(10.0))

    jloss, jgrads = jax.tree.map(np.asarray, jax.jit(jax.value_and_grad(loss))(params))
    model = CLIP(cfg, torch.float32)
    load_weights(model, state_dict_from_jax(params))
    tloss = clip_loss(torch.from_numpy(feats), model.encode_text(torch.from_numpy(x), normalize=True),
                      torch.tensor(10.0))
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL
    want = state_dict_from_jax(jgrads)
    checked = 0
    for name, p in model.named_parameters():
        if not name.startswith("text."):
            continue
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()  # the unused pooler: zero in JAX
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + GRAD_FLOOR, err_msg=name)
        checked += 1
    assert checked == len([k for k in want if k.startswith("text.")]) - (typ in ("t5", "mt5"))


def _coca_cfgs():
    """(JAX, port) CoCa configs: ViT-Tiny-Test with the attentional pooler
    (5 queries), a tiny 'roberta' text tower of width 64 (the decoder's)
    and a 2-layer decoder over a 100-token vocabulary."""
    out = []
    for pkg in (jconfig, config):
        base = pkg.get_model_config("ViT-Tiny-Test")
        vision = dataclasses.replace(base.vision, attentional_pool=True, n_queries=5, attn_pooler_heads=2)
        text = dataclasses.replace(base.text, hf_model_name="roberta", proj="linear",
                                   hf_model_config={**_BERT, "hidden_size": 64}, context_length=N)
        mm = pkg.MultimodalConfig(context_length=N, vocab_size=100, width=64, heads=2, layers=2)
        out.append(dataclasses.replace(base, vision=vision, text=text, multimodal=mm, name="coca-roberta"))
    return out


def test_coca_with_an_hf_text_tower_matches_jax():
    """A CoCa over a tiny 'roberta' tower (`forward_tokens`: the ids lose
    their last slot to `embed_cls`, as in JAX): image and text latents,
    caption logits and `coca_loss` against the JAX CoCa."""
    jcfg, cfg = _coca_cfgs()
    jmodel = JCoCa(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x = rng.integers(3, 100, (2, N)).astype(np.int32)
    x[1, 8:] = 1
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), img, x))["params"]
    params = noise(shapes, seed=11)

    def run(p):
        out = jmodel.apply({"params": p}, img, x)
        return out, jcoca_loss(out, x)[0]

    want, want_loss = jax.tree.map(np.asarray, jax.jit(run)(params))
    model = model_class(cfg)(cfg, torch.float32).eval()
    assert isinstance(model, CoCa) and isinstance(model.text, HFTextTower)
    load_weights(model, state_dict_from_jax(params))
    with torch.no_grad():
        out = model(torch.from_numpy(img), torch.from_numpy(x))
        loss = coca_loss(out, torch.from_numpy(x))[0]
    for key in ("image_features", "text_features", "logits", "labels"):
        _close(out[key], want[key])
    assert abs(loss.item() - float(want_loss)) <= TOL
    # in bf16 the trunk's float32 token stream feeds the decoder, whose
    # residual keeps it and whose branches run in bf16, as the JAX decoder's
    # promotion does
    half = model_class(cfg)(cfg, torch.bfloat16).eval()
    half.load_state_dict(model.state_dict())
    with torch.no_grad():
        out16 = half(torch.from_numpy(img), torch.from_numpy(x))
    assert out16["logits"].dtype == torch.bfloat16 and torch.isfinite(out16["logits"]).all()
    cos = torch.nn.functional.cosine_similarity(out16["logits"].float().flatten(1), out["logits"].flatten(1))
    assert cos.min().item() > 0.999


def test_relative_position_buckets_equal_jax():
    """The T5 bucket table EQUAL to `FlaxT5Attention._relative_position_bucket`
    (bidirectional) at the text lengths and past the max distance."""
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    for n, buckets, dist in ((77, 32, 128), (300, 32, 128), (40, 16, 20)):
        rel = np.arange(n)[None, :] - np.arange(n)[:, None]
        want = np.asarray(FlaxT5Attention._relative_position_bucket(
            jnp.asarray(rel, jnp.int32), bidirectional=True, num_buckets=buckets, max_distance=dist))
        np.testing.assert_array_equal(hf_t5.relative_position_buckets(n, buckets, dist), want)


# fields the port reads, a model type's
_FIELDS = {
    "bert": ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
             "hidden_act", "max_position_embeddings", "type_vocab_size", "layer_norm_eps", "pad_token_id",
             "position_embedding_type", "initializer_range", "is_encoder_decoder", "model_type"),
    "t5": ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads", "relative_attention_num_buckets",
           "relative_attention_max_distance", "layer_norm_epsilon", "feed_forward_proj", "dense_act_fn",
           "is_gated_act", "pad_token_id", "initializer_factor", "is_encoder_decoder", "model_type"),
    "vit": ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size", "hidden_act",
            "layer_norm_eps", "image_size", "patch_size", "num_channels", "qkv_bias", "initializer_range",
            "is_encoder_decoder", "model_type"),
}
_KWARGS = {"bert": TINY["bert"], "t5": {**_T5, "feed_forward_proj": "gated-silu"},
           "vit": {"image_size": 32, "patch_size": 8, "qkv_bias": False}}


@pytest.mark.parametrize("typ", ["bert", "roberta", "xlm-roberta", "t5", "mt5", "vit"])
def test_configs_pin_transformers_defaults(typ):
    """Every field the port reads EQUAL to `AutoConfig.for_model(typ)`'s,
    with and without kwargs; the copied model-type list EQUAL to
    `CONFIG_MAPPING`'s keys."""
    tf = pytest.importorskip("transformers")
    family = "vit" if typ == "vit" else "t5" if "t5" in typ else "bert"
    make = hf_configs.trunk_config if typ == "vit" else hf_configs.text_config
    for kwargs in ({}, _KWARGS[family]):
        want = tf.AutoConfig.for_model(typ, **kwargs)
        got = make(typ, json.dumps(kwargs) if typ == "vit" else kwargs)
        assert {f: getattr(got, f) for f in _FIELDS[family]} == {f: getattr(want, f) for f in _FIELDS[family]}
    assert hf_configs.MODEL_TYPES == set(tf.CONFIG_MAPPING.keys())


def test_routing_rules():
    """A model type builds offline; a hub id raises OSError naming its
    config.json (text: not a model type; trunk: a name with '/'); a model
    type without a port encoder raises NotImplementedError naming it; a
    trunk name that is no model type raises ValueError."""
    with pytest.raises(OSError, match="'roberta-base'.*config.json"):
        hf_configs.text_config("roberta-base")
    with pytest.raises(NotImplementedError, match="'gpt2'"):
        hf_configs.text_config("gpt2")
    with pytest.raises(OSError, match="config.json"):
        hf_configs.trunk_config("google/vit-base-patch16-224")
    with pytest.raises(NotImplementedError, match="'bert'"):
        hf_configs.trunk_config("bert")
    with pytest.raises(ValueError, match="no transformers model type"):
        hf_configs.trunk_config("vit-base")
    with pytest.raises(NotImplementedError, match="relative_key"):
        hf_configs.text_config("bert", {"position_embedding_type": "relative_key"})


@pytest.mark.parametrize("name", HUB_CONFIGS)
def test_hub_named_configs_raise_naming_their_config_json(name):
    cfg = get_model_config(name)
    with pytest.raises(OSError, match=f"{cfg.text.hf_model_name!r}.*config.json"), torch.device("meta"):
        model_class(cfg)(cfg)


def test_model_class_builds_63_of_69_registry_configs():
    """Every registry config but the six hub-named ones builds (on the meta
    device: no memory)."""
    built, refused = [], []
    for name in list_models():
        cfg = get_model_config(name)
        try:
            with torch.device("meta"):
                model_class(cfg)(cfg)
            built.append(name)
        except OSError:
            refused.append(name)
    assert (len(built), len(list_models())) == (63, 69)
    assert tuple(refused) == HUB_CONFIGS


def test_tokenizer_and_hub_weights_raise(caplog):
    """`get_tokenizer` of an HF tower raises naming the hub vocabulary;
    `create_model(hf_pretrained=True)` raises; without it the tower is drawn
    and the JAX package's warning is logged."""
    with pytest.raises(OSError, match="roberta-base.*vocabulary"):
        get_tokenizer("roberta-ViT-B-32")
    with pytest.raises(OSError, match="vocabulary"):
        tokenizer.HFTokenizer("google/mt5-base")
    _, cfg = _clip_cfgs("bert", "linear", "mean_pooler")
    with pytest.raises(OSError, match="hf_pretrained"):
        create_model(cfg, device="cpu", dtype=torch.float32, hf_pretrained=True)
    with caplog.at_level(logging.WARNING, logger="clipself_tpu_torch"):
        model = create_model(cfg, device="cpu", dtype=torch.float32, seed=1)
    assert "randomly initialized" in caplog.text
    again = create_model(cfg, device="cpu", dtype=torch.float32, seed=1)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    w = model.state_dict()["text.transformer.encoder.layer.0.attention.self.query.weight"]
    assert abs(w.std().item() - 0.02) < 0.005
