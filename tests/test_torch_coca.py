"""The port's CoCa (`clipself_tpu_torch/models/coca.py`, the pooler of
`models/common.py`, `forward_pooled` of the ViT and EVA towers, the
`embed_cls` text tower, the CoCa branches of `models/{factory,torch_io}.py`)
and the contrastive losses (`train/contrastive.py`) against the JAX package,
float32 on the CPU, on the two tiny CoCas of `torch_coca_cases.py`; and the
cross-attention route of `ops/attention.py::multi_head_attention`.

Tolerances: outputs and losses sum the same products in another order
through a few blocks: 1e-4 absolute; gradients 1e-4 of each tensor's
largest entry (plus 1e-8 where one vanishes); tables (state dicts, key
shapes, token ids) EQUAL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.models import coca as jcoca
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.ops.attention import multi_head_attention as jmulti_head_attention
from clipself_tpu.train import contrastive as jcontrastive
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.models import coca, pretrained, torch_io
from clipself_tpu_torch.models.factory import (
    create_model,
    create_model_and_transforms,
    get_tokenizer,
    model_class,
)
from clipself_tpu_torch.models.torch_io import import_state_dict, state_dict_from_jax
from clipself_tpu_torch.ops import attention
from clipself_tpu_torch.train import contrastive
from torch_coca_cases import CASES, EOT, build, coca_config, inputs

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-4
GRAD_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's cases on one torch thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cocas():
    return {case: build(case) for case in CASES}


@pytest.fixture(scope="module")
def jax_refs(cocas):
    """case -> the JAX package's outputs of every forward case, the loss
    and its gradient tree, from ONE jitted call a case."""
    img, txt = inputs()

    def run(jmodel, params):
        def apply(*args, method=None):
            return jmodel.apply({"params": params}, *args, method=method)

        _, img_tokens = apply(img, method="_encode_image")
        out = apply(img, txt)

        def loss(p):
            return jcoca.coca_loss(jmodel.apply({"params": p}, img, txt), txt)

        (total, parts), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return {
            "encode_image": apply(img, True, method="encode_image"),
            "encode_image_raw": apply(img, False, method="encode_image"),
            "encode_text": apply(txt, True, method="encode_text"),
            "encode_text_no_cls": apply(txt, True, False, method="encode_text"),
            "decode_text": apply(img_tokens, txt, method="decode_text"),
            "forward": out,
            "loss": (total, parts),
            "grads": grads,
        }

    refs = {}
    for case, (jmodel, params, *_) in cocas.items():
        refs[case] = jax.tree.map(np.asarray, jax.jit(lambda p: run(jmodel, p))(params))
    return refs


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _tensors():
    img, txt = inputs()
    return torch.from_numpy(img), torch.from_numpy(txt).long()


@pytest.mark.parametrize("case", CASES)
def test_state_dict_from_jax_equals_export_state_dict(cocas, case):
    """Every key of the CoCa EQUAL to the JAX package's export, the packed
    q / k / v thirds of the decoder's cross blocks and of the pooler's bias
    joined as it joins them; the port's module tree has exactly these keys."""
    _, params, model, cfg, jcfg = cocas[case]
    ref = jtorch_io.export_state_dict(params, jcfg)
    sd = state_dict_from_jax(params, cfg)
    assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
    assert "text.cls_emb" in sd and "text_decoder.cross_attn.1.attn.in_proj_weight" in sd
    assert ("visual.attn_pool.attn.in_proj_bias" in sd) == (case == "vit")
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("what", [
    "encode_image", "encode_image_raw", "encode_text", "encode_text_no_cls", "decode_text",
])
def test_encoders_match_jax(cocas, jax_refs, case, what):
    model = cocas[case][2]
    img, txt = _tensors()
    with torch.no_grad():
        got = {
            "encode_image": lambda: model.encode_image(img),
            "encode_image_raw": lambda: model.encode_image(img, normalize=False),
            "encode_text": lambda: model.encode_text(txt),
            "encode_text_no_cls": lambda: model.encode_text(txt, embed_cls=False),
            "decode_text": lambda: model.decode_text(model._encode_image(img)[1], txt),
        }[what]()
    _close(got, jax_refs[case][what])


@pytest.mark.parametrize("case", CASES)
def test_forward_dict_matches_jax(cocas, jax_refs, case):
    model = cocas[case][2]
    img, txt = _tensors()
    with torch.no_grad():
        out = model(img, txt)
    want = jax_refs[case]["forward"]
    assert sorted(out) == sorted(want)
    for key in want:
        _close(out[key], want[key])
    np.testing.assert_array_equal(out["labels"].numpy(), want["labels"])
    assert out["logits"].shape == (2, 15, 512)


@pytest.mark.parametrize("case", CASES)
def test_coca_loss_and_gradients_match_jax(cocas, jax_refs, case):
    """`coca_loss` and its two parts, and the gradient of every parameter
    (the JAX gradient tree carried over with `state_dict_from_jax`)."""
    model, cfg = cocas[case][2], cocas[case][3]
    img, txt = _tensors()
    model.zero_grad()
    total, parts = coca.coca_loss(model(img, txt), txt)
    total.backward()
    want_total, want_parts = jax_refs[case]["loss"]
    _close(total, want_total)
    for key in ("contrastive_loss", "caption_loss"):
        _close(parts[key], want_parts[key])
    want = state_dict_from_jax(jax_refs[case]["grads"], cfg)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    for name, w in want.items():
        g = named[name].grad
        assert g is not None, name
        bar = GRAD_REL * float(w.abs().max()) + 1e-8
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=bar, err_msg=name)
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("pos,min_len,penalty", [(2, 4, 1.0), (5, 1, 1.7), (3, 6, 0.6), (7, 1, 1.0)])
def test_apply_processors_match_jax(pos, min_len, penalty):
    rng = np.random.default_rng(pos)
    logits = rng.standard_normal((3, 40)).astype(np.float32) * 3
    tokens = rng.integers(0, 40, (3, 9)).astype(np.int32)
    tokens[0, 1] = 0  # a generated pad id is a seen token too
    want = jcoca._apply_processors(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(pos), EOT, 0, min_len, penalty
    )
    got = coca._apply_processors(torch.from_numpy(logits), torch.from_numpy(tokens), pos, EOT, 0,
                                 min_len, penalty)
    _close(got, want, tol=0)


def _features(seed: int, n: int = 6, d: int = 16):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((4, n, d)).astype(np.float32)
    return feats / np.linalg.norm(feats, axis=-1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_contrastive_losses_match_jax(seed):
    si, st, ti, tt = _features(seed)
    scale, dist = np.float32(14.3), np.float32(9.1)
    t = [torch.from_numpy(x) for x in (si, st, ti, tt)]
    _close(contrastive.clip_loss(t[0], t[1], torch.tensor(scale)), jcontrastive.clip_loss(si, st, scale))
    for d in (None, dist):
        want = jcontrastive.distill_clip_loss(si, st, ti, tt, scale, d)
        got = contrastive.distill_clip_loss(*t, torch.tensor(scale), None if d is None else torch.tensor(d))
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("dataset_type", ["grid_distill", "clipself", "coco_caption", "region_clip"])
def test_create_loss_routes_as_jax(dataset_type):
    want = jcontrastive.create_loss(dataset_type).__name__
    assert contrastive.create_loss(dataset_type).__name__ == want


def test_cross_attention_takes_the_plain_route(monkeypatch):
    """Nq != Nk: before the repair the route was `flash_attention`, whose
    kernel's checks refuse keys of another length than the queries; now
    `multi_head_attention` takes `attention_masked` without a mask on every
    device and equals the JAX dispatch."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 5, 2, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 17, 2, 32)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="k is"):
        attention._check_qkv(tq, tk, tv, "flash_attention")  # the fault the old route hit

    def refuse(*_):
        raise AssertionError("cross-attention reached the flash kernel's wrapper")

    monkeypatch.setattr(attention, "flash_attention", refuse)
    got = attention.multi_head_attention(tq, tk, tv, 32 ** -0.5)
    _close(got, jmulti_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 32 ** -0.5))
    monkeypatch.undo()
    calls = []
    monkeypatch.setattr(attention, "flash_attention", lambda *a: calls.append(a) or attention.attention_plain(*a))
    attention.multi_head_attention(tq, tq, tq, 32 ** -0.5)
    assert len(calls) == 1  # self-attention keeps the flash route


def test_import_state_dict_fills_every_root(cocas, tmp_path):
    """The non-strict import (`--pretrained`) of a CoCa export: the pooler,
    `text.cls_emb` and the decoder's packed projections arrive; a fresh
    model then equals the loaded one."""
    _, params, model, cfg, _ = cocas["vit"]
    fresh = model_class(cfg)(cfg, torch.float32)
    missing = import_state_dict(fresh, state_dict_from_jax(params, cfg))
    assert missing == []
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy(), err_msg=k)


def _flax_shapes(cfg, jcfg) -> dict:
    """torch key -> shape of the JAX init of ``jcfg``, from `jax.eval_shape`
    (nothing is drawn), the packed thirds joined."""
    jmodel = jcoca.CoCa(jcfg, dtype=jnp.float32)
    size = jcfg.vision.image_size
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.zeros((1, jcfg.text.context_length + 1), jnp.int32)
    ))["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key, transform = torch_io.flax_to_torch_key(tuple(p.key for p in path), cfg)
        s = tuple(leaf.shape)
        kind = transform[0] if isinstance(transform, tuple) else transform
        if kind in ("linear", "linear_slice"):
            s = s[::-1]
        elif kind == "conv":  # HWIO -> OIHW
            s = (s[3], s[2], s[0], s[1])
        if isinstance(transform, tuple):  # a third of a packed projection
            s = (s[0] + out.get(key, (0,))[0],) + s[1:]
        out[key] = s
    return out


@pytest.mark.parametrize("name", ["coca_ViT-L-14", "coca_ViT-B-32", "coca_base"])
def test_registry_cocas_build_with_the_jax_layout(name):
    """The registry's CoCas at full width and depth (on the meta device:
    nothing is allocated): every parameter's key and shape those of the JAX
    init, and a tokenizer of 77 tokens (the config's 76 and the CLS slot)."""
    cfg, jcfg = get_model_config(name), jget_model_config(name)
    with torch.device("meta"):
        model = model_class(cfg)(cfg)
    assert isinstance(model, coca.CoCa)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _flax_shapes(cfg, jcfg)
    assert get_tokenizer(name)(["a photo of a cat"]).shape == (1, 77)


@pytest.mark.parametrize("name,error,match", [
    # the HF text tower is ported; this config names it by a hub id, whose
    # config.json is not in the repository
    pytest.param("coca_roberta-ViT-B-32", OSError, "'roberta-base'.*config.json",
                 id="coca_roberta-ViT-B-32-item 8.5"),
    pytest.param("RN50", NotImplementedError, "no token stream", id="RN50-no token stream"),
])
def test_unported_cocas_raise(name, error, match):
    cfg = get_model_config(name)
    if cfg.multimodal is None:  # a ResNet CoCa: RN50 under coca_ViT-B-32's decoder
        cfg = dataclasses.replace(cfg, multimodal=get_model_config("coca_ViT-B-32").multimodal)
    with pytest.raises(error, match=match), torch.device("meta"):
        model_class(cfg)(cfg)


def test_create_model_and_transforms_builds_a_coca():
    cfg = coca_config("vit")
    model, pre_train, pre_val = create_model_and_transforms(cfg, device="cpu", dtype=torch.float32,
                                                            det_image_size=64)
    assert isinstance(model, coca.CoCa) and pre_train is pre_val and len(pre_train) == 2
    img = np.random.default_rng(0).integers(0, 255, (40, 24, 3), np.uint8)
    assert pre_train[0](img).shape == (64, 64, 3) and pre_train[1](img).shape[-1] == 3
    again = create_model(cfg, device="cpu", dtype=torch.float32)  # the same seed draws the same weights
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


@pytest.mark.parametrize("tag", ["laion2b_s13b_b90k", "mscoco_finetuned_laion2b_s13b_b90k"])
def test_coca_tags_resolve_from_the_cache(tmp_path, tag):
    """A CoCa tag resolves to its file in the hub cache layout and names its
    source when the file is missing; nothing is fetched."""
    entry = pretrained.get_pretrained_cfg("coca_ViT-L-14", tag)
    with pytest.raises(FileNotFoundError, match=entry["hf_hub"]):
        pretrained.resolve_pretrained("coca_ViT-L-14", tag, cache_dir=str(tmp_path))
    snap = tmp_path / ("models--" + entry["hf_hub"].replace("/", "--")) / "snapshots" / "r0"
    snap.mkdir(parents=True)
    (snap / "open_clip_pytorch_model.bin").write_bytes(b"x")
    got = pretrained.resolve_pretrained("coca_ViT-L-14", tag, cache_dir=str(tmp_path))
    assert got == str(snap / "open_clip_pytorch_model.bin")
