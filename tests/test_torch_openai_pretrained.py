"""The port's OpenAI checkpoint loader (`clipself_tpu_torch/models/openai.py`)
and pretrained registry (`models/pretrained.py`) against the JAX package's
(`clipself_tpu/models/{openai,pretrained}.py`) on the CPU: the registry,
config inference and key remaps EQUAL; a `torch.jit` archive and a plain
`.pt` read to EQUAL arrays; a model built from an OpenAI-layout archive
within 1e-4 of the JAX package's in float32 (the same products in another
order through two blocks); a catalog tag through `create_model` and the
trainer's `--pretrained`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from clipself_tpu.models import openai as jopenai
from clipself_tpu.models import pretrained as jpretrained
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu_torch.core.config import CLIPConfig, TextConfig, VisionConfig, get_model_config
from clipself_tpu_torch.models import openai, pretrained, torch_io
from clipself_tpu_torch.models.factory import create_model, create_model_and_transforms
from clipself_tpu_torch.train import main as train_main

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-4
# what `config_from_openai_state_dict` infers for the archive below: head
# width 64, QuickGELU, eps 1e-5 (the OpenAI releases' fixed choices)
OPENAI_TINY = CLIPConfig(
    embed_dim=64,
    vision=VisionConfig(image_size=32, layers=2, width=128, head_width=64, patch_size=8,
                        mlp_ratio=4.0, ln_eps=1e-5, quick_gelu=True),
    text=TextConfig(context_length=16, vocab_size=512, width=128, heads=2, layers=2,
                    ln_eps=1e-5, quick_gelu=True),
    name="openai",
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's cases on one torch thread, restored after: more threads
    only fight the other test workers for the cores, and the setting is the
    process's, so another module must not inherit it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class _Node(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _scripted(sd: dict) -> torch.jit.ScriptModule:
    """A TorchScript module holding ``sd`` under its dotted names, as an
    OpenAI release's archive holds its weights."""
    root = _Node()
    for key, val in sd.items():
        *path, leaf = key.split(".")
        node = root
        for name in path:
            if not hasattr(node, name):
                node.add_module(name, _Node())
            node = getattr(node, name)
        node.register_parameter(leaf, nn.Parameter(val.clone(), requires_grad=False))
    return torch.jit.script(root)


def _openai_layout(model) -> dict:
    """A port CLIP's weights in the OpenAI layout (text keys unprefixed)."""
    return {k[len("text."):] if k.startswith("text.") else k: v.detach().clone()
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """An OpenAI-layout ViT archive (seeded weights with noise on every
    tensor), as a `torch.jit` archive and as a plain `.pt` state dict."""
    root = tmp_path_factory.mktemp("openai")
    model = create_model(OPENAI_TINY, device="cpu", dtype=torch.float32, seed=4)
    gen = torch.Generator().manual_seed(5)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in _openai_layout(model).items()}
    jit_path, pt_path = str(root / "ViT-tiny.pt"), str(root / "plain.pt")
    torch.jit.save(_scripted(sd), jit_path)
    torch.save({"state_dict": sd}, pt_path)
    return sd, jit_path, pt_path


def _rn_state_dict() -> dict:
    """The shapes that the ResNet branch of the config inference reads."""
    sd = {"visual.conv1.weight": np.zeros((32, 3, 3, 3), np.float32),
          "visual.attnpool.positional_embedding": np.zeros((50, 256), np.float32),
          "text_projection": np.zeros((64, 128), np.float32),
          "positional_embedding": np.zeros((16, 64), np.float32),
          "token_embedding.weight": np.zeros((512, 64), np.float32),
          "ln_final.weight": np.zeros(64, np.float32), "logit_scale": np.zeros((), np.float32)}
    for stage, blocks in zip((1, 2, 3, 4), (3, 4, 6, 3)):
        for i in range(blocks):
            sd[f"visual.layer{stage}.{i}.conv1.weight"] = np.zeros((16 * stage, 8, 1, 1), np.float32)
    for i in range(3):
        sd[f"transformer.resblocks.{i}.ln_1.weight"] = np.zeros(64, np.float32)
    return sd


def test_registry_equals_jax():
    assert pretrained.list_pretrained() == jpretrained.list_pretrained()
    assert pretrained.PRETRAINED == jpretrained.PRETRAINED
    for model in list(jpretrained.PRETRAINED) + ["ViT-Tiny-Test"]:
        assert (pretrained.list_pretrained_tags_by_model(model)
                == jpretrained.list_pretrained_tags_by_model(model))
    for model, tag in (("ViT-B-16", "OpenAI"), ("ViT-B-16-quickgelu", "openai"), ("RN50", "nope")):
        assert pretrained.get_pretrained_cfg(model, tag) == jpretrained.get_pretrained_cfg(model, tag)


def test_resolve_pretrained_paths_tags_and_the_cache(tmp_path, monkeypatch):
    """A local path passes through; an unknown tag raises the JAX text; a
    known tag resolves to the file where the JAX package's download leaves it
    (a URL's basename, a hub snapshot), and raises naming its source when
    that file is not there; the cache directory defaults as the JAX one."""
    local = tmp_path / "w.pt"
    local.write_bytes(b"x")
    assert pretrained.resolve_pretrained("ViT-B-16", str(local)) == str(local)
    with pytest.raises(FileNotFoundError) as want:
        jpretrained.resolve_pretrained("ViT-B-16", "nope", cache_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        pretrained.resolve_pretrained("ViT-B-16", "nope", cache_dir=str(tmp_path))
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError, match="openaipublic.*ViT-B-16.pt"):
        pretrained.resolve_pretrained("ViT-B-16", "openai", cache_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="laion/CLIP-ViT-H-14"):
        pretrained.resolve_pretrained("ViT-H-14", "laion2b_s32b_b79k", cache_dir=str(tmp_path))
    (tmp_path / "ViT-B-16.pt").write_bytes(b"x")
    assert (pretrained.resolve_pretrained("ViT-B-16", "openai", cache_dir=str(tmp_path))
            == jpretrained.resolve_pretrained("ViT-B-16", "openai", cache_dir=str(tmp_path)))
    snap = tmp_path / "models--laion--CLIP-ViT-H-14-laion2B-s32B-b79K" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "open_clip_pytorch_model.bin").write_bytes(b"x")
    assert pretrained.resolve_pretrained("ViT-H-14", "laion2b_s32b_b79k", cache_dir=str(tmp_path)) == str(
        snap / "open_clip_pytorch_model.bin")
    monkeypatch.setenv("CLIPSELF_CACHE", str(tmp_path))
    assert pretrained.default_cache_dir() == jpretrained.default_cache_dir() == tmp_path


def test_config_inference_and_key_remap_equal_jax(archive):
    """`config_from_openai_state_dict` on a ViT and a ResNet state dict and
    `remap_openai_keys` EQUAL to the JAX package's."""
    sd = {k: v.numpy() for k, v in archive[0].items()}
    for case in (sd, _rn_state_dict()):
        got = dataclasses.asdict(openai.config_from_openai_state_dict(case))
        want = dataclasses.asdict(jopenai.config_from_openai_state_dict(case))
        assert got == want
        case = {**case, "input_resolution": np.zeros(()), "context_length": np.zeros(())}
        got, want = openai.remap_openai_keys(case), jopenai.remap_openai_keys(case)
        assert got.keys() == want.keys()
        assert all(got[k] is want[k] for k in want)
    assert openai.config_from_openai_state_dict(sd) == OPENAI_TINY
    assert openai.config_from_openai_state_dict(_rn_state_dict()).vision.resnet_layers == (3, 4, 6, 3)


@pytest.mark.parametrize("which", ["jit", "plain"])
def test_load_openai_state_dict_equals_jax(archive, which):
    sd, jit_path, pt_path = archive
    path = jit_path if which == "jit" else pt_path
    got, want = openai.load_openai_state_dict(path), jopenai.load_openai_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert torch_io.is_torchscript_archive(jit_path) and not torch_io.is_torchscript_archive(pt_path)


def test_load_openai_model_matches_jax(archive):
    """The model built from the archive: the config and every weight as the
    JAX package's `load_openai_model` builds them (EQUAL through the key
    map), and the image and text embeddings within 1e-4."""
    _, jit_path, _ = archive
    jmodel, jparams = jopenai.load_openai_model(jit_path, dtype=jnp.float32)
    model = openai.load_openai_model(jit_path, device="cpu", dtype=torch.float32)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
    want_sd = torch_io.state_dict_from_jax(jparams)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 500, (2, 16)).astype(np.int32)
    with torch.no_grad():
        got_i = model.encode_image(torch.from_numpy(img), normalize=True).numpy()
        got_t = model.encode_text(torch.from_numpy(tokens), normalize=True).numpy()
    # one jitted call for both (op by op, JAX compiles each operation apart)
    want_i, want_t = jax.jit(lambda p, i, t: (
        jmodel.apply({"params": p}, i, True, method="encode_image"),
        jmodel.apply({"params": p}, t, True, method="encode_text"),
    ))(jparams, jnp.asarray(img), jnp.asarray(tokens))
    np.testing.assert_allclose(got_i, np.asarray(want_i), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=0, atol=TOL)


def test_a_jit_archive_is_refused_by_both_pretrained_routes(archive):
    """`--pretrained` of a `torch.jit` archive (the file an 'openai' tag
    resolves to): the JAX package's `load_pretrained` fails on the script
    module `torch.load` returns; the port refuses it and names
    `load_openai_model`."""
    _, jit_path, _ = archive
    jcfg = jopenai.config_from_openai_state_dict(jopenai.load_openai_state_dict(jit_path))
    with pytest.raises(NotImplementedError):
        jtorch_io.load_pretrained(jit_path, {}, jcfg)
    model = create_model(OPENAI_TINY, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="load_openai_model"):
        torch_io.load_pretrained(model, jit_path)


def test_a_catalog_tag_reaches_the_trainer(tmp_path, monkeypatch):
    """`--pretrained <tag>`: the tag resolves through the registry to its
    cached file, which is imported over the seeded weights."""
    name = "ViT-Tiny-Test"
    src = create_model(name, device="cpu", dtype=torch.float32, seed=9)
    torch.save({"state_dict": src.state_dict()}, tmp_path / "tiny.pt")
    monkeypatch.setitem(pretrained.PRETRAINED, name, {"test": {"url": "https://example.invalid/tiny.pt"}})
    monkeypatch.setenv("CLIPSELF_CACHE", str(tmp_path))
    model = create_model(name, device="cpu", dtype=torch.float32, seed=0, pretrained="test")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    run = train_main.main([
        "--device", "cpu", "--synthetic", "--model", name, "--pretrained", "test",
        "--batch-size", "1", "--det-image-size", "32", "--max-boxes", "2", "--steps-per-epoch", "1",
        "--epochs", "1", "--logs", str(tmp_path / "logs"), "--name", "tag",
    ])
    for k, v in src.state_dict().items():
        assert torch.equal(run["teacher"].state_dict()[k], v), k


def test_create_model_and_transforms():
    """The model and the (det, crop) pair: both preprocesses the pair for
    the distill types, the crop transform alone in training otherwise."""
    model, train_pre, val_pre = create_model_and_transforms(
        "ViT-Tiny-Test", device="cpu", dtype=torch.float32, det_image_size=64,
    )
    assert train_pre is val_pre and len(val_pre) == 2
    img = np.random.default_rng(0).integers(0, 255, (40, 30, 3), dtype=np.uint8)
    assert val_pre[0](img).shape == (64, 64, 3) and val_pre[1](img).shape == (32, 32, 3)
    _, crop, pair = create_model_and_transforms(
        "ViT-Tiny-Test", device="cpu", dtype=torch.float32, dataset_type="other",
    )
    assert callable(crop) and len(pair) == 2
    assert get_model_config("ViT-Tiny-Test") == model.cfg
