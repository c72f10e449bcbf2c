"""The port's trainer CLI (`python -m clipself_tpu_torch.train.main`) on the
CPU with `EVA02-CLIP-Tiny-Test`: `--dataset-type region_clip` on
`tests/conftest.py::write_micro_coco` files, and the single-device flags of
`clipself_tpu/train/main.py:34-158` that came with it: `--accum-freq`,
`--skip-scheduler`, `--save-most-recent` with `--resume auto`,
`--keep-checkpoints`, `--export-torch`, `--pretrained`, `--debug` and
`--log-local`. `--pretrained` is held against the JAX package's
`load_pretrained` on a checkpoint written by its `save_torch_checkpoint`:
the same numbers copied (EQUAL), the resized pos-embed from the same
float32 NumPy products (EQUAL)."""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipself_tpu.core.config import get_model_config as jax_config
from clipself_tpu.models import torch_io as jtorch_io
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.models import torch_io
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.train import checkpoint as ckpt
from clipself_tpu_torch.train import main as train_main
from conftest import write_micro_coco

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
NOUNS = 128  # above the loss's 100 sampled classes (top_k needs k <= C)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    img_dir, seg_dir = write_micro_coco(root, n_images=4, anns_per_image=3, embed_dim=64)
    nouns = np.random.default_rng(3).standard_normal((NOUNS, 64)).astype(np.float32)
    np.save(root / "nouns.npy", nouns * 3.0)  # unnormalised: the trainer normalises
    return root, str(img_dir), str(seg_dir)


def _region(corpus, logs, name, *extra):
    root, img_dir, seg_dir = corpus
    return [
        "--device", "cpu", "--model", NAME, "--precision", "fp32", "--batch-size", "2",
        "--det-image-size", "64", "--max-boxes", "4", "--epochs", "2", "--workers", "0",
        "--lr", "1e-3", "--warmup", "1", "--log-every-n-steps", "1", "--alpha", "0.7",
        "--dataset-type", "region_clip", "--train-data", str(root / "instances.json"),
        "--train-image-root", img_dir, "--train-embed-path", str(root / "nouns.npy"),
        "--val-data", str(root / "panoptic.json"), "--val-image-root", img_dir,
        "--val-segm-root", seg_dir, "--embed-path", str(root / "emb.npy"),
        "--logs", str(logs), "--name", name, *extra,
    ]


def _synthetic(logs, name, epochs, *extra):
    return [
        "--device", "cpu", "--synthetic", "--model", NAME, "--precision", "fp32",
        "--batch-size", "1", "--det-image-size", "32", "--max-boxes", "2", "--steps-per-epoch", "2",
        "--epochs", str(epochs), "--lr", "1e-3", "--warmup", "1", "--log-every-n-steps", "1",
        "--logs", str(logs), "--name", name, *extra,
    ]


def test_region_clip_trains_from_files_with_eval(corpus, tmp_path):
    """Two epochs of two steps: finite losses (also as `loss_contrast`),
    results.jsonl before training and after each epoch, a checkpoint whose
    params are the alpha-ensemble with the initial weights; no teacher
    module is built."""
    run = train_main.main(_region(corpus, tmp_path, "rc"))
    hist = run["history"]
    assert [(h["epoch"], h["step"]) for h in hist] == [(0, 1), (0, 2), (1, 3), (1, 4)]
    assert all(math.isfinite(h["loss"]) and h["loss"] == h["loss_contrast"] for h in hist)
    lines = [json.loads(line) for line in (tmp_path / "rc" / "results.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1, 2] and lines == run["evals"]
    assert run["teacher"] is None
    saved = ckpt.load_params(str(tmp_path / "rc" / "checkpoints"))
    student = run["state"].model.state_dict()
    for k, v in saved.items():
        torch.testing.assert_close(v, 0.7 * student[k] + 0.3 * run["teacher_params"][k], rtol=0, atol=1e-7)
    assert not torch.equal(saved["visual.blocks.1.mlp.w3.weight"],
                           run["teacher_params"]["visual.blocks.1.mlp.w3.weight"])


def test_region_clip_ignores_native_loader_and_multiscale_and_scales_by_contrast_weight(corpus, tmp_path):
    """`--native-loader` (grid_distill only) and `--multiscale` leave a
    region_clip run as it was, as in the JAX trainer; `--contrast-weight 2`
    doubles the first loss (the same weights, batch and noise)."""
    base = train_main.main(_region(corpus, tmp_path, "base", "--epochs", "1"))
    flags = train_main.main(_region(corpus, tmp_path, "flags", "--epochs", "1", "--native-loader",
                                    "--multiscale"))
    assert [h["loss"] for h in flags["history"]] == [h["loss"] for h in base["history"]]
    for k, v in base["state"].model.state_dict().items():
        assert torch.equal(flags["state"].model.state_dict()[k], v), k
    double = train_main.main(_region(corpus, tmp_path, "double", "--epochs", "1",
                                     "--contrast-weight", "2"))
    assert double["history"][0]["loss"] == pytest.approx(2 * base["history"][0]["loss"], rel=1e-6)


def test_region_clip_without_noun_embeddings_or_with_synthetic_data_is_refused(corpus, tmp_path):
    argv = _region(corpus, tmp_path, "none")
    i = argv.index("--train-embed-path")
    with pytest.raises(ValueError, match="needs --train-embed-path"):
        train_main.main(argv[:i] + argv[i + 2:])
    with pytest.raises(ValueError, match="no synthetic batch"):
        train_main.main(_synthetic(tmp_path, "syn", 1, "--dataset-type", "region_clip"))
    assert not os.listdir(tmp_path)  # refused before any model or run dir


def test_noun_embeddings_are_the_jax_trainers(corpus):
    """float32 rows over their norm + 1e-12 (`clipself_tpu/train/main.py:401-403`)."""
    root = corpus[0]
    want = np.load(root / "nouns.npy").astype(np.float32)
    want /= np.linalg.norm(want, axis=-1, keepdims=True) + 1e-12
    got = train_main.noun_embeddings(str(root / "nouns.npy"), torch.device("cpu"))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_save_most_recent_and_resume_auto_take_the_newest_epoch(tmp_path):
    """`--save-most-recent` writes checkpoints_latest/ every epoch, keeping
    one; `--resume auto` takes whichever of checkpoints/ and
    checkpoints_latest/ holds the newer epoch: here the rolling one, as
    after a run cut between two `--save-frequency` saves."""
    const = ("--lr-scheduler", "const")  # one schedule for runs of 3 and 4 epochs
    run = train_main.main(_synthetic(tmp_path, "run", 3, "--save-frequency", "2", "--save-most-recent", *const))
    periodic, latest = tmp_path / "run" / "checkpoints", tmp_path / "run" / "checkpoints_latest"
    assert ckpt.saved_epochs(str(periodic)) == [2, 3] and ckpt.saved_epochs(str(latest)) == [3]
    shutil.rmtree(periodic / "3")  # the run cut after epoch 3, before a periodic save
    again = train_main.main(_synthetic(tmp_path, "run", 4, "--resume", "auto", "--save-most-recent", *const))
    assert [h["epoch"] for h in again["history"]] == [3, 3] and again["state"].step == 8
    assert ckpt.saved_epochs(str(latest)) == [4]
    whole = train_main.main(_synthetic(tmp_path, "whole", 4, *const))
    for k, v in whole["state"].model.state_dict().items():
        torch.testing.assert_close(again["state"].model.state_dict()[k], v, rtol=0, atol=1e-6)
    assert run["state"].step == 6


def test_keep_checkpoints_leaves_the_newest(tmp_path):
    train_main.main(_synthetic(tmp_path, "keep", 3, "--keep-checkpoints", "1"))
    assert sorted(os.listdir(tmp_path / "keep" / "checkpoints")) == ["3"]
    train_main.main(_synthetic(tmp_path, "all", 3))
    assert sorted(os.listdir(tmp_path / "all" / "checkpoints")) == ["1", "2", "3"]


def test_export_torch_then_pretrained_loads_it_exactly(tmp_path):
    """`--export-torch` writes <run>/epoch_<n>.pt on each save; a run with
    `--pretrained` on it starts from exactly those (ensembled) weights."""
    train_main.main(_synthetic(tmp_path, "exp", 2, "--export-torch", "--alpha", "0.7"))
    for n in (1, 2):
        assert (tmp_path / "exp" / f"epoch_{n}.pt").is_file()
    path = tmp_path / "exp" / "epoch_2.pt"
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["epoch"] == 2 and payload["name"] == "exp"
    assert payload["state_dict"].keys() == ckpt.load_params(str(tmp_path / "exp" / "checkpoints")).keys()
    run = train_main.main(_synthetic(tmp_path, "pre", 1, "--pretrained", str(path), "--seed", "5"))
    for k, v in payload["state_dict"].items():
        assert torch.equal(run["teacher"].state_dict()[k], v), k
    assert "pretrained" in (tmp_path / "pre" / "params.txt").read_text()


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint of the JAX package's `save_torch_checkpoint` (seed-0
    weights) with `visual.head.bias` removed and `visual.pos_embed` at a 6x6
    grid (the model's is 4x4), and the JAX `load_pretrained` of it into the
    seed-1 weights."""
    root = tmp_path_factory.mktemp("jaxckpt")
    cfg = jax_config(NAME)
    _, params0 = jax_create_model(NAME, dtype=jnp.float32, seed=0)
    _, params1 = jax_create_model(NAME, dtype=jnp.float32, seed=1)
    params0, params1 = (jax.tree.map(np.asarray, p) for p in (params0, params1))
    path = str(root / "ref.pt")
    jtorch_io.save_torch_checkpoint(path, params0, cfg, meta={"epoch": 3})
    payload = torch.load(path, map_location="cpu", weights_only=True)
    del payload["state_dict"]["visual.head.bias"]
    rng = np.random.default_rng(0)
    payload["state_dict"]["visual.pos_embed"] = torch.from_numpy(
        rng.standard_normal((1, 37, 64)).astype(np.float32))
    torch.save(payload, path)
    want = torch_io.state_dict_from_jax(jtorch_io.load_pretrained(path, params1, cfg))
    return path, params1, want


def test_pretrained_is_the_jax_load_pretrained(jax_checkpoint, tmp_path):
    """Non-strict as the JAX import: the removed key keeps its value, the
    6x6 pos-embed is resized to 4x4, every other tensor is the
    checkpoint's; also from an `.npz` of the same keys."""
    path, params1, want = jax_checkpoint
    for src in (path, "npz"):
        model = CLIP(get_model_config(NAME), torch.float32)
        torch_io.load_weights(model, torch_io.state_dict_from_jax(params1))
        if src == "npz":
            sd = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
            src = str(tmp_path / "ref.npz")
            np.savez(src, **{k: v.numpy() for k, v in sd.items()})
        missing = torch_io.load_pretrained(model, src)
        assert missing == ["visual.head.bias"]
        got = model.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    seed1 = torch_io.state_dict_from_jax(params1)
    assert torch.equal(want["visual.head.bias"], seed1["visual.head.bias"])
    assert not torch.equal(want["visual.pos_embed"], seed1["visual.pos_embed"])


def test_pretrained_refuses_directories_and_catalog_tags(tmp_path):
    """`load_pretrained` refuses a directory (an Orbax run) and a name that
    is not a file; a catalog tag goes through `resolve_pretrained` first
    (`create_model(pretrained=)`, the trainer's `--pretrained`), and a tag
    the model does not have raises the JAX package's FileNotFoundError."""
    from clipself_tpu.models.pretrained import resolve_pretrained as jresolve_pretrained
    from clipself_tpu_torch.models.factory import create_model

    model = CLIP(get_model_config(NAME), torch.float32)
    with pytest.raises(ValueError, match="Orbax"):
        torch_io.load_pretrained(model, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="resolve_pretrained"):
        torch_io.load_pretrained(model, "eva02")
    with pytest.raises(FileNotFoundError) as want:
        jresolve_pretrained(NAME, "eva02")
    with pytest.raises(FileNotFoundError) as got:
        create_model(NAME, device="cpu", dtype=torch.float32, pretrained="eva02")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tokens", [17, 50, 101])
def test_resize_pos_embed_np_equals_jax(tokens):
    pe = np.random.default_rng(tokens).standard_normal((1, 37, 8)).astype(np.float32)
    want = jtorch_io.resize_pos_embed_np(pe, tokens)
    got = torch_io.resize_pos_embed_np(pe, tokens)
    assert got.shape == (1, tokens, 8) and np.array_equal(got, want)


def test_skip_scheduler_keeps_the_base_lr(tmp_path):
    """A constant base LR: no warmup, no decay (the warm-up run's first LR
    is a fifth of it)."""
    fixed = train_main.main(_synthetic(tmp_path, "fixed", 2, "--skip-scheduler", "--warmup", "5"))
    assert [h["lr"] for h in fixed["history"]] == [1e-3] * 4
    warm = train_main.main(_synthetic(tmp_path, "warm", 2, "--warmup", "5"))
    assert warm["history"][0]["lr"] == pytest.approx(2e-4)


def test_accum_freq_updates_every_second_micro_step(tmp_path):
    """`--accum-freq 2`: the step counts micro-steps; the weights move only
    on the second of each pair (the method's tests hold the numbers
    against optax.MultiSteps)."""
    one = train_main.main(_synthetic(tmp_path, "one", 1, "--accum-freq", "2", "--steps-per-epoch", "1"))
    assert one["state"].step == 1
    for k, v in one["teacher"].state_dict().items():
        assert torch.equal(one["state"].model.state_dict()[k], v), k
    two = train_main.main(_synthetic(tmp_path, "two", 1, "--accum-freq", "2"))
    assert two["state"].step == 2
    moved = [k for k, v in two["teacher"].state_dict().items()
             if not torch.equal(two["state"].model.state_dict()[k], v)]
    assert moved


def test_debug_and_log_local_write_out_0_at_debug(tmp_path):
    train_main.main(_synthetic(tmp_path, "dbg", 1, "--debug", "--log-local"))
    files = sorted(os.listdir(tmp_path / "dbg"))
    assert "out-0.log" in files and "out.log" not in files
    text = (tmp_path / "dbg" / "out-0.log").read_text()
    assert "| DEBUG |" in text and "| INFO |" in text
    train_main.main(_synthetic(tmp_path, "info", 1))
    assert "| DEBUG |" not in (tmp_path / "info" / "out.log").read_text()


def test_pretrained_image_refuses_a_tower_that_is_not_timm(tmp_path):
    """`--pretrained-image` on a non-timm model raises, with the message of
    the JAX trainer's assert."""
    from clipself_tpu.train import main as jax_main

    message = "pretrained image towers currently only supported for timm models"
    with pytest.raises(ValueError, match=message):
        train_main.main(_synthetic(tmp_path, "pi", 1, "--pretrained-image"))
    with pytest.raises(AssertionError, match=message):
        jax_main.main(["--synthetic", "--model", NAME, "--pretrained-image", "--logs", str(tmp_path)])


def test_pretrained_image_marks_a_timm_tower_and_warns(tmp_path, monkeypatch, caplog):
    """On a timm tower (a tiny ConvNeXt, `--no-lock-image`: under the lock a
    timm tower trains nothing) the flag sets `timm_model_pretrained` and,
    with nothing to load, logs the JAX package's warning; the step trains."""
    import dataclasses

    from clipself_tpu_torch.core.config import config_from_dict
    from clipself_tpu_torch.models import convnext

    monkeypatch.setitem(convnext.CONVNEXT_ARCHS, "convnext_flags_tiny", ((1, 1, 1, 1), (8, 16, 24, 32)))
    cfg = config_from_dict(dict(
        embed_dim=32, vision_cfg=dict(timm_model_name="convnext_flags_tiny", image_size=32),
        text_cfg=dict(context_length=8, vocab_size=64, width=32, heads=2, layers=1)), name="convnext-flags")
    monkeypatch.setattr(train_main, "get_model_config", lambda name: cfg)
    with caplog.at_level("WARNING", logger="clipself_tpu_torch"):
        run = train_main.main([
            "--device", "cpu", "--synthetic", "--model", "convnext-flags", "--pretrained-image",
            "--no-lock-image", "--precision", "fp32", "--batch-size", "1", "--det-image-size", "64",
            "--max-boxes", "2", "--steps-per-epoch", "1", "--epochs", "1", "--lr", "1e-3",
            "--logs", str(tmp_path), "--name", "pi",
        ])
    model = run["state"].model
    assert model.cfg.vision.timm_model_pretrained
    assert dataclasses.replace(model.cfg.vision, timm_model_pretrained=False) == cfg.vision
    assert "timm_model_pretrained is set but no weights source is reachable" in caplog.text
    assert math.isfinite(run["history"][-1]["loss"])
    moved = {k.split(".")[1] for k, v in run["teacher"].state_dict().items()
             if not torch.equal(model.state_dict()[k], v)}
    assert moved == {"trunk", "head"}
