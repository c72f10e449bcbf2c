"""The port's prompt-ensemble text embeddings
(`clipself_tpu_torch/tools/text_embeddings.py`) against the JAX package's,
float32 on the CPU with the same weights, on full-vocabulary variants of the
tiny towers (their 512-token vocabularies cannot hold real BPE ids, as in
`tests/test_tools.py`); then the CLI's `.npy` taken by the port's detector
trainer (`--class-embed`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipself_tpu.core.config import get_model_config as jget_model_config
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu.tools import text_embeddings as jte
from clipself_tpu_torch.core.config import get_model_config
from clipself_tpu_torch.detector import train as det_train
from clipself_tpu_torch.detector.classes import _META, coco_split, lvis_split
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.tools import text_embeddings as te

from torch_threads import capped_threads  # noqa: F401  (module fixture)

TOL = 1e-4
CATEGORIES = ["traffic light", "person", "hot dog", "teddy_bear", "sign/board.", "apple", "background"]


def full_vocab(cfg):
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, vocab_size=49408))


def test_category_prompts_equal_over_every_class_name():
    names = coco_split()["all"] + lvis_split()["all"]
    assert len(names) == 1268
    for name in names:
        assert te.category_prompts(name) == jte.category_prompts(name), name
        assert te.category_prompts(name, te.SINGLE_TEMPLATE) == jte.category_prompts(name, jte.SINGLE_TEMPLATE)
    assert te.VILD_TEMPLATES == jte.VILD_TEMPLATES and len(te.VILD_TEMPLATES) == 63


def test_build_text_embeddings_matches_jax():
    name = "EVA02-CLIP-Tiny-Test"
    jmodel, params = jax_create_model(full_vocab(jget_model_config(name)), dtype=jnp.float32, seed=0)
    params = jax.tree.map(np.asarray, params)
    model = CLIP(full_vocab(get_model_config(name)), torch.float32).eval()
    load_weights(model, state_dict_from_jax(params))
    want = jte.build_text_embeddings(jmodel, params, CATEGORIES)
    timings = {}
    got = te.build_text_embeddings(model, CATEGORIES, timings=timings)
    assert got.shape == want.shape == (len(CATEGORIES), 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    assert timings["tokenize"] > 0
    # batches of 64 prompts or of 10 give the same rows
    np.testing.assert_allclose(te.build_text_embeddings(model, CATEGORIES[:2], batch_size=10), got[:2],
                               rtol=0, atol=1e-6)


def test_cli_matrix_feeds_the_detector_trainer(tmp_path, monkeypatch):
    """`--classes-json` of the 65 OV-COCO classes with `--add-background` on
    the detector preset `tiny_test`'s tower (embed_dim 32) gives the
    (66, 32) class matrix that `detector/train.py --class-embed` takes; the
    default `--device cuda` without a card is an error."""
    out = tmp_path / "coco_bg.npy"
    argv = ["--model", "EVA02-CLIP-Tiny-Det-Test", "--classes-json",
            str(_META / "mscoco_65_classes.json"), "--add-background", "--out", str(out)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.main(argv)
    monkeypatch.setattr(te, "get_model_config", lambda name: full_vocab(get_model_config(name)))
    emb = te.main(argv + ["--device", "cpu"])
    arr = np.load(out)
    np.testing.assert_array_equal(arr, emb)
    assert arr.shape == (66, 32) and np.isfinite(arr).all()
    np.testing.assert_allclose(np.linalg.norm(arr, axis=-1), 1.0, atol=1e-6)

    run = det_train.main([
        "--synthetic", "--preset", "tiny_test", "--device", "cpu", "--batch-size", "2",
        "--epochs", "1", "--steps-per-epoch", "1", "--class-embed", str(out),
        "--output", str(tmp_path / "det"),
    ])
    metrics = run["history"][-1]["metrics"]
    assert np.isfinite(metrics["loss"])
    assert (tmp_path / "det" / "detector_epoch0.pkl").is_file()
