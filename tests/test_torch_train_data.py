"""The port's trainer (`python -m clipself_tpu_torch.train.main`) on files, on
the CPU with `EVA02-CLIP-Tiny-Test`: `--train-data` for grid_distill (the
NumPy route and `--native-loader`) and proposals_distill, `--val-data` before
training and after each epoch, and alone. `results.jsonl` is strict JSON
(NaN written as null). The evaluation-only run's metrics equal the JAX
evaluator's over the JAX dataset's batches on the same weights within 1e-6
(float32 on the CPU: the logits agree within 1e-4, the top-k choices are
equal)."""

import json
import math

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clipself_tpu.data import datasets as jdatasets
from clipself_tpu.eval import zero_shot as jzero_shot
from clipself_tpu.models.factory import create_model as jax_create_model
from clipself_tpu_torch.models.clip import CLIP
from clipself_tpu_torch.models.torch_io import load_weights, state_dict_from_jax
from clipself_tpu_torch.train import main as train_main
from conftest import write_micro_coco

from torch_threads import capped_threads  # noqa: F401  (module fixture)

NAME = "EVA02-CLIP-Tiny-Test"
N_CLASSES = 7  # 4 things, 3 stuff
EVAL_KEYS = sorted(
    f"{src}.{group}.macc{k}"
    for src in ("rois", "crops", "maskpool") for group in ("thing", "stuff") for k in (1, 5)
)


def write_panoptic(root, n_images=5, seed=0):
    """A COCO-panoptic corpus: PNG images, segment PNGs with 3 thing and 2
    stuff segments each over 7 categories, the panoptic JSON and a random
    [7, 64] class embedding; plus a copy of the JSON whose categories are all
    things (its stuff metrics are NaN)."""
    rng = np.random.default_rng(seed)
    img_dir, seg_dir = root / "val", root / "pan"
    img_dir.mkdir()
    seg_dir.mkdir()
    images, annotations = [], []
    for i in range(n_images):
        w, h = 72 + 8 * i, 56 + 4 * i
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(img_dir / f"{i}.png")
        ids = np.zeros((h, w), np.int64)
        ids[: h // 2] = 1
        ids[h // 2 :] = 2  # two stuff bands
        segments = [
            {"id": s, "category_id": 4 + (s + i) % 3, "bbox": [0, y0, w, h // 2],
             "area": int((ids == s).sum())}
            for s, y0 in ((1, 0), (2, h // 2))
        ]
        for s in (3, 4, 5):
            x0, y0 = int(rng.integers(0, w - 20)), int(rng.integers(0, h - 16))
            bw, bh = int(rng.integers(8, 20)), int(rng.integers(8, 16))
            ids[y0 : y0 + bh, x0 : x0 + bw] = s
            segments.append({"id": s, "category_id": int(rng.integers(0, 4)),
                             "bbox": [x0, y0, bw, bh], "area": bw * bh})
        seg = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        Image.fromarray(seg).save(seg_dir / f"{i}.png")
        images.append({"id": i, "file_name": f"{i}.png", "width": w, "height": h})
        annotations.append({"image_id": i, "file_name": f"{i}.png", "segments_info": segments})
    cats = [{"id": c, "name": f"c{c}", "isthing": int(c < 4)} for c in range(N_CLASSES)]
    (root / "panoptic.json").write_text(
        json.dumps({"images": images, "annotations": annotations, "categories": cats})
    )
    for c in cats:
        c["isthing"] = 1
    (root / "things.json").write_text(
        json.dumps({"images": images, "annotations": annotations, "categories": cats})
    )
    np.save(root / "emb.npy", rng.standard_normal((N_CLASSES, 64)).astype(np.float32))
    return img_dir, seg_dir


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    img_dir, _ = write_micro_coco(root, n_images=4, anns_per_image=3)
    val_dir, seg_dir = write_panoptic(root)
    return root, str(img_dir), str(val_dir), str(seg_dir)


def _val(corpus, json_name="panoptic.json"):
    root, _, val_dir, seg_dir = corpus
    return [
        "--val-data", str(root / json_name), "--val-image-root", val_dir,
        "--val-segm-root", seg_dir, "--embed-path", str(root / "emb.npy"),
    ]


def _argv(corpus, logs, name, *extra):
    root, img_dir, _, _ = corpus
    return [
        "--device", "cpu", "--model", NAME, "--precision", "fp32", "--batch-size", "2",
        "--det-image-size", "64", "--max-boxes", "4", "--max-split", "3", "--epochs", "2",
        "--workers", "0", "--lr", "1e-3", "--warmup", "1", "--log-every-n-steps", "1",
        "--train-data", str(root / "instances.json"), "--train-image-root", img_dir,
        "--zeroshot-frequency", "1", "--logs", str(logs), "--name", name, *extra,
    ]


def _strict_lines(path):
    def refuse(token):
        raise ValueError(f"bare {token} in results.jsonl")

    return [json.loads(line, parse_constant=refuse) for line in path.read_text().splitlines()]


@pytest.mark.parametrize(
    "route,extra,val_json",
    [
        ("grid", [], "panoptic.json"),
        ("grid_native", ["--native-loader", "--workers", "2"], "panoptic.json"),
        ("proposals", ["--dataset-type", "proposals_distill", "--min-size", "2"], "things.json"),
    ],
)
def test_file_data_training_with_eval(corpus, tmp_path, route, extra, val_json):
    run = train_main.main(_argv(corpus, tmp_path, route, *extra) + _val(corpus, val_json))
    hist = run["history"]
    # 4 images at batch 2: two steps an epoch by default
    assert [(h["epoch"], h["step"]) for h in hist] == [(0, 1), (0, 2), (1, 3), (1, 4)]
    assert all(math.isfinite(h["loss"]) for h in hist)
    lines = _strict_lines(tmp_path / route / "results.jsonl")
    assert [r["epoch"] for r in lines] == [0, 1, 2]  # before training, after each epoch
    assert lines == run["evals"]
    for r in lines:
        assert sorted(k for k in r if k != "epoch") == EVAL_KEYS
        for k in EVAL_KEYS:
            if val_json == "things.json" and ".stuff." in k:
                assert r[k] is None  # NaN: no stuff segment in this val set
            else:
                assert 0.0 <= r[k] <= 1.0
    if route == "grid_native":
        assert "native loader: 0 row(s) built by the NumPy route" in (
            tmp_path / route / "out.log"
        ).read_text()


def test_eval_only_equals_the_jax_evaluator(corpus, tmp_path, monkeypatch):
    """`--val-data` without `--train-data` evaluates once; on weights carried
    across from the JAX model its metrics are the JAX `evaluate_zero_shot`'s
    over the JAX `COCOPanopticEvalDataset` in batches of 2, tail kept."""
    jmodel, params = jax_create_model(NAME, dtype=jnp.float32, seed=0)
    params = jax.tree.map(np.asarray, params)
    sd = state_dict_from_jax(params)

    def carried(cfg, *, device, dtype, seed, grad_checkpointing):
        model = CLIP(cfg, torch.float32)
        load_weights(model, sd)
        return model.to(device).eval()

    monkeypatch.setattr(train_main, "create_model", carried)
    argv = [
        "--device", "cpu", "--model", NAME, "--precision", "fp32", "--det-image-size", "64",
        "--val-batch-size", "2", "--workers", "0", "--logs", str(tmp_path), "--name", "eval",
    ] + _val(corpus)
    got = train_main.main(argv)
    assert "state" not in got and len(got["evals"]) == 1
    assert _strict_lines(tmp_path / "eval" / "results.jsonl") == got["evals"]

    root, _, val_dir, seg_dir = corpus
    ds = jdatasets.COCOPanopticEvalDataset(
        str(root / "panoptic.json"), val_dir, seg_dir, embed_path=str(root / "emb.npy"),
        det_size=64, crop_size=32, downsample_factor=8,
    )
    items = [ds[i] for i in range(len(ds))]
    batches = [
        {k: np.stack([it[k] for it in items[i : i + 2]]) for k in items[0]}
        for i in range(0, len(items), 2)
    ]
    assert [len(b["images"]) for b in batches] == [2, 2, 1]
    want = jzero_shot.evaluate_zero_shot(jmodel, params, batches, ds.embeddings, ann_bucket=25)
    result = got["evals"][0]
    assert result.pop("epoch") == 0
    assert sorted(result) == sorted(want) == EVAL_KEYS
    for k, v in want.items():
        assert result[k] == pytest.approx(v, abs=1e-6), k


def test_region_clip_and_bad_data_flags_are_refused(corpus, tmp_path):
    # region_clip runs since the RegionCLIP slice; without its noun embeddings it is
    # refused before any model is built (tests/test_torch_train_flags.py runs it)
    with pytest.raises(ValueError, match="--train-embed-path"):
        train_main.main(_argv(corpus, tmp_path, "rc", "--dataset-type", "region_clip"))
    assert not (tmp_path / "rc").exists()
    with pytest.raises(ValueError, match="--embed-path"):
        train_main.main(_argv(corpus, tmp_path, "emb") + _val(corpus)[:-2])
    # 4 images make 2 batches of 2: a third step a pass is refused up front
    with pytest.raises(ValueError, match="has 2 batches of 2"):
        train_main.main(_argv(corpus, tmp_path, "steps", "--steps-per-epoch", "3"))
