"""The port's detector command lines on files (`clipself_tpu_torch/detector/
train.py::main` without ``--synthetic``, `detector/evaluate.py::main`, the
`fvit-test` CLI) against the JAX package's.

- The trainer, on a micro-set written by the port's `tools/synth_det_data.py`
  (`tiny_test`, ``--device cpu``, fp32, 2 epochs), steps on batches EQUAL to
  the JAX CLI's `batches(epoch)` (rebuilt here from the JAX
  `DetectionDataset`, `collate` and the same permutation); its losses are
  finite and its `detector_epoch1.pkl` loads in both packages.
- `fvit-test` on a checkpoint written by the JAX trainer's `save_detector`
  (the port's trainer overfit on the micro-set, so its AP is not 0) returns
  the JAX `main`'s keys with NaN where JAX has NaN (written as null); with
  both packages' models in float32 its metrics equal the JAX `main`'s; it
  honours ``--max-images`` and raises the JAX `SystemExit` texts.
- `tools/detector_seed_sweep.py` scores every seed's checkpoints and removes
  them.
- ``--clip-checkpoint``: a vision-only `.pt` loads non-strictly in both
  packages and both CLIs, and the tiny trunks' taps agree within 1e-5.

The JAX twin `test_detector_cli_overfits_micro_set` (400 epochs) takes ~95 s
through the port on the CPU, so accuracy is left to `chip_smoke.py`'s drive.
"""

import contextlib
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipself_tpu.detector import data as jdata
from clipself_tpu.detector import evaluate as jevaluate
from clipself_tpu.detector import train as jtrain
from clipself_tpu.detector.config import PRESETS as JPRESETS
from clipself_tpu.detector.fvit import FViTDetector as JDetector
from clipself_tpu.models.factory import create_model as jcreate_model
from clipself_tpu_torch.detector import evaluate, train
from clipself_tpu_torch.detector.classes import coco_split
from clipself_tpu_torch.detector.config import PRESETS
from clipself_tpu_torch.detector.fvit import create_detector
from clipself_tpu_torch.models.factory import create_model
from clipself_tpu_torch.models.torch_io import detector_state_dict_to_jax, load_pretrained
from clipself_tpu_torch.tools import detector_seed_sweep, synth_det_data

from torch_threads import capped_threads  # noqa: F401  (module fixture)

CFG = PRESETS["tiny_test"]
SEED, BATCH = 3, 2


@contextlib.contextmanager
def one_thread():
    """Torch on one intra-op thread for the tiny trainings of many steps
    here: more threads only fight the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 5-image micro-set at the preset's 64 px over the 65 OV-COCO
    classes (3 drawn), its class embedding, and a vision-only CLIP `.pt`."""
    root = tmp_path_factory.mktemp("det_cli")
    ann, imgs = synth_det_data.write_synth_det(
        str(root), coco_split()["all"], synth_det_data.gt_classes("coco", 3), n_images=5,
        size=CFG.image_size, seed=2,
    )
    ce = np.random.default_rng(1).normal(size=(CFG.num_classes + 1, CFG.embed_dim)).astype(np.float32)
    np.save(root / "ce.npy", ce)
    clip = create_model(CFG.clip_model, device="cpu", dtype=torch.float32, seed=4)
    torch.save({k: v for k, v in clip.state_dict().items() if k.startswith("visual.")}, root / "visual.pt")
    return {"root": root, "ann": ann, "imgs": imgs, "ce": str(root / "ce.npy"), "pt": str(root / "visual.pt")}


def jax_cli_batches(ann, imgs, epoch):
    """The JAX CLI's `batches(epoch)` (`clipself_tpu/detector/train.py:196-211`)."""
    ds = jdata.DetectionDataset(
        ann, imgs, coco_split()["all"], image_size=CFG.image_size, max_gt=CFG.max_gt,
        train=True, ratio_range=(0.1, 2.0), seed=SEED, with_mask=False,
    )
    ds.set_epoch(epoch)
    order = np.random.default_rng((SEED, epoch)).permutation(len(ds))
    for i in range(len(ds) // BATCH):
        idx = order[i * BATCH : (i + 1) * BATCH]
        yield jdata.collate([ds[int(j)] for j in idx])


def test_train_cli_batches_equal_jax(files, tmp_path, monkeypatch):
    seen = []
    make = train.make_det_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def step_fn(state, batch):
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
            return step(state, batch)

        return step_fn

    monkeypatch.setattr(train, "make_det_train_step", recording)
    out = tmp_path / "out"
    run = train.main([
        "--preset", "tiny_test", "--ann-file", files["ann"], "--image-root", files["imgs"],
        "--class-embed", files["ce"], "--clip-checkpoint", files["pt"], "--batch-size", str(BATCH),
        "--epochs", "2", "--precision", "fp32", "--seed", str(SEED), "--log-every", "1",
        "--output", str(out), "--device", "cpu",
    ])
    want = [b for e in range(2) for b in jax_cli_batches(files["ann"], files["imgs"], e)]
    assert len(seen) == len(want) == 4 and len(run["history"]) == 4
    for got, ref in zip(seen, want):
        ref = {k: v for k, v in ref.items() if k not in ("scale", "image_id")}
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for h in run["history"]:
        assert all(map(math.isfinite, h["metrics"].values())), h
        assert h["data_ms"] >= 0.0
    # the checkpoint loads in both packages, into the detector that wrote it
    path = str(out / "detector_epoch1.pkl")
    det = create_detector(CFG, device="cpu", seed=9)
    det.load_state_dict(evaluate.load_detector(path), strict=True)
    for name, p in run["state"].model.state_dict().items():
        torch.testing.assert_close(det.state_dict()[name], p, rtol=0, atol=0)
    jcfg = JPRESETS["tiny_test"]
    grid = jcfg.image_size // jcfg.patch_size
    taps = [jnp.zeros((1, grid, grid, jcfg.backbone_width))] * len(jcfg.out_indices)
    rois, ce = jnp.asarray([[[4.0, 4.0, 32.0, 32.0]]]), jnp.zeros((jcfg.num_classes + 1, jcfg.embed_dim))
    shapes = jax.eval_shape(lambda k: JDetector(jcfg).init(k, taps, rois, ce)["params"], jax.random.PRNGKey(0))
    loaded = jevaluate.load_detector(path)
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(shapes)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a, s: a.shape == s.shape, loaded, shapes))


@pytest.fixture(scope="module")
def jax_checkpoint(files):
    """A detector checkpoint written by the JAX trainer's `save_detector`:
    the port's trainer run for 80 epochs on the micro-set with the JAX twin
    `test_detector_cli_overfits_micro_set`'s flags (lr 3e-3, no decay, ratio
    1, fp32), its weights carried into the flax tree by
    `detector_state_dict_to_jax`, so that `fvit-test` reads an AP above 0."""
    with one_thread():
        run = train.main([
            "--preset", "tiny_test", "--ann-file", files["ann"], "--image-root", files["imgs"],
            "--class-embed", files["ce"], "--clip-checkpoint", files["pt"], "--batch-size", "5",
            "--epochs", "80", "--lr", "3e-3", "--wd", "0.0", "--ratio-range", "1.0", "1.0",
            "--precision", "fp32", "--log-every", "1000", "--output", str(files["root"] / "overfit"),
            "--device", "cpu",
        ])
    tree = detector_state_dict_to_jax(run["state"].model.state_dict())
    out = files["root"] / "jax_out"
    jtrain.save_detector(str(out), tree, JPRESETS["tiny_test"], 0)
    return str(out / "detector_epoch0.pkl")


def _test_argv(files, ckpt, *extra):
    return [
        "--preset", "tiny_test", "--ann-file", files["ann"], "--image-root", files["imgs"],
        "--class-embed", files["ce"], "--detector-checkpoint", ckpt, "--batch-size", "2", *extra,
    ]


def test_fvit_test_keys_and_nan_as_jax(files, jax_checkpoint, tmp_path):
    argv = _test_argv(files, jax_checkpoint, "--clip-checkpoint", files["pt"])
    want = jevaluate.main(argv)
    got = evaluate.main(argv + ["--device", "cpu", "--out", str(tmp_path / "m.json")])
    assert list(got) == list(want)
    nan = sorted(k for k, v in want.items() if math.isnan(v))
    assert nan == ["AP50_novel"] and sorted(k for k, v in got.items() if math.isnan(v)) == nan
    written = json.loads((tmp_path / "m.json").read_text())
    assert list(written) == list(want) and all(written[k] is None for k in nan)
    assert all(0.0 <= v <= 1.0 for k, v in written.items() if k not in nan)


def test_fvit_test_metrics_equal_jax_in_f32(files, jax_checkpoint, monkeypatch):
    """Both `main`s with their models in float32 (the CLIs run bf16, whose
    rounding alone moves the AP of a 5-image set by a few points in either
    package): the same split, class embedding, trunk and checkpoint give the
    JAX `main`'s metrics. A `main` that skipped the class embedding's
    normalisation reads AP 0 here."""

    class Float32Jnp(types.ModuleType):
        bfloat16 = jnp.float32

        def __getattr__(self, name):
            return getattr(jnp, name)

    monkeypatch.setattr(jevaluate, "jnp", Float32Jnp("jnp"))
    build = evaluate.create_model
    monkeypatch.setattr(evaluate, "create_model",
                        lambda name, device, dtype: build(name, device=device, dtype=torch.float32))
    argv = _test_argv(files, jax_checkpoint, "--clip-checkpoint", files["pt"])
    want = jevaluate.main(argv)
    got = evaluate.main(argv + ["--device", "cpu"])
    assert want["AP50"] > 0.2 and want["mAP"] > 0.05, want
    assert list(got) == list(want)
    for k, v in want.items():
        assert (math.isnan(v) and math.isnan(got[k])) or abs(got[k] - v) <= 0.02, (k, got[k], v)


def test_fvit_test_max_images(files, jax_checkpoint, monkeypatch):
    fetched = []
    getitem = evaluate.DetectionDataset.__getitem__

    def recording(self, idx):
        fetched.append(idx)
        return getitem(self, idx)

    monkeypatch.setattr(evaluate.DetectionDataset, "__getitem__", recording)
    evaluate.main(_test_argv(files, jax_checkpoint, "--max-images", "1", "--device", "cpu"))
    assert set(fetched) == {0}


def test_fvit_test_refusals_as_jax(files, jax_checkpoint, tmp_path):
    cases = [
        _test_argv(files, jax_checkpoint, "--dataset", "lvis"),
        _test_argv(files, jax_checkpoint, "--dataset", "voc"),
    ]
    np.save(tmp_path / "bad.npy", np.ones((12, CFG.embed_dim), np.float32))
    bad = _test_argv(files, jax_checkpoint)
    bad[bad.index("--class-embed") + 1] = str(tmp_path / "bad.npy")
    cases.append(bad)
    for argv in cases:
        with pytest.raises(SystemExit) as ours:
            evaluate.main(argv + ["--device", "cpu"])
        with pytest.raises(SystemExit) as theirs:
            jevaluate.main(argv)
        assert str(ours.value) == str(theirs.value) != ""
    if not torch.cuda.is_available():  # --device defaults to cuda: no CPU run without asking
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(_test_argv(files, jax_checkpoint))


def test_seed_sweep_scores_every_seed(files, tmp_path, monkeypatch):
    tested = []
    test_main = evaluate.main
    monkeypatch.setattr(evaluate, "main", lambda argv: tested.append(argv) or test_main(argv))
    with one_thread():
        result = detector_seed_sweep.main([
            "--root", str(tmp_path), "--preset", "tiny_test", "--device", "cpu", "--seeds", "0", "1",
            "--epochs", "2", "--every", "1", "--precision", "fp32", "--clip-checkpoint", files["pt"],
        ])
    assert set(result["ap50"]) == {0, 1} and all(set(v) == {1, 2} for v in result["ap50"].values())
    assert all(0.0 <= ap <= 1.0 for v in result["ap50"].values() for ap in v.values())
    assert set(result["median_by_epoch"]) == {1, 2}
    # the checkpoint flag reaches fvit-test, the trainer's flags do not
    assert len(tested) == 4 and all("--clip-checkpoint" in a and "--precision" not in a for a in tested)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["class_embed.npy", "set"]


def test_vision_only_checkpoint_loads_in_both(files):
    model = create_model(CFG.clip_model, device="cpu", dtype=torch.float32, seed=0)
    missing = load_pretrained(model, files["pt"])
    assert missing and all(k.startswith("text.") or k == "logit_scale" for k in missing)
    jmodel, jparams = jcreate_model(CFG.clip_model, dtype=jnp.float32, pretrained=files["pt"])
    images = np.random.default_rng(0).normal(size=(2, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    want, _ = jmodel.apply({"params": jparams}, jnp.asarray(images), CFG.out_indices, False, method="visual_taps")
    with torch.no_grad():
        got, _ = model.visual_taps(torch.from_numpy(images), tuple(CFG.out_indices), False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
