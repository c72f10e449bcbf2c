"""The port's trainer CLI (`python -m clipself_tpu_torch.train.main`) on the
CPU with synthetic data on `EVA02-CLIP-Tiny-Test`: train, save, resume, the
alpha-ensemble on save, and the refusals. A resumed run must end where an
uninterrupted run ends (same ops in the same order on the CPU: 1e-6)."""

import os

import pytest
import torch

from clipself_tpu_torch.train import checkpoint as ckpt
from clipself_tpu_torch.train import main as train_main

ALPHA = 0.7


def _argv(logs, name, epochs, *extra):
    return [
        "--device", "cpu", "--synthetic", "--model", "EVA02-CLIP-Tiny-Test",
        "--precision", "fp32", "--batch-size", "2", "--det-image-size", "48",
        "--max-boxes", "3", "--steps-per-epoch", "2", "--epochs", str(epochs),
        "--lr", "1e-3", "--warmup", "1", "--log-every-n-steps", "1",
        "--alpha", str(ALPHA), "--logs", str(logs), "--name", name, *extra,
    ]


def test_train_save_resume_and_ensemble(tmp_path):
    run1 = train_main.main(_argv(tmp_path, "run", 1))
    hist = run1["history"]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    ckpt_dir = os.path.join(tmp_path, "run", "checkpoints")
    assert ckpt.latest_epoch(ckpt_dir) == 1
    assert os.path.isfile(os.path.join(tmp_path, "run", "params.txt"))

    # the saved params are alpha * student + (1 - alpha) * teacher
    saved = ckpt.load_params(ckpt_dir)
    student = run1["state"].model.state_dict()
    teacher = run1["teacher"].state_dict()
    assert saved.keys() == student.keys()
    moved = 0
    for k, v in saved.items():
        torch.testing.assert_close(v, ALPHA * student[k] + (1 - ALPHA) * teacher[k], rtol=0, atol=1e-7)
        moved += not torch.equal(student[k], teacher[k])
    assert moved > 0

    # resume continues at epoch 1, step 2, and ends where one run of 2 epochs ends
    run2 = train_main.main(_argv(tmp_path, "run", 2, "--resume", "auto"))
    assert [h["epoch"] for h in run2["history"]] == [1, 1]
    assert run2["state"].step == 4 and ckpt.latest_epoch(ckpt_dir) == 2
    whole = train_main.main(_argv(tmp_path, "whole", 2))
    for k, v in whole["state"].model.state_dict().items():
        torch.testing.assert_close(run2["state"].model.state_dict()[k], v, rtol=0, atol=1e-6)
    assert run2["history"][-1]["loss"] == pytest.approx(whole["history"][-1]["loss"], abs=1e-6)

    # the export is a reference-layout checkpoint the port's loader takes
    path = os.path.join(tmp_path, "export.pt")
    ckpt.export_torch(path, saved, epoch=1, name="run")
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.models.torch_io import load_weights

    model = create_model("EVA02-CLIP-Tiny-Test", device="cpu", dtype=torch.float32, seed=9)
    load_weights(model, path)
    assert torch.equal(model.visual.head.weight, saved["visual.head.weight"])


def test_grad_checkpointing_flag_recomputes_and_ends_where_the_plain_run_ends(tmp_path):
    """`--grad-checkpointing` builds the student with block recomputation;
    the same float32 operations run again in the backward pass, so the run
    ends where the run without it ends."""
    plain = train_main.main(_argv(tmp_path, "plain", 1))
    remat = train_main.main(_argv(tmp_path, "remat", 1, "--grad-checkpointing"))
    assert remat["state"].model.visual.grad_checkpointing
    assert not plain["state"].model.visual.grad_checkpointing
    for a, b in zip(remat["history"], plain["history"]):
        assert a["loss"] == pytest.approx(b["loss"], abs=1e-6)
    for k, v in plain["state"].model.state_dict().items():
        torch.testing.assert_close(remat["state"].model.state_dict()[k], v, rtol=0, atol=1e-6)
    with open(os.path.join(tmp_path, "remat", "params.txt")) as f:
        assert "grad_checkpointing: True" in f.read()


def test_cuda_device_without_a_card_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a if a != "cpu" else "cuda" for a in _argv(tmp_path, "cuda", 1)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main.main(argv)
    assert not os.path.exists(os.path.join(tmp_path, "cuda"))


def test_real_data_and_missing_steps_are_refused(tmp_path):
    """A run with no data source (neither --synthetic, --train-data nor
    --val-data) and a synthetic run without --steps-per-epoch are refused
    before anything is written; files are tested in test_torch_train_data.py."""
    argv = [a for a in _argv(tmp_path, "x", 1) if a != "--synthetic"]
    with pytest.raises(ValueError, match="--synthetic, --train-data or --val-data"):
        train_main.main(argv)
    assert not os.listdir(tmp_path)
    argv = _argv(tmp_path, "x", 1)
    i = argv.index("--steps-per-epoch")
    with pytest.raises(ValueError, match="steps-per-epoch"):
        train_main.main(argv[:i] + argv[i + 2:])


def test_mesh_flags_parse_and_are_checked_as_the_jax_trainer_checks_them(tmp_path, monkeypatch):
    """`--n-devices`, `--fsdp-size` and `--tp-size` parse; a mesh that does not
    divide the device count and a batch that does not divide over the batch
    shards raise the JAX trainer's errors in its words; without a launcher
    the run has one process, so `--n-devices 2` and `--fsdp-size 2` are
    refused before anything is written; `--tp-size 2` on a tower that the
    tensor-parallel plan does not cover names the ROADMAP item where its
    rules wait. The mesh runs themselves are in test_torch_parallel.py."""
    from clipself_tpu.train import main as jax_main
    from clipself_tpu_torch.parallel.mesh import check_batch, mesh_shape

    for k in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    args = train_main.parse_args(["--n-devices", "8", "--fsdp-size", "2", "--tp-size", "2"])
    assert (args.n_devices, args.fsdp_size, args.tp_size) == (8, 2, 2)
    assert train_main.parse_args([]).n_devices is None
    assert mesh_shape(8, 2, 2) == (2, 2, 2)

    jax_argv = [
        "--synthetic", "--model", "EVA02-CLIP-Tiny-Test", "--det-image-size", "48",
        "--max-boxes", "3", "--steps-per-epoch", "1", "--epochs", "1", "--logs", str(tmp_path / "jax"),
    ]
    for extra, port_check in (
        (["--n-devices", "8", "--fsdp-size", "3"], lambda: mesh_shape(8, 3, 1)),
        (["--n-devices", "8", "--fsdp-size", "2", "--batch-size", "4"], lambda: check_batch(4, 8)),
    ):
        with pytest.raises(AssertionError) as jax_err:
            jax_main.main(jax_argv + extra)
        with pytest.raises(ValueError) as port_err:
            port_check()
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(AssertionError) as jax_err:
        jax_main.main(jax_argv + ["--n-devices", "1", "--fsdp-size", "2"])
    with pytest.raises(ValueError) as port_err:
        train_main.main(_argv(tmp_path, "mesh", 1, "--fsdp-size", "2"))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="--n-devices 2: the launch has 1 process"):
        train_main.main(_argv(tmp_path, "mesh", 1, "--n-devices", "2"))
    argv = [a if a != "EVA02-CLIP-Tiny-Test" else "ViT-Tiny-Test" for a in _argv(tmp_path, "vit", 1)]
    with pytest.raises(ValueError, match="ROADMAP.md queue 1, item 9.2"):
        train_main.main(argv + ["--tp-size", "2"])
    assert not {"mesh", "vit"} & set(os.listdir(tmp_path))  # the port wrote nothing


def test_resume_auto_needs_a_name_in_both_packages(tmp_path, caplog):
    """`--resume auto` without `--name` is refused with the JAX trainer's
    ValueError by both trainers; with a name and no checkpoint yet, the
    port's run says so and starts at epoch 0."""
    from clipself_tpu.train import main as jax_main

    argv = _argv(tmp_path, "x", 1) + ["--resume", "auto"]
    i = argv.index("--name")
    unnamed = argv[:i] + argv[i + 2:]
    with pytest.raises(ValueError, match="--resume auto needs --name"):
        train_main.main(unnamed)
    assert not os.listdir(tmp_path)
    jax_argv = [
        "--synthetic", "--model", "EVA02-CLIP-Tiny-Test", "--n-devices", "1", "--batch-size", "2",
        "--det-image-size", "48", "--max-boxes", "3", "--steps-per-epoch", "2",
        "--epochs", "1", "--logs", str(tmp_path / "jax"), "--resume", "auto",
    ]
    with pytest.raises(ValueError, match="--resume auto needs --name"):
        jax_main.main(jax_argv)

    with caplog.at_level("INFO", logger="clipself_tpu_torch"):
        run = train_main.main(argv)
    assert "--resume auto: no checkpoint yet, starting fresh" in caplog.text
    assert [h["epoch"] for h in run["history"]] == [0, 0] and run["state"].step == 2
