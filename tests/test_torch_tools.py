"""`clipself_tpu_torch.tools.profile_paths` on the CPU: the kernel classes it
sorts names into, and the control flow of a run at the tiny test size, which
reports host time only and says that no device time was measured. The
kernels' timing tool (`side_by_side`) measures nothing without a card and
says so."""

import pytest
import torch

from clipself_tpu_torch.tools import profile_paths, side_by_side

from torch_threads import capped_threads  # noqa: F401  (module fixture)


@pytest.mark.parametrize(
    "name,label",
    [
        ("void (anonymous namespace)::flash_bwd_kernel<__nv_bfloat16, 64>(...)", "flash_attention_bwd kernel"),
        ("void (anonymous namespace)::wg::flash_bwd_dkdv_wgmma_kernel<80>(...)", "flash_attention_bwd kernel"),
        ("void (anonymous namespace)::wg::flash_bwd_dq_wgmma_kernel<112, 2>(...)", "flash_attention_bwd kernel"),
        ("void (anonymous namespace)::flash_bwd_dq_kernel<float, 64>(...)", "flash_attention_bwd kernel"),
        ("void (anonymous namespace)::wg::flash_fwd_wgmma_kernel<96, 1>(...)", "flash_attention forward kernel"),
        ("void (anonymous namespace)::flash_bwd_di_kernel<float>(...)", "flash backward di pass, dQ cast"),
        ("void (anonymous namespace)::flash_fwd_kernel<float, 64>(...)", "flash_attention forward kernel"),
        ("void (anonymous namespace)::x3::flash_fwd_x3_kernel<64, 4>(...)", "flash_attention forward kernel"),
        ("void (anonymous namespace)::x3::flash_bwd_dkdv_x3_kernel<112>(...)", "flash_attention_bwd kernel"),
        ("void (anonymous namespace)::x3::flash_bwd_dq_x3_kernel<64>(...)", "flash_attention_bwd kernel"),
        ("void (anonymous namespace)::layer_norm_fwd_kernel<__nv_bfloat16, 8>(...)", "layer_norm forward kernel"),
        ("void (anonymous namespace)::layer_norm_bwd_kernel<float, 4>(...)", "layer_norm backward kernel and its reduce"),
        ("(anonymous namespace)::layer_norm_bwd_reduce_kernel(...)", "layer_norm backward kernel and its reduce"),
        ("void rope_roll_kernel<float>(...)", "rope_roll kernel"),
        ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "GEMMs (cuBLAS)"),
        ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", "AdamW multi-tensor kernels"),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<...>>", "reductions"),
        ("Memcpy DtoD (Device -> Device)", "dtype casts and copies"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::silu_kernel...>", "elementwise"),
        ("(anonymous namespace)::nms_matrix_kernel(float4 const*, float, unsigned long long*, int, int)", "nms bit-matrix kernel"),
        ("void (anonymous namespace)::nms_scan_kernel(unsigned long long const*, unsigned char const*, unsigned char*, int, int)", "nms scan kernel"),
        ("void (anonymous namespace)::rope_roll_kernel<__nv_bfloat16, 8>(...)", "rope_roll kernel"),
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_cudnn", "convolutions (cuDNN)"),
        ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(...)", "GroupNorm"),
        ("void at::native::radixSortKVInPlace<2, -1, 128, 32, float, long, unsigned int>(...)", "sorts"),
        ("void at::native::_scatter_gather_elementwise_kernel<128, 8, ...>", "gathers and index selections"),
        ("void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float, float, float, ...>", "softmax"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl(...)>", "GELU and sigmoid"),
        ("something_else", "other"),
    ],
)
def test_kernel_names_fall_into_their_class(name, label):
    assert profile_paths.classify(name) == label


def test_cpu_run_reports_no_device_time(capsys):
    out = profile_paths.main([
        "--device", "cpu", "--model", "EVA02-CLIP-Tiny-Test", "--det-image-size", "64",
        "--max-boxes", "3", "--max-anns", "8", "--valid-anns", "3", "--steps", "1",
    ])
    for path in ("train", "eval"):
        assert out[path]["device"].startswith("not measured")
        assert "classes" not in out[path] and "kernel_ms" not in out[path]
    printed = capsys.readouterr().out
    assert printed.count("not measured") == 2 and "images/s" not in printed


def test_cpu_eval_only_run_skips_the_step(capsys):
    out = profile_paths.main([
        "--device", "cpu", "--model", "EVA02-CLIP-Tiny-Test", "--det-image-size", "64",
        "--max-anns", "8", "--valid-anns", "3", "--steps", "1", "--eval-only",
    ])
    assert "train" not in out and out["eval"]["device"].startswith("not measured")
    printed = capsys.readouterr().out
    assert printed.count("not measured") == 1 and "distill step" not in printed


def test_cpu_detector_run_reports_no_device_time(capsys):
    out = profile_paths.main([
        "--device", "cpu", "--path", "detector", "--preset", "tiny_test", "--det-batch", "2",
        "--steps", "1",
    ])
    assert out["preset"] == "tiny_test" and out["image"] == 64
    for path in ("predict", "evaluate"):
        assert out[path]["device"].startswith("not measured")
        assert "classes" not in out[path]
    printed = capsys.readouterr().out
    assert printed.count("not measured") == 2 and "images/s" not in printed


def test_cpu_detector_train_run_reports_no_device_time(capsys):
    out = profile_paths.main([
        "--device", "cpu", "--path", "detector_train", "--preset", "tiny_test", "--det-batch", "2",
        "--steps", "1",
    ])
    assert out["preset"] == "tiny_test" and out["train"]["device"].startswith("not measured")
    assert "classes" not in out["train"]
    printed = capsys.readouterr().out
    assert printed.count("not measured") == 1 and "images/s" not in printed and "train step" in printed


def test_cpu_text_run_reports_no_device_time(capsys, monkeypatch):
    """`--path text` on a full-vocabulary tiny text tower (real BPE ids do
    not fit the registered tiny vocabulary)."""
    import dataclasses

    from clipself_tpu_torch.core.config import get_model_config

    tiny = get_model_config("EVA02-CLIP-Tiny-Test")
    full = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, vocab_size=49408))
    build = profile_paths.create_model
    monkeypatch.setattr(profile_paths, "create_model", lambda name, **kw: build(full, **kw))
    out = profile_paths.main([
        "--device", "cpu", "--path", "text", "--model", "EVA02-CLIP-Tiny-Test", "--steps", "1",
    ])
    assert out["model"] == "EVA02-CLIP-Tiny-Test" and out["text"]["device"].startswith("not measured")
    printed = capsys.readouterr().out
    assert printed.count("not measured") == 1 and "prompts/s" not in printed
    assert "66 classes, 4158 prompts" in printed


@pytest.mark.parametrize("preset,name,classes", [
    ("ov_coco_vitb16", "coco", 65), ("ov_coco_vitl14", "coco", 65), ("ov_lvis_vitb16", "lvis", 1203),
    ("ov_lvis_vitl14", "lvis", 1203), ("transfer_voc_vitl14", "voc", 20), ("tiny_test", "coco", 65),
])
def test_detector_paths_take_the_split_of_their_preset(preset, name, classes):
    """The LVIS presets are scored under the LVIS protocol (`lvis_split()`
    has the frequency groups), the others under their own vocabulary."""
    from clipself_tpu_torch.detector.config import PRESETS

    got, split = profile_paths.preset_split(preset)
    assert got == name and len(split["all"]) == classes == PRESETS[preset].num_classes
    assert ("freq_groups" in split) == (name == "lvis")


@pytest.mark.parametrize("preset", ["transfer_voc_vitl14", "transfer_objects365_vitl14"])
def test_detector_train_refuses_transfer_presets(preset, capsys):
    """A transfer preset is only evaluated: the train path says so before it
    builds anything."""
    with pytest.raises(SystemExit):
        profile_paths.main(["--device", "cpu", "--path", "detector_train", "--preset", preset])
    assert "transfer preset" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal is for a machine without a card")
def test_kernel_timing_tools_refuse_to_run_without_a_card(capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        side_by_side.main(["--root", "."])
    assert "ms" not in capsys.readouterr().out


def test_side_by_side_times_the_main_paths_shapes():
    """The shapes it times are the ones `chip_smoke.py` checks the
    kernels at: 2000 candidates an image, the towers' token counts and
    widths at head_dim 64, the LayerNorm backward at the four widths of
    the B/16 and L/14 students, the L/14 teacher's crops and the final
    norm's two views, the flash forward (with and without its LSE) at the
    B/16 student's shape, one 896^2 image of the wide towers at head dims
    80, 88, 104 and 112 (wgmma on two-panel tiles), the HF trunk's float32
    student and its crops and the float32 rows at the student's, the
    pipeline microbatch's and the wide towers' shapes (tf32x3), and the
    flash backward at the same shapes but the crops and at the RegionCLIP
    step's, every shape once, forward before backward."""
    assert {(b, n) for _, b, n, _ in side_by_side.NMS_SHAPES} == {(8, 2000), (1, 2000)}
    tokens = {(b, 1 + g * g, w) for b, g, w in side_by_side.ROPE_SHAPES}
    assert {(2, 4097, 768), (2, 4097, 1024), (40, 577, 1024), (8, 1601, 768)} <= tokens
    assert all(w % side_by_side.HEAD_DIM == 0 for _, _, w in side_by_side.ROPE_SHAPES)
    main = {shape for shape, view in side_by_side.LN_SHAPES if not view}
    assert {(2, 4097, 768), (2, 4097, 2048), (2, 4097, 1024), (2, 4097, 2730), (40, 577, 1024)} == main
    assert {view for _, view in side_by_side.LN_SHAPES} == set(side_by_side.LN_VIEWS)
    wide = {((1, 4097, 16, d), dt) for d in (80, 88, 104, 112) for dt in ("bfloat16", "float32")}
    fwd = {((2, 4097, 12, 64), "bfloat16"), ((2, 4097, 12, 64), "float32"), ((2, 197, 12, 64), "float32"),
           ((1, 4097, 12, 64), "float32")}
    crops = ((50, 197, 12, 64), "float32")
    assert set(side_by_side.FLASH_FWD_SHAPES) == fwd | wide | {crops}
    assert set(side_by_side.FLASH_BWD_SHAPES) == fwd | wide | {((16, 4097, 12, 64), "bfloat16")}
    assert len(set(side_by_side.FLASH_BWD_SHAPES)) == len(side_by_side.FLASH_BWD_SHAPES)
    assert set(side_by_side.FLASH_SHAPES) == set(side_by_side.FLASH_FWD_SHAPES) | set(side_by_side.FLASH_BWD_SHAPES)
    assert len(set(side_by_side.FLASH_SHAPES)) == len(side_by_side.FLASH_SHAPES)


def test_profile_paths_builds_the_hf_vit_b16_of_chip_smoke():
    """`--model hf-vit-b16-224` is the HF ViT-B/16 that `chip_smoke.py`'s HF
    phase runs: `hf-vit-tiny-test`'s adapter with its trunk at ViTConfig's
    defaults, crops at 224^2, embed 512; other names come from the registry."""
    cfg = profile_paths.model_config(profile_paths.HF_VIT_B16)
    assert (cfg.name, cfg.embed_dim) == ("hf-vit-b16-224", 512)
    assert (cfg.vision.hf_trunk_name, cfg.vision.hf_trunk_kwargs, cfg.vision.image_size) == ("vit", "{}", 224)
    assert profile_paths.model_config("hf-vit-tiny-test").embed_dim == 16


def test_port_test_modules_run_on_their_share_of_the_cores(capped_threads):
    """Under pytest-xdist each worker's port test modules run on
    ``cpu_count // workers`` torch threads (`tests/torch_threads.py`), so
    that the workers do not contend for the cores; alone, on all of them."""
    import torch_threads

    assert capped_threads == torch.get_num_threads() <= torch_threads.thread_share()


def test_kernel_resources_reads_ptxas_output():
    """`tools/kernel_resources.py` takes each kernel's registers, stack and
    spill bytes from `ptxas -v`'s lines, in order, a kernel without spills
    at zero."""
    from clipself_tpu_torch.tools import kernel_resources

    text = (
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    24 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 24 bytes cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n"
    )
    rows = kernel_resources.parse(text)
    assert [(r["kernel"], r["registers"], r["stack"], r["spill_stores"], r["spill_loads"]) for r in rows] == [
        ("_Z3fooPf", 255, 24, 24, 20), ("_Z3barv", 40, 0, 0, 0),
    ]
