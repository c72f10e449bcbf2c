"""The port imports no JAX, Flax, PIL, `regex`, `ftfy` or JAX-package
module: in a fresh interpreter (this test process has JAX loaded by
conftest), import every module of the port, run the tiny evaluator, one
train step, the tiny detector evaluation (COCO protocol, and LVIS protocol
with a mask head: the mask paster's rasters need no PIL), one tiny detector
train step, and the text tower (`encode_text`, `build_text_embeddings` and
the text-embedding CLI on a full-vocabulary tiny tower) on the CPU; then the
input pipeline: a grid `--train-data` step and an evaluation-only run on a
PNG corpus that this process wrote (PNGs are decoded without PIL); and the
RegionCLIP trainer route (`--dataset-type region_clip`) on that corpus with
`--accum-freq 2`, `--export-torch` and then `--pretrained` on its export;
and the detector's file path: a set written by the port's
`tools/synth_det_data.py`, one file-fed tiny detector train step and
`fvit-test` on its checkpoint; and the plain OpenCLIP ViT (`ViT-Tiny-Test`):
one evaluator batch at extract type v1 and one train step with
`--extract-type v1 --force-quick-gelu`; the ModifiedResNet (`RN-Tiny-Test`):
one evaluator batch at v1 and one train step with
`--lock-image-freeze-bn-stats`; and the EVA01 / bigE variants (the tiny EVA
tower with a fused `qkv`, the GELU MLP, no RoPE, post-norm blocks and a
shared rel-pos bias): one dense map; and a timm ConvNeXt (`convnext_base`'s
config on a tiny arch): one evaluator batch and one `--no-lock-image`
train step; and a tiny CoCa (`models/coca.py`, with the attentional pooler
and `train/contrastive.py`): `coca_loss` and a sampled caption; and the HF
towers without `transformers`: `hf-vit-tiny-test` (the trunk adapter) and
a tiny 'roberta' text tower, each encoding, and one `--no-lock-image`
distill step on `hf-vit-tiny-test`. Neither `transformers` nor its
`tokenizers`, `sentencepiece` or `safetensors` is loaded. The multi-process
modules (`parallel/`) are imported with the rest."""

import json
import math
import os
import subprocess
import sys

from conftest import write_micro_coco

from torch_threads import capped_threads  # noqa: F401  (module fixture)

_SCRIPT = r"""
import json, math, sys
import torch
import clipself_tpu_torch.core.config
import clipself_tpu_torch.data.synthetic as synthetic
import clipself_tpu_torch.eval.zero_shot as zero_shot
import clipself_tpu_torch.models.factory as factory
import clipself_tpu_torch.models.torch_io
import clipself_tpu_torch.ops._build
import clipself_tpu_torch.ops.attention
import clipself_tpu_torch.ops.hopper_mma_probe
import clipself_tpu_torch.ops.layer_norm
import clipself_tpu_torch.ops.rope_roll
import clipself_tpu_torch.parallel.mesh
import clipself_tpu_torch.parallel.tensor_parallel
import clipself_tpu_torch.core.constants
import clipself_tpu_torch.data.coco
import clipself_tpu_torch.data.datasets
import clipself_tpu_torch.data.image_io
import clipself_tpu_torch.data.loader
import clipself_tpu_torch.data.native_loader
import clipself_tpu_torch.data.transforms
import clipself_tpu_torch.tools.detector_seed_sweep
import clipself_tpu_torch.tools.profile_paths
import clipself_tpu_torch.tools.side_by_side
import clipself_tpu_torch.tools.kernel_resources
import clipself_tpu_torch.train.checkpoint
import clipself_tpu_torch.train.ensemble
import clipself_tpu_torch.train.main as train_main
import clipself_tpu_torch.train.methods
import clipself_tpu_torch.train.optim
import clipself_tpu_torch.train.step
import clipself_tpu_torch.utils.meters
import clipself_tpu_torch.ops.nms
import clipself_tpu_torch.ops.roi_align
import clipself_tpu_torch.ops.interpolate
import clipself_tpu_torch.detector.anchors
import clipself_tpu_torch.detector.boxes
import clipself_tpu_torch.detector.classes
import clipself_tpu_torch.detector.config as det_config
import clipself_tpu_torch.detector.data as det_data
import clipself_tpu_torch.detector.eval_ap
import clipself_tpu_torch.detector.eval_lvis
import clipself_tpu_torch.detector.evaluate as det_evaluate
import clipself_tpu_torch.detector.fvit as fvit
import clipself_tpu_torch.detector.layers
import clipself_tpu_torch.detector.neck
import clipself_tpu_torch.detector.nms
import clipself_tpu_torch.detector.roi_head
import clipself_tpu_torch.detector.rpn
import clipself_tpu_torch.detector.targets
import clipself_tpu_torch.detector.train as det_train
import clipself_tpu_torch.models.text_transformer
import clipself_tpu_torch.tokenizer as tokenizer
import clipself_tpu_torch.tools.text_embeddings as text_embeddings
import clipself_tpu_torch.data.draw
import clipself_tpu_torch.detector.classes as det_classes
import clipself_tpu_torch.tools.synth_det_data as synth_det_data
import clipself_tpu_torch.models.open_clip_vit
import clipself_tpu_torch.models.modified_resnet
import clipself_tpu_torch.models.openai
import clipself_tpu_torch.models.pretrained
import clipself_tpu_torch.models.coca as coca
import clipself_tpu_torch.train.contrastive as contrastive
import clipself_tpu_torch.models.hf_configs
import clipself_tpu_torch.models.hf_bert
import clipself_tpu_torch.models.hf_t5
import clipself_tpu_torch.models.hf_vit
import clipself_tpu_torch.models.hf_text
import clipself_tpu_torch.models.trunk_adapter

model = factory.create_model("EVA02-CLIP-Tiny-Test", device="cpu", dtype=torch.float32, seed=0)
batch = synthetic.synthetic_panoptic_batch(
    0, batch=2, image_size=32, max_anns=8, valid_anns=5, crop_size=32, mask_hw=4, n_classes=7
)
res = zero_shot.evaluate_zero_shot(
    model, [batch], synthetic.class_embeddings(7, 64), device="cpu", ann_bucket=0
)
run = train_main.main([
    "--device", "cpu", "--synthetic", "--model", "EVA02-CLIP-Tiny-Test", "--batch-size", "1",
    "--det-image-size", "32", "--max-boxes", "2", "--steps-per-epoch", "1", "--epochs", "1",
    "--grad-checkpointing",
    "--logs", sys.argv[1], "--name", "no_jax",
])
loss = run["history"][-1]["loss"]

det_cfg = det_config.PRESETS["tiny_test"]
clip = factory.create_model(det_cfg.clip_model, device="cpu", dtype=torch.float32, seed=0)
det = fvit.create_detector(det_cfg, device="cpu", seed=1)
items = det_data.synthetic_eval_items(
    det_data.SyntheticDetectionData(det_cfg.num_classes, det_cfg.image_size, det_cfg.max_gt).batch(3)
)
emb = synthetic.class_embeddings(det_cfg.num_classes + 1, det_cfg.embed_dim)
emb /= (emb ** 2).sum(-1, keepdims=True) ** 0.5
metrics = det_evaluate.evaluate_detector(det, clip, items, det_cfg, emb, device="cpu", batch_size=2)
import dataclasses
mask_cfg = dataclasses.replace(
    det_cfg, with_mask=True, num_classes=20, mask_convs=1, mask_channels=16, mask_roi_size=6
)
names = [f"c{i}" for i in range(20)]
split = {"all": names, "seen": names[:14], "unseen": names[14:],
         "freq_groups": {"rare": names[14:], "common": names[7:14], "frequent": names[:7]}}
mitems = det_data.synthetic_eval_items(
    det_data.SyntheticDetectionData(20, 64, 5, with_mask=True).batch(3), num_classes=20, seed=1
)
memb = synthetic.class_embeddings(21, det_cfg.embed_dim)
memb /= (memb ** 2).sum(-1, keepdims=True) ** 0.5
lvis = det_evaluate.evaluate_detector(
    fvit.create_detector(mask_cfg, device="cpu", seed=2), clip, mitems, mask_cfg, memb, device="cpu",
    batch_size=2, dataset_name="lvis", split=split,
)
det_run = det_train.main([
    "--synthetic", "--preset", "tiny_test", "--device", "cpu", "--batch-size", "2", "--epochs", "1",
    "--steps-per-epoch", "1", "--output", sys.argv[1] + "/det",
])
det_loss = det_run["history"][-1]["metrics"]["loss"]
tiny = factory.get_model_config("EVA02-CLIP-Tiny-Test")
full = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, vocab_size=49408))
tmodel = factory.create_model(full, device="cpu", dtype=torch.float32, seed=0)
tokens = torch.as_tensor(factory.get_tokenizer(full)(["a photo of a cat", "a photo of a dog"]))
txt = tmodel.encode_text(tokens, normalize=True)
rows = text_embeddings.build_text_embeddings(tmodel, ["cat", "dog"])
text_embeddings.get_model_config = lambda name: full
with open(sys.argv[1] + "/classes.json", "w") as f:
    json.dump(["cat", "dog", "zebra"], f)
cli = text_embeddings.main([
    "--model", "EVA02-CLIP-Tiny-Test", "--classes-json", sys.argv[1] + "/classes.json",
    "--add-background", "--out", sys.argv[1] + "/emb.npy", "--device", "cpu",
])
corpus = sys.argv[2]
common = ["--device", "cpu", "--model", "EVA02-CLIP-Tiny-Test", "--det-image-size", "32",
          "--max-boxes", "2", "--batch-size", "2", "--workers", "0", "--logs", sys.argv[1]]
val = ["--val-data", corpus + "/panoptic.json", "--val-image-root", corpus + "/images",
       "--val-segm-root", corpus + "/segm", "--embed-path", corpus + "/emb.npy"]
files = train_main.main(common + val + [
    "--train-data", corpus + "/instances.json", "--train-image-root", corpus + "/images",
    "--epochs", "1", "--steps-per-epoch", "1", "--name", "files",
])
eval_only = train_main.main(common + val + ["--name", "eval_only"])
import numpy as np
np.save(sys.argv[1] + "/nouns.npy", np.random.default_rng(0).standard_normal((128, 64)).astype(np.float32))
region_args = common + [
    "--dataset-type", "region_clip", "--train-data", corpus + "/instances.json",
    "--train-image-root", corpus + "/images", "--train-embed-path", sys.argv[1] + "/nouns.npy",
    "--epochs", "1", "--steps-per-epoch", "2", "--accum-freq", "2",
]
region = train_main.main(region_args + ["--name", "region", "--export-torch"])
region_pre = train_main.main(region_args + [
    "--name", "region_pre", "--pretrained", sys.argv[1] + "/region/epoch_1.pt",
])
det_ann, det_imgs = synth_det_data.write_synth_det(
    sys.argv[1] + "/detset", det_classes.coco_split()["all"], synth_det_data.gt_classes("coco", 3),
    n_images=2, size=64,
)
np.save(sys.argv[1] + "/det_ce.npy", np.random.default_rng(0).standard_normal((66, 32)).astype(np.float32))
det_common = ["--preset", "tiny_test", "--device", "cpu", "--ann-file", det_ann, "--image-root", det_imgs,
              "--class-embed", sys.argv[1] + "/det_ce.npy", "--batch-size", "2"]
det_files = det_train.main(det_common + ["--epochs", "1", "--output", sys.argv[1] + "/det_files"])
fvit = det_evaluate.main(det_common + ["--detector-checkpoint", sys.argv[1] + "/det_files/detector_epoch0.pkl"])
vit = factory.create_model("ViT-Tiny-Test", device="cpu", dtype=torch.float32, seed=0)
vit_res = zero_shot.evaluate_zero_shot(
    vit, [batch], synthetic.class_embeddings(7, 64), device="cpu", ann_bucket=0, extract_type="v1"
)
vit_run = train_main.main([
    "--device", "cpu", "--synthetic", "--model", "ViT-Tiny-Test", "--extract-type", "v1",
    "--force-quick-gelu", "--batch-size", "1", "--det-image-size", "32", "--max-boxes", "2",
    "--steps-per-epoch", "1", "--epochs", "1", "--logs", sys.argv[1], "--name", "vit",
])
rn = factory.create_model("RN-Tiny-Test", device="cpu", dtype=torch.float32, seed=0)
rn_batch = synthetic.synthetic_panoptic_batch(
    0, batch=2, image_size=64, max_anns=8, valid_anns=5, crop_size=64, mask_hw=2, n_classes=7
)
rn_res = zero_shot.evaluate_zero_shot(
    rn, [rn_batch], synthetic.class_embeddings(7, 64), device="cpu", ann_bucket=0, extract_type="v1"
)
rn_run = train_main.main([
    "--device", "cpu", "--synthetic", "--model", "RN-Tiny-Test", "--lock-image-freeze-bn-stats",
    "--lock-image-unlocked-groups", "5", "--batch-size", "1", "--det-image-size", "64",
    "--max-boxes", "2", "--steps-per-epoch", "1", "--epochs", "1", "--logs", sys.argv[1], "--name", "rn",
])
bige = dataclasses.replace(tiny, vision=dataclasses.replace(
    tiny.vision, subln=False, naiveswiglu=False, rope=False, postnorm=True, use_shared_rel_pos_bias=True))
eva = factory.create_model(bige, device="cpu", dtype=torch.float32, seed=0)
eva_dense = eva.encode_dense(torch.zeros(1, 32, 32, 3), keep_shape=True)
import clipself_tpu_torch.models.convnext as convnext
convnext.CONVNEXT_ARCHS["convnext_nojax_tiny"] = ((1, 1, 2, 1), (8, 16, 24, 32))
cn = dataclasses.replace(tiny, name="convnext-nojax", vision=dataclasses.replace(
    factory.get_model_config("convnext_base").vision, timm_model_name="convnext_nojax_tiny", image_size=32))
cn_model = factory.create_model(cn, device="cpu", dtype=torch.float32, seed=0)
cn_batch = synthetic.synthetic_panoptic_batch(
    0, batch=2, image_size=64, max_anns=8, valid_anns=5, crop_size=32, mask_hw=2, n_classes=7
)
cn_res = zero_shot.evaluate_zero_shot(
    cn_model, [cn_batch], synthetic.class_embeddings(7, cn.embed_dim), device="cpu", ann_bucket=0
)
train_main.get_model_config = lambda name: cn
cn_run = train_main.main([
    "--device", "cpu", "--synthetic", "--model", "convnext-nojax", "--no-lock-image", "--batch-size", "1",
    "--det-image-size", "64", "--max-boxes", "2", "--steps-per-epoch", "1", "--epochs", "1",
    "--logs", sys.argv[1], "--name", "convnext",
])
coca_cfg = dataclasses.replace(
    factory.get_model_config("ViT-Tiny-Test"),
    vision=dataclasses.replace(factory.get_model_config("ViT-Tiny-Test").vision, attentional_pool=True,
                               n_queries=5, attn_pooler_heads=2),
    text=dataclasses.replace(tiny.text, embed_cls=True, context_length=16),
    multimodal=clipself_tpu_torch.core.config.MultimodalConfig(
        context_length=16, vocab_size=512, width=64, heads=2, layers=2),
)
coca_model = factory.create_model(coca_cfg, device="cpu", dtype=torch.float32, seed=0)
coca_img, coca_txt = torch.zeros(2, 32, 32, 3), torch.randint(1, 512, (2, 16))
coca_out = coca.coca_loss(coca_model(coca_img, coca_txt), coca_txt)[0]
caption = coca.generate(coca_model, coca_img, 1, 2, max_len=6, top_k=3)
create_loss = contrastive.create_loss("clipself").__name__
hf_vit = factory.create_model("hf-vit-tiny-test", device="cpu", dtype=torch.float32, seed=0)
hf_img = hf_vit.encode_image(torch.zeros(2, 32, 32, 3), normalize=True)
roberta = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, hf_model_name="roberta", hf_model_config=dict(
    hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64, vocab_size=100,
    max_position_embeddings=20)))
hf_txt = factory.create_model(roberta, device="cpu", dtype=torch.float32, seed=0).encode_text(
    torch.randint(3, 100, (2, 8)), normalize=True)
train_main.get_model_config = factory.get_model_config
hf_run = train_main.main([
    "--device", "cpu", "--synthetic", "--model", "hf-vit-tiny-test", "--no-lock-image", "--batch-size", "1",
    "--det-image-size", "32", "--max-boxes", "2", "--steps-per-epoch", "1", "--epochs", "1",
    "--logs", sys.argv[1], "--name", "hf_vit",
])
data = {"coca": [type(coca_model).__name__, math.isfinite(float(coca_out)), list(caption.shape), create_loss],
        "hf": [list(hf_img.shape), list(hf_txt.shape), bool(torch.isfinite(hf_txt).all()),
               hf_run["history"][-1]["loss"]],
        "loss": files["history"][-1]["loss"], "evals": len(files["evals"]),
        "vit": [len(vit_res), vit_run["history"][-1]["loss"]],
        "rn": [len(rn_res), rn_run["history"][-1]["loss"]],
        "convnext": [len(cn_res), cn_run["history"][-1]["loss"]],
        "eva_variants": [list(eva_dense.shape), bool(torch.isfinite(eva_dense).all())],
        "eval_only": sorted(eval_only["evals"][0]),
        "region": [h["loss_contrast"] for h in region["history"] + region_pre["history"]],
        "det_files": [h["metrics"]["loss"] for h in det_files["history"]],
        "fvit": json.loads(det_evaluate.metrics_json(fvit))}
text = {"encode_text": list(txt.shape), "finite": bool(torch.isfinite(txt).all()),
        "rows": list(rows.shape), "cli": list(cli.shape), "ids": tokenizer.tokenize("a cat")[0, :4].tolist()}
banned = ("jax", "jaxlib", "flax", "PIL", "optax", "orbax", "torchvision", "regex", "ftfy",
          "clipself_tpu", "transformers", "tokenizers", "sentencepiece", "safetensors")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(json.dumps({"n_results": len(res), "loss": loss, "det_loss": det_loss, "loaded": loaded, "text": text,
                  "data": data,
                  "metrics": json.loads(det_evaluate.metrics_json(metrics)),
                  "lvis": json.loads(det_evaluate.metrics_json(lvis))}))
"""


def write_png_corpus(root):
    """The micro COCO corpus with its images re-saved as PNG files."""
    from PIL import Image

    img_dir, _ = write_micro_coco(root, n_images=4, embed_dim=64)
    for name in ("instances.json", "panoptic.json"):
        data = json.loads((root / name).read_text())
        for info in data["images"]:
            src = img_dir / info["file_name"]
            info["file_name"] = src.stem + ".png"
            Image.open(src).save(img_dir / info["file_name"])
        (root / name).write_text(json.dumps(data))
    for jpg in img_dir.glob("*.jpg"):
        jpg.unlink()


def test_port_runs_without_jax(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    (tmp_path / "corpus").mkdir()
    write_png_corpus(tmp_path / "corpus")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path), str(tmp_path / "corpus")], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n_results"] == 12
    assert math.isfinite(out["data"]["loss"]) and out["data"]["evals"] == 2
    assert out["data"]["vit"][0] == 12 and math.isfinite(out["data"]["vit"][1])
    assert out["data"]["rn"][0] == 12 and math.isfinite(out["data"]["rn"][1])
    assert out["data"]["convnext"][0] == 12 and math.isfinite(out["data"]["convnext"][1])
    assert out["data"]["eva_variants"] == [[1, 4, 4, 64], True]
    assert out["data"]["coca"] == ["CoCa", True, [2, 6], "clip_loss"]
    assert out["data"]["hf"][:3] == [[2, 16], [2, 64], True] and math.isfinite(out["data"]["hf"][3])
    assert len(out["data"]["eval_only"]) == 13 and "epoch" in out["data"]["eval_only"]
    assert len(out["data"]["region"]) == 2 and all(map(math.isfinite, out["data"]["region"]))
    assert (tmp_path / "region" / "epoch_1.pt").is_file()
    assert len(out["data"]["det_files"]) == 1 and all(map(math.isfinite, out["data"]["det_files"]))
    assert sorted(out["data"]["fvit"]) == ["AP50", "AP50_base", "AP50_novel", "AP75", "mAP"]
    assert math.isfinite(out["loss"]) and math.isfinite(out["det_loss"])
    assert (tmp_path / "det" / "detector_epoch0.pkl").is_file()
    assert out["loaded"] == []
    assert out["text"] == {"encode_text": [2, 64], "finite": True, "rows": [2, 64], "cli": [4, 64],
                           "ids": [49406, 320, 2368, 49407]}
    assert sorted(out["metrics"]) == ["AP50", "AP50_base", "AP50_novel", "AP75", "mAP"]
    assert all(v is None or 0.0 <= v <= 1.0 for v in out["metrics"].values())
    assert {"AP", "APr", "APc", "APf", "segm_AP", "segm_APr", "segm_AR@300"} <= set(out["lvis"])
    # an LVIS group without ground truth is the -1 sentinel
    assert all(v is None or -1.0 <= v <= 1.0 for v in out["lvis"].values())
