#!/usr/bin/env python3
"""Drive the PyTorch / H100 port once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. card and build: the card's name and power limit (nvidia-smi), then the
   CUDA kernels built from `clipself_tpu_torch/csrc/` with the build time;
2. each kernel against its plain PyTorch version at the shapes the two
   models give it (EVA02-CLIP-B/16 at 1024^2: 4097 and 197 tokens, 12 heads,
   widths 768 and 2048; EVA02-CLIP-L-14-336 at 896^2: 4097 and 577 tokens,
   16 heads, widths 1024 and 2730), in float32 and bfloat16: the RoPE
   forward and backward on one tensor and on two in one launch (q and k, as
   the towers call it; also at the detector's [8, 1601, 768]), the
   flash-attention forward with and without its
   LSE (also at the detector's [8, 1601, 12, 64], and at [1, 4097, 16, d]
   for the large towers' head dims d = 80, 88, 104, 112, which every design
   takes on tiles of d rounded up to 16 columns, zero-filled past d), the
   flash backward (each row says which of the kernel's designs its shape and
   type took: "wgmma" for bfloat16 at head_dim 64-128, on two 64-column
   panels past 64, "wmma" for bfloat16 below 64, "tf32x3" for float32, the
   three-product TF32 split on the tensor cores; each is
   called twice on the same inputs and must give the
   same bits: every sum of the kernel runs in a fixed order), and the fused LayerNorm
   forward (with and
   without statistics; also at the text towers' [64, 77, 512] and
   [64, 77, 768]) and backward, also on the two strided views of the
   final norm (each backward row names its plan: warps a row, rows a
   block). Each with CUDA-event times of the kernel, of its plain
   version and, where one PyTorch call computes the same function
   (`scaled_dot_product_attention` and autograd of it, `F.layer_norm` and
   `aten.native_layer_norm_backward`), of that call (the RoPE and LayerNorm
   launches replayed from a CUDA graph, so that the host's launch pace does
   not hide their ten-microsecond times), and with
   the least time the card could take (bytes moved once over 3.35 TB/s, or
   operations over the peak rate of their type) and the time as a multiple
   of it; then the greedy-NMS kernels
   (bit matrix, then block-wise scan) against the plain version and against
   the plain mirror of their two phases, masks equal flag for flag, at the detector's
   shapes ([8, 2000] RPN candidates at IoU 0.7, class-offset candidates at
   0.4, one image, an invalid tail) and at the edge cases (one box, no valid
   box, identical boxes, zero-area boxes, duplicates, a negative threshold);
then for each model, B/16 first:
3. the evaluator: `evaluate_zero_shot` (seeded random weights, bf16) over 4
   synthetic panoptic batches after 2 warm-up batches, with ms a batch,
   images/s, the mAcc dict and the kernel launch counts of that run; at B/16
   again with `image_ave_pool` (each crop scored by its mean dense feature);
4. whole-path parity of the dense map against the plain float32 path;
5. the text tower (width 512, 8 heads at B/16; 768, 12 heads at L/14; 12
   blocks, 77 tokens): `tools/text_embeddings.py::build_text_embeddings` in
   bf16 over the 65 OV-COCO classes and a background row (63 ViLD prompts a
   class), with the seconds, the host's
   tokenizing apart, prompts/s, peak memory, each class matrix's mean
   off-diagonal cosine and the LayerNorm launches (two a block and the final
   one a call); then bf16 and f32 kernels against the plain float32 path on
   one batch of 64 prompts and on the OV-COCO matrix;
6. the trainer: `clipself_tpu_torch.train.main`, bf16, synthetic data, batch
   2, 20 boxes, teacher crops at the model's own size, every block unlocked:
   3 warm-up steps and 5 timed steps (L/14: 2 and 3), with every step's ms,
   the median step's images/s, the per-step losses, peak device memory and
   the launch counts of the run; for L/14 then 1 warm-up and 2 timed steps
   with `--grad-checkpointing`;
7. train parity: one step's loss and trainable gradients at batch 1 on f32
   kernels, bf16 kernels and the f32 plain path (L/14: at full width and a
   depth of 6 blocks, since the plain path keeps every block's
   [1, 16, 4097, 4097] float32 attention maps for its backward);
7a. after B/16's train parity, the trainer laid out for a mesh
   (`phase_parallel`): the card is one GPU, so the mesh is (1, 1, 1) over a
   world-size-1 NCCL group in this process (launcher variables set for the
   call alone), with FSDP2 over (data, fsdp) and the tensor-parallel plan
   over `model` applied as at larger worlds (their collectives run on one
   rank: the LayerNorm's gather and the row-parallel sums are no-ops); the
   B/16 distill step through `train.main` (1024^2, batch 2, 20 crops at 224^2,
   every block unlocked, the seeded weights of phase 6) for 2 warm-up and 3
   timed steps and 1 under the profiler, beside the same run without a
   launcher: the losses, the first step's gradient of block 11's `mlp.w3`
   and that weight after the run EQUAL (every kernel of the step sums in a
   fixed order, the flash backward's dQ included), launch counts equal
   (`b16_train_sharded` in the kernels line), images/s and kernel ms of
   each; then the detector trainer, `detector.train.main --synthetic` at
   `ov_coco_vitb16` (batch 8, 2 warm-up and 3 timed steps), under the same
   one-process launch (a (1, 1, 1) `data` mesh, the heads under
   DistributedDataParallel) beside the same run without one: the logged
   losses and the heads after the run EQUAL, launch counts equal
   (`b16_detector_train_sharded`);
7b. after B/16's phases, the input pipeline on files (`data/`, no PIL): a
   corpus written under `build/chip_smoke_data/` (deleted at the end) by
   `data/image_io.py::encode_png`, its rows cycling the five PNG filters: 16 train images
   at COCO's sizes with 30 proposals each, 4 panoptic val images with 6
   thing and 4 stuff segments over 133 categories, a [133, 512] class
   embedding; whether the C compiler finds `jpeglib.h` and `png.h` (the
   native core's `--native-loader` route runs only then); one core's ms for
   a PNG decode, a det transform, a grid item and a panoptic item; the
   loaders alone in items/s (`--workers` = the host's cores, at most 8);
   the pinned copy of a train batch; then `train.main` at the B/16 recipe
   (1024², batch 2, 20 boxes) with `--val-data` before and after the
   epoch: `proposals_distill` 1 + 2 steps under the profiler (the device's
   kernel ms a step and idle share), `grid_distill` 3 + 5 steps through
   the NumPy route and the native one, each beside the synthetic step of
   phase 6 with its idle share derived from that kernel time, and an
   evaluation-only run; every loss finite, every metric finite or null, and
   every launch count equal to the synthetic step's and evaluator's;
7c. RegionCLIP (`train.main --dataset-type region_clip`, bf16, 20 boxes an
   image over 4764 categories, a seeded [4764, embed] noun matrix, the
   recipe's alpha; no teacher): B/16 at the recipe's batch 16 from a PNG
   corpus, timed past the loader's backlog and profiled; a flags run at
   batch 2 (`--accum-freq 2`, `--save-most-recent`, `--keep-checkpoints 1`,
   `--export-torch`) and `--pretrained` on its export, the initial weights
   equal to it; the step on one staged corpus batch, timed and profiled;
   L/14 at batch 2 from files and one step with `--grad-checkpointing`;
   each with one step's parity at batch 1 (f32 and bf16 kernels against
   the f32 plain path, the federated class mask equal in the three legs);
   every launch count that of the student's dense pass and its backward;
7d. the plain OpenCLIP / OpenAI ViT tower (`phase_open_clip_vit`): ViT-B-16
   at 1024^2 (crops 224^2) through `evaluate_zero_shot` at extract type v2
   (2 + 4 batches) and v1, mask-attention pooling (2 + 4), and one v3 call;
   ViT-L-14-336 at 896^2 (crops 336^2) at v2 (2 + 4); each with ms a batch,
   images/s, peak memory, the kernels' ms a batch under the profiler and the
   launch counts; parity of the dense map and of the v1 pooled features
   (bf16 and f32 kernels against the plain float32 path; the v1 path's
   masked attention is plain PyTorch in every leg); the trainer at
   ViT-B-16 with `--force-quick-gelu` (batch 2, 20 boxes, 12 blocks
   unlocked, 3 + 5 steps, 2 profiled), one `--extract-type v1` run (1 + 1
   steps, its peak memory) and one step's parity at batch 1;
7d'. ViT-B-16's distill step at tensor parallelism 2 (`phase_vit_tp`): the
   card is one GPU, so two spawned ranks share it over gloo with CUDA tensors
   on a (1, 1, 2) mesh, each holding 6 of the 12 heads and half of each MLP
   (1024^2, batch 2, 20 crops at 224^2, every block unlocked, v2), against
   the same step in one process: one float32 step (the first loss within
   1e-5, the first gradient of block 11's `mlp.c_proj.weight`, gathered
   whole, within 1e-4 of its largest entry), then 1 + 2 bf16 steps (losses
   within 2e-3; that gradient's cosine at least 0.99995 against the
   one-process bf16 gradient and 0.9999 against the float32 one; its worst
   row, and its worst of at least 1% of the median row norm, printed beside
   the one-process bf16 gradient's own against float32; the timed steps' ms and
   kernel ms under the profiler); every rank's launches equal to the
   one-process run's (`vitb16_train_tp2` in the kernels line); the kernel
   rows of phase 2 include a rank's [2, 4097, 6, 64] and [40, 197, 6, 64];
   then, in the same two ranks, a `pp` group and an `sp` group of the two
   (`pipeline_ring_rank`): the GPipe pipeline over EVA02-CLIP-B/16's 12
   blocks at 1024^2 on the script's seeded weights (batch 2 in 2
   microbatches of one image, 2 stages of 6 blocks) and ring attention at
   [2, 4096, 12, 64] over a ring of 2 (B/16's 4096 patch tokens at
   1024^2), each in float32 then bf16, forward and the gradient of a
   sum-of-squares loss, against the blocks in turn and the plain full
   attention in float32 in the script's process: float32 outputs within
   1e-5 and gradients within 1e-4 of each tensor's largest entry, bf16
   outputs' min row cosine at least 0.9996; each rank's launches equal to
   `pipeline_expected_launches` (the ring launches none), and each run's ms
   and kernel ms under the profiler (`b16_pipeline_pp2`, `ring_sp2` in the
   kernels line);
7e. the ModifiedResNet and the EVA01 variant (`phase_towers`): RN50 and
   EVA01-CLIP-B-16 at 1024^2 (crops 224^2) through `evaluate_zero_shot` at
   v2 (2 + 4 batches of 2, 2 profiled; RN50 also one v1 call), the dense map
   and the image embedding (RN50 also the v1 RoI features) against the
   plain float32 path, the trainer (batch 2, 20 boxes, every lock group
   unlocked: RN50's five, EVA01's 12 blocks; 2 + 3 steps, 2 profiled; RN50
   once more with `--lock-image-freeze-bn-stats`, 1 step, its BatchNorm
   statistics unchanged) and one step's parity at batch 1; RN50 launches no
   kernel of the port, EVA01 the flash forward and backward and the
   LayerNorm forward and backward, no RoPE (`tower_expected_launches`);
   then the timm towers the same way: convnext_base at 1024^2 and Swin-B
   (`swin_base_patch4_window7_224`) at 896^2 (its stage grids must divide by
   the window 7), each also through one v1 evaluator call, the v1 RoI
   features in the parity legs, every LayerNorm input of a dense pass
   contiguous (channels-last maps, no copy before a norm) and the trainer
   with `--no-lock-image`; ConvNeXt's layer scales (1e-6 at init) are drawn
   uniform in [0.1, 1) before its parity legs; they launch the LayerNorm
   kernels alone (Swin's window attention is plain, as the JAX package's
   einsum is); the kernel rows of phase 2 include their LayerNorm shapes
   (ConvNeXt-Base widths 128 and 1024, Swin-B's patch merging at 4C = 512);
7f. CoCa (`phase_coca`): coca_ViT-L-14 (ViT-L/14 at 224^2 with the
   attentional pooler, text tower and decoder of 12 blocks at width 768,
   vocabulary 49408) on seeded random weights drawn once on the card: forward
   and `coca_loss` over 8 images and 8 tokenized captions in bf16 (ms,
   images/s, kernel ms under the profiler), parity of the image latents, text
   latents and decoder logits (bf16 and f32 kernels against the plain float32
   path), one bf16 backward (vision gradients finite), greedy captions of 20
   tokens (ms a generated position; f32 kernels against the f32 plain path,
   tokens EQUAL or a near tie), every run's launches equal to
   `coca_expected_launches`; the kernel rows of phase 2 include the flash
   kernels at its [8, 257, 16, 64] and coca_ViT-B-32's [8, 50, 12, 64];
7g. the HF towers without transformers (`phase_hf`): (a) the transformers
   ViT trunk adapter at ViTConfig's defaults (ViT-B/16's widths, 224^2,
   embed 512): one evaluator batch of 2 after 1 (ms, images/s, kernel ms
   under the profiler, idle share), its dense map and image embedding
   against the plain float32 path, the trainer with --no-lock-image (2 + 3
   steps, 2 profiled); (b) roberta-ViT-B-32 with its text tower keyed by the
   model type 'roberta' (RoBERTa-base's widths): 64 images and 64 id rows of
   77 through CLIP.forward and clip_loss (1 + 3 calls, 1 profiled), the text
   tower alone, both embeddings against the plain float32 path, one bf16
   backward into both towers; the trunks run float32 in every model, as the
   JAX towers' do, so their attention takes the flash kernels' float32 design
   and their LayerNorms the float32 kernels (rows in phase 2 at
   [2, 197, 12, 64] and eps 1e-12); every run's launches equal
   `hf_expected_launches`;
then the F-ViT detector, preset `ov_coco_vitb16` (EVA02-CLIP-B/16 backbone at
640^2, 102300 anchors, 1000 proposals, 65 classes), full width and depth:
8. `evaluate_detector` (seeded random CLIP and detector weights, bf16, random
   unit-norm class embeddings) over four batches of 8 synthetic images after
   two warm-up batches, with ms a batch, images/s, peak memory, the metrics and the launch
   counts of that run;
9. detector parity on two images: the bf16 kernel path against the plain
   float32 path on the backbone taps, the dense VLM map, the RPN objectness
   maps and the bbox head's logits and deltas on 32 fixed rois; the float32
   kernel path against the float32 plain path on the same tensors and on the
   detections; and, on the same float32 taps, `predict` with the NMS kernel
   against `predict` with the plain NMS: proposals and detections equal bit
   for bit;
10. detector training through `python -m clipself_tpu_torch.detector.train`'s
   `main`, `ov_coco_vitb16`, batch 8, bf16, the recipe's AdamW: 2 warm-up
   and 5 timed steps with every step's ms, the median step's images/s, peak
   memory, the last step's loss metrics and the launch counts (the frozen
   trunk: no backward kernel);
11. detector training parity, one step at batch 2 from the same weights,
   batch and sampler noise: f32 kernels and bf16 kernels against the plain
   f32 path (loss, proposals, trainable gradients; the RoI stage of every
   leg on the plain leg's proposals);
12. the mask branch: `ov_lvis_vitb16` (1203 classes, 14x14 mask rois),
   batch 8, 1 warm-up and 2 steps, every loss and gradient finite;
12b. the detector on files through the port's own CLIs, no PIL
   (`phase_detector_files`): `tools/synth_det_data.py` writes the JAX
   drive's sets (8 PNGs at 640^2, 3 shapes an image, 6 trained classes;
   OV-COCO rectangles, OV-LVIS ellipse polygons), `python -m
   clipself_tpu_torch.detector.train` trains `ov_coco_vitb16` and
   `ov_lvis_vitb16` (mask head) on them for 120 and 100 epochs of one batch
   of 8, as the JAX drive did (bf16, the recipe's defaults, seeded random trunk; every epoch's
   checkpoint written and timed) and `fvit-test` scores the last
   checkpoint: the first and last loss, AP50 and mAP (LVIS: box and `segm_`
   AP and AP50; fails under 0.90 AP50, box and segm; OV-COCO is also driven
   at `--seed` 1 and 2 in two `tools/detector_seed_sweep.py` processes side
   by side while the OV-LVIS drive runs, and the median of the three seeds' AP50 must reach 0.90 too), one core's ms a train
   and an eval item, the steps fed from files (reads, step) beside the
   synthetic step of phase 10 / 12, the device's idle share over 6 epochs
   under the profiler and the launches a step and an eval batch (equal to the synthetic
   path's); then the CLIPSelf -> F-ViT hand-off: the B/16 RegionCLIP run's
   `--export-torch` file and a vision-only copy of it, each as
   `--clip-checkpoint`, give trunks whose taps are EQUAL to those of the
   exporting model's visual tower;
then the L/14 presets (EVA02-CLIP-L-14-336 at 896^2, 261888 anchors):
13. `evaluate_detector` at `ov_coco_vitl14` as in 8 and its parity as in 9
   (the kernel rows of phase 2 include its shapes: flash attention
   [8, 4097, 16, 64], LayerNorm [8, 4097, 1024] and [8, 4097, 2730], RoPE
   [8, 4097, 1024], and the final NMS over 1203 classes in the 896^2 frame);
14. LVIS evaluation with masks, `ov_lvis_vitb16` and `ov_lvis_vitl14`, batch
   8, 2 batches after 1 warm-up, on items with gt masks, resize scales other
   than 1 and the LVIS fields: the LVIS protocol's box and `segm_` metrics as
   strict JSON (a missing key or a value neither finite nor null fails), ms
   a batch and the host's share by stage (predict, copy back, pasting,
   matching);
15. detector training at `ov_coco_vitl14`, 2 + 5 steps, and `ov_lvis_vitl14`
   with the mask head, 1 + 2, as in 10 and 12.

The second-to-last line is one JSON object with a row per kernel; the last
line is `{"ok": true, "device": {...}}`. Without a CUDA card it exits 1
before printing either. Whether it passes or fails, it stops every process it
started before it exits (`stop_children`): the data phase's fork server and
resource tracker would otherwise outlive it for a while.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

MAX_ANNS, VALID_ANNS, BUCKET = 100, 13, 25
# evaluator: 2 warm-up batches, then 4 timed ones
EVAL_WARMUP, N_BATCHES, N_CLASSES, SEED = 2, 4, 133, 0
# trainer: 3 warm-up steps, then 5 timed steps (the median step is reported);
# L/14 2 and 3 (the script's time limit); when recomputing, 1 warm-up step
# and 2 timed ones
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED, TRAIN_BOXES = 2, 3, 5, 20
L14_TRAIN_WARMUP, L14_TRAIN_TIMED = 2, 3
RECOMPUTE_WARMUP, RECOMPUTE_STEPS = 1, 2
# the trainer laid out for a mesh at world size 1 against the same run
# without one: warm-up, timed and profiled steps; the block weight compared.
# Every step is the same operations on the same values, and every kernel of
# the step sums in a fixed order (the flash backward's dQ included), so the
# losses, the first step's gradient and the weight after the run are EQUAL
PARALLEL_WARMUP, PARALLEL_TIMED, PARALLEL_PROFILED = 2, 3, 1
PARALLEL_WEIGHT = "visual.blocks.11.mlp.w3.weight"
PARALLEL_MAX_REL, PARALLEL_LATER_LOSS_MAX_REL, PARALLEL_WEIGHT_MAX_ABS = 0.0, 0.0, 0.0
# the OpenCLIP ViT-B-16 distill step on a (1, 1, 2) mesh, two ranks on the one
# card over gloo, against the same step in one process: float32 steps, then
# bf16 warm-up and timed steps (the timed ones under the profiler); the weight
# whose first gradient is compared, gathered whole; the bars. The bf16
# gradient is held by its cosine as a whole: against the one-process bf16
# gradient (read 0.9999937, 1 - cos 6.3e-6 against the 5e-5 allowed) and
# against the float32 one (read 0.9999743; the one-process bf16 gradient's own
# 0.9999751). No row bar: bf16 rounding alone moves rows far, the one-process
# bf16 gradient's worst row reads 0.73 against float32 and its worst row of
# at least TP_ROW_FLOOR of the median row norm 0.88 (the tp-2 gradient's
# 0.986 against one process); both worst rows are printed
TP_MESH, TP_F32_STEPS, TP_WARMUP, TP_TIMED = (1, 1, 2), 1, 1, 2
TP_WEIGHT = "visual.transformer.resblocks.11.mlp.c_proj.weight"
TP_F32_LOSS_MAX_REL, TP_F32_GRAD_MAX_REL = 1e-5, 1e-4
TP_BF16_LOSS_MAX_REL, TP_BF16_GRAD_MIN_COS, TP_BF16_GRAD_F32_MIN_COS = 2e-3, 0.99995, 0.9999
TP_ROW_FLOOR = 0.01
# the GPipe pipeline and ring attention in the same two ranks, over a `pp` and
# an `sp` group of the two: EVA02-CLIP-B/16's 12 blocks at 1024^2, batch 2 in
# 2 microbatches of one image over 2 stages; the ring at B/16's 4096 patch
# tokens at 1024^2 (4097 does not divide by 2) and 12 heads of 64. The bars,
# of each tensor's largest entry: float32 outputs (the repository's mesh bar)
# and gradients (its gradient bar); bf16 outputs by their min row cosine
# against float32, as the dense maps
PP_BATCH, PP_MICROBATCHES, PP_STAGES = 2, 2, 2
RING_SHAPE = (2, 4096, 12, 64)
PP_OUT_MAX_REL, PP_GRAD_MAX_REL, PP_BF16_MIN_COS = 1e-5, 1e-4, 0.9996
RING_MAX_REL, RING_BF16_MIN_COS = 1e-5, 0.9996
# the detector trainer at DET_PRESET on a (1, 1, 1) data mesh (the heads under
# DistributedDataParallel) against the same run without a launcher: warm-up
# and timed steps; the logged losses and the heads after the run EQUAL
PARALLEL_DET_WARMUP, PARALLEL_DET_TIMED = 2, 3


@dataclasses.dataclass(frozen=True)
class Model:
    """One model at the image size and evaluator batch of its recipe."""

    key: str
    model: str
    image: int
    eval_batch: int
    parity_layers: int | None = None  # depth of the train-parity phase; None: all

    @property
    def vision(self):
        from clipself_tpu_torch.core.config import get_model_config

        return get_model_config(self.model).vision

    @property
    def text(self):
        from clipself_tpu_torch.core.config import get_model_config

        return get_model_config(self.model).text

    @property
    def heads(self) -> int:
        return self.vision.width // self.vision.head_width

    @property
    def hidden(self) -> int:
        return int(self.vision.width * self.vision.mlp_ratio)

    @property
    def crop(self) -> int:
        return self.vision.image_size

    def grid(self, size: int) -> int:
        from clipself_tpu_torch.models.clip import dense_stride

        return size // dense_stride(self.vision)

    @property
    def timm(self) -> bool:
        return bool(self.vision.timm_model_name)

    def tokens(self, size: int) -> int:
        return 1 + self.grid(size) ** 2


MODELS = (
    Model("b16", "EVA02-CLIP-B-16", image=1024, eval_batch=2),
    Model("l14", "EVA02-CLIP-L-14-336", image=896, eval_batch=1, parity_layers=6),
)
# the plain OpenCLIP / OpenAI ViT tower at the B/16 recipe's shapes (and L/14
# at 896^2 through the evaluator): v1 evaluator batches, L/14 v2 batches, and
# batches or steps under the profiler for the kernel ms
VIT_MODELS = (
    Model("vit_b16", "ViT-B-16", image=1024, eval_batch=2),
    Model("vit_l14", "ViT-L-14-336", image=896, eval_batch=1),
)
VIT_V1_BATCHES, VIT_L14_BATCHES, VIT_PROFILED = 4, 4, 2
# the ModifiedResNet and the EVA01 variant at the B/16 recipe's shapes
# (1024^2, crops at the tower's 224^2, batch 2, 20 boxes): evaluator batches
# after EVAL_WARMUP, the distill step's warm-up and timed steps, and batches
# or steps under the profiler for the kernel ms; RN50 trains its five lock
# groups (stem, layer1..4; the attention pool is never locked)
TOWER_MODELS = (
    Model("rn50", "RN50", image=1024, eval_batch=2),
    Model("eva01_b16", "EVA01-CLIP-B-16", image=1024, eval_batch=2),
    # the timm-family towers: ConvNeXt-Base at the recipe's 1024^2, Swin-B at
    # 896^2 (its stage grids must divide by the window 7, which 1024^2's 256
    # does not); both stride 32, crops at their 224^2; they train with
    # --no-lock-image (under the lock a timm tower trains nothing, as in JAX)
    Model("convnext_b", "convnext_base", image=1024, eval_batch=2),
    Model("swin_b", "swin_base_patch4_window7_224", image=896, eval_batch=2),
)
TOWER_BATCHES, TOWER_TRAIN_WARMUP, TOWER_TRAIN_TIMED, TOWER_PROFILED = 4, 2, 3, 2
RN_GROUPS = 5
# the flash kernels' rows at the large towers' head dims
WIDE_HEAD_DIMS = (80, 88, 104, 112)

# the detector phase: preset, images a batch (the reference's 8 a GPU), warm-up
# and timed batches, images of the parity phase, fixed rois of its head rows
DET_PRESET, DET_BATCH, DET_WARMUP, DET_BATCHES = "ov_coco_vitb16", 8, 2, 4
DET_PARITY_IMAGES, DET_FIXED_ROIS = 2, 32
# detector training: warm-up and timed steps of the recipe's run; the mask
# branch's preset, warm-up and timed steps
DET_TRAIN_WARMUP, DET_TRAIN_TIMED = 2, 5
DET_MASK_PRESET, DET_MASK_WARMUP, DET_MASK_TIMED = "ov_lvis_vitb16", 1, 2
# the detector's file path: the port's `tools/synth_det_data.py` writes the
# JAX drive's sets (8 PNGs at 640^2, 3 shapes an image, 6 trained classes,
# seed 7: OV-COCO rectangles, OV-LVIS ellipses); `fvit-train` takes
# DET_FILES_EPOCHS epochs of one batch of 8, as many as the JAX drive took
# before the checkpoint it scored (`artifacts/detector_recipe_overfit/`:
# `ovcoco_640_concat_eval_epoch119.json` with the concat RoI the port has,
# `ovlvis_640_eval_epoch99.json`), DET_FILES_PROFILED of them under the
# profiler from the tenth-last; `fvit-test` scores the last checkpoint. The
# bar is what the JAX package reached through its own CLIs: OV-COCO AP50
# 0.906 (concat RoI; 0.945 blend), OV-LVIS box AP50 1.0 and segm_AP50 1.0.
DET_FILES_EPOCHS = {"coco": 120, "lvis": 100}
DET_FILES_PROFILED, DET_FILES_MIN_AP50 = 6, 0.90
# an 8-image overfit's AP50 moves by up to ~0.05 with --seed in both packages
# (PERF.md section 2), so two more OV-COCO drives, side by side in
# processes of their own (`tools/detector_seed_sweep.py`), and the bar holds
# the median of the three as well as the seed-SEED drive
DET_FILES_SEEDS = (1, 2)
# the L/14 presets (EVA02-CLIP-L-14-336 at 896^2): evaluation and its parity
# as above, training 2 + 5 steps and the mask branch 1 + 2
DET_L14_PRESET, DET_L14_MASK_PRESET = "ov_coco_vitl14", "ov_lvis_vitl14"
# LVIS evaluation with masks (batches as above): items with gt masks and
# resize scales other than 1
DET_LVIS_PRESETS = ("ov_lvis_vitb16", "ov_lvis_vitl14")
# the text phase: the prompt-ensemble class matrix of OV-COCO (65 classes and
# a background row; OV-LVIS's 1203 classes are the same calls, more of them),
# at 64 prompts a call (every class has 63); its parity on one 64-prompt
# batch and on that matrix
TEXT_BATCH, TEXT_WARMUP_CLASSES = 64, 4

# CoCa: coca_ViT-L-14 (ViT-L/14 at 224^2 with the attentional pooler of 256
# queries; 12-block text tower and decoder at width 768; vocabulary 49408) on
# a batch of 8 images and 8 captions: forward and loss timed over COCA_TIMED
# calls after one, greedy captions of COCA_MAX_LEN tokens
COCA_MODEL, COCA_BATCH, COCA_TIMED, COCA_MAX_LEN = "coca_ViT-L-14", 8, 5, 20
COCA_CAPTIONS = (
    "a man riding a wave on top of a surfboard", "two dogs playing with a frisbee in the park",
    "a plate of food with broccoli and rice", "a red double decker bus driving down a street",
    "a cat sleeping on a laptop keyboard", "people walking on a beach near the ocean",
    "a kitchen with a stove and a refrigerator", "a giraffe standing next to a tall tree",
)
# greedy tokens of the f32 kernel path against the f32 plain path: EQUAL, or
# the first difference at a position whose top-2 logit gap (plain path) is
# under this: a near tie that summation order may flip
COCA_TIE_GAP = 1e-3

# the HF towers without transformers (`phase_hf`): (a) the transformers trunk
# adapter at ViTConfig's defaults (`hf_trunk_kwargs` "{}": ViT-B/16's widths,
# 12 layers at 224^2, patch 16) under `hf-vit-tiny-test`'s other settings,
# embed 512, registered as HF_VIT for the run: HF_EVAL_BATCHES evaluator
# batches of 2 after one, one profiled, and the distill step with
# --no-lock-image (HF_TRAIN_WARMUP + HF_TRAIN_TIMED steps and
# HF_TRAIN_PROFILED under the profiler); (b) roberta-ViT-B-32 with its text
# tower keyed by the model type "roberta" (RoBERTa-base's encoder widths,
# vocabulary 50265) on HF_TEXT_ROWS images and id rows of 77: CLIP.forward
# and clip_loss (which pairs image i with text i), then one backward into
# both towers. Both trunks compute in float32 whatever the model's dtype.
HF_VIT, HF_VIT_KWARGS, HF_VIT_SIZE, HF_EMBED = "hf-vit-b16-224", "{}", 224, 512
HF_EVAL_BATCHES, HF_TRAIN_WARMUP, HF_TRAIN_TIMED, HF_TRAIN_PROFILED = 2, 2, 3, 2
HF_TEXT_MODEL, HF_TEXT_TYPE, HF_TEXT_ROWS, HF_TEXT_TIMED = "roberta-ViT-B-32", "roberta", 64, 3

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory, dense bf16 tensor cores, and float32 at float32 accuracy.
# The least time for a float32 matrix product (the flash kernels) is the
# tensor cores' three TF32 products of the split x = hi + lo (lo_a hi_b +
# hi_a lo_b + hi_a hi_b) at the dense TF32 rate, 494.7 TFLOP/s: an
# effective 164.9 TFLOP/s, above the 67 TFLOP/s of float32 outside the
# tensor cores, which stays the peak of the float32 work that is no matrix
# product (the NMS's IoUs; RoPE and LayerNorm are bound by their bytes).
PEAK_BYTES_S, PEAK_BF16_FLOPS = 3.35e12, 989e12
PEAK_F32_FLOPS, PEAK_F32_SIMT_FLOPS = 494.7e12 / 3, 67e12
# Its L2 cache: a timing loop repeats on the same tensors, so a kernel whose
# bytes fit here is fed from the L2 after the first call and may read under
# its device-memory bound; such records say "l2_resident".
L2_BYTES = 50 * 2 ** 20

# Tolerances, each with its reason:
# RoPE: kernel and plain version compute the same two products in float32;
# the kernel fuses the add into an FMA, so they differ by at most one
# rounding, measured in ULPs of sum(|x_i * t_i|), the magnitude at which the
# products round (an output ULP would blow up where the two terms cancel).
ROPE_MAX_ULP = 2.0
# Attention f32: same math, other summation order and exp2 for exp.
ATTN_F32_MAX_ABS = 1e-4
# Attention bf16: the kernel rounds the probabilities to bf16 before the
# value product; plain float32 on the same (bf16-valued) inputs is the bar.
ATTN_BF16_MIN_COS = 0.9999
# Whole path: f32 kernels vs f32 plain differ by summation order only.
PATH_F32_MAX_ABS = 1e-4
# Whole path bf16 vs f32: the bar of PARITY_CHIP.md for the JAX tower's
# bf16 chip path against float32.
PATH_BF16_MIN_COS = 0.9996
# LSE: a sum of f32 exponentials in another order, values of ~log(N) ~ 8.
LSE_MAX_ABS = 1e-4
# Flash backward f32: up to N = 4097 products per entry summed in another
# order (a fixed one: two calls must give the same bits, in every design);
# relative to the largest gradient entry, since the gradients' scale depends
# on the inputs.
BWD_F32_MAX_REL = 1e-4
# Flash backward bf16: P and dS are rounded to bf16 before their products.
BWD_BF16_MIN_COS = 0.999
# The float32 flash kernels' TF32 split: every product form they run
# (`ops/hopper_mma_probe.py::TF32_PRODUCTS`, at every width they take)
# through the three-product split within 2e-6 of sum |a_k b_k| of the
# float64 product, and one TF32 product through the same loads at least 50
# times further off. The attention bars above do not tell them apart on the
# wide rows (one TF32 product errs ~7e-5 at [4097, 128]), so a kernel that
# lost its lo terms would pass those.
TF32_SPLIT_MAX_REL, TF32_ONE_MIN_RATIO = 2e-6, 50
# LayerNorm y and dx: kernel and plain version compute the same float32
# formulas; only the order of the row sums differs (and an FMA where the
# plain version rounds twice). Measured in float32 ULPs of the magnitude at
# which the terms round: (|x| + mean|x|) * rstd * |w| + |b| for y,
# rstd * (|g| + mean|g| + |xhat| * mean|g * xhat|) for dx (an ULP of the
# result would blow up where the terms cancel). bfloat16 rounds that float32
# value once on both sides, so a result may also land on the neighbouring
# bfloat16: one bfloat16 ULP of the plain result is allowed on top. The first
# run on an H100 measured at most 5 ULP (float32 forward at width 2730).
LN_MAX_ULP = 8.0
# LayerNorm dweight, dbias: float32 sums over all rows (8194 or 23080) in
# another order, relative to their largest entry.
LN_SUM_MAX_REL = 1e-5
# Train parity, one step at batch 1: f32 kernels vs f32 plain differ by
# summation order only; bf16 kernels vs f32 plain by bf16 rounding through
# the blocks and their backward. Tightened from 1e-3 and 0.99 after the
# first run on an H100 measured a max relative gradient error of 2.6e-6
# and a min gradient cosine of 0.99976 on B/16.
STEP_LOSS_MAX_ABS = 1e-5
# The RegionCLIP loss is a sum over the sampled classes averaged over the
# boxes, ~76 at these seeds, where one float32 ULP is 7.6e-6: its f32 legs
# are held relative to the plain loss, ~10 ULP (the first run on an H100
# read 1 ULP at B/16 and 0 at L/14).
REGION_LOSS_MAX_REL = 1e-6
STEP_GRAD_F32_MAX_REL = 1e-4
STEP_GRAD_BF16_MIN_COS = 0.999
# Recomputation: the first step's loss comes from the same forward kernels
# on the same weights and batch, with or without it.
RECOMPUTE_LOSS_MAX_ABS = 1e-5
# NMS: the keep mask is discrete; the kernel's arithmetic is pinned to the
# plain version's single rounded operations, so no flag may differ.
# Detector, bf16 kernels vs f32 plain: the dense VLM map keeps the bar of
# PARITY_CHIP.md; the other rows of its "fvit_detector_predict" table (taps,
# RPN maps, bbox-head logits and deltas on fixed rois) are reported, with a
# floor that only a broken path falls below: the first run on an H100
# measured 0.99984 (taps), 0.99957 (RPN maps), 0.99973 (logits) and 0.99905
# (deltas, rows of four small values).
DET_BF16_MIN_COS_FLOOR = 0.998
# Detector, f32 kernels vs f32 plain: the towers differ by summation order
# (1e-4 on the dense map, as above); taps are unnormalised values of order
# 10 and the heads stack convolutions on them: 1e-3 (the first run measured
# 4.3e-5 on the taps and 2.5e-5 on the logits).
DET_F32_MAX_ABS = 1e-3
# Detector training, one step at batch 2, the RoI stage of every leg on the
# plain leg's proposals: f32 kernels vs f32 plain differ by the trunk's
# summation order (taps within 1e-3 above), so the proposal sets are equal
# (no box without a counterpart within 0.01 px; the first run on an H100
# found none of 2000), the loss within 1e-4 relative (read 1.1e-7) and the
# whole trainable gradient at cosine >= 0.9999 (read 1.0000000); bf16
# kernels vs f32 plain, each parameter group's gradient at cosine >= 0.99
# (read 0.99223 for the pyramid, 0.99692 FPN, 0.99845 RPN, 0.99982 bbox head).
DET_TRAIN_LOSS_MAX_REL = 1e-4
DET_TRAIN_F32_MIN_COS = 0.9999
DET_TRAIN_BF16_MIN_COS = 0.99
DET_TRAIN_GROUPS = ("pyramid", "fpn", "rpn", "bbox_head")



def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _counters():
    from clipself_tpu_torch.ops import attention, layer_norm, nms, rope_roll

    return {
        "nms": nms.LAUNCHES,
        "flash_attention": attention.LAUNCHES,
        "flash_attention_bwd": attention.BWD_LAUNCHES,
        "rope_roll": rope_roll.LAUNCHES,
        "rope_roll_bwd": rope_roll.BWD_LAUNCHES,
        "layer_norm": layer_norm.LAUNCHES,
        "layer_norm_bwd": layer_norm.BWD_LAUNCHES,
    }


def reset_counts() -> None:
    for counter in _counters().values():
        counter.reset()


def read_counts() -> dict:
    return {name: counter.count for name, counter in _counters().items()}


def expected_launches(
    layers: int, *, evals: int = 0, steps: int = 0, recompute: bool = False, dets: int = 0,
    det_steps: int = 0, ave_pool: bool = False, text_calls: int = 0, text_layers: int = 0,
    region_steps: int = 0,
) -> dict:
    """Launches of ``evals`` evaluator batches plus ``steps`` train steps
    plus ``region_steps`` RegionCLIP train steps plus ``dets`` detector
    batches plus ``det_steps`` detector train steps of a tower of
    ``layers`` blocks. A dense pass runs layers - 1 attention
    blocks (the last block takes the value path), a crop pass all of them;
    RoPE runs once per attention block (q and k in one launch); every block has four
    LayerNorms and the tower a final one. An evaluator batch is one dense and
    one crop pass; a train step is the teacher's crop pass, the student's
    dense pass and its backward; a RegionCLIP step the student's dense pass
    and its backward alone (no teacher); with recomputation the student's
    blocks (not its final norm) run their forward once more. A detector batch is
    one dense pass (the taps) and two NMS launches, all images at once: the
    RPN's proposals and the final class-wise NMS. A detector train step is
    the taps without the dense map (the blocks' four norms each, the value
    path's included, no final norm; `models/eva_vit.py::forward_taps`) and
    one NMS launch (the train proposals); the trunk is frozen, so nothing of
    it runs backward. With ``ave_pool`` an evaluator batch encodes its crops
    densely (`image_ave_pool`): two dense passes. ``text_calls`` forwards of
    a text tower of ``text_layers`` blocks launch only LayerNorms, two a
    block and the final one: its attention is plain (`attention_masked`)."""
    dense, crop, norms = layers - 1, layers, 4 * layers + 1
    students = steps + region_steps  # dense passes with a backward
    again = students if recompute else 0
    crop_pass = dense if ave_pool else crop
    flash = (evals * (dense + crop_pass) + steps * crop + students * dense + again * dense
             + (dets + det_steps) * dense)
    return {
        "nms": 2 * dets + det_steps,
        "flash_attention": flash,
        "flash_attention_bwd": students * dense,
        "rope_roll": flash,
        "rope_roll_bwd": students * dense,
        "layer_norm": (2 * evals + steps + students + dets) * norms + again * 4 * layers
        + det_steps * 4 * layers + text_calls * (2 * text_layers + 1),
        "layer_norm_bwd": students * norms,
    }


@contextlib.contextmanager
def plain_path():
    """Swap the kernels' plain versions in where the towers call the kernel
    wrappers (`eva_vit.multi_head_attention`, `eva_vit.layer_norm`, which
    the text tower's and the OpenCLIP ViT's LayerNorms call too,
    `open_clip_vit.multi_head_attention`, `timm_vit.multi_head_attention`,
    `coca.multi_head_attention` (the CoCa pooler's cross-attention is plain
    on every path), `hf_vit.multi_head_attention` (the HF ViT trunk; the HF
    text trunks' attention is plain on every path and their LayerNorms are
    `eva_vit`'s), `rope.rolled_rope` and `rope.rolled_rope_qk`, the detector's
    `nms.nms_keep_mask`; the timm towers' LayerNorms are `eva_vit`'s); autograd
    differentiates them. Fails if any kernel
    launched inside, so a swap that misses a call site cannot compare the
    kernels with themselves."""
    from clipself_tpu_torch.models import coca, eva_vit, hf_vit, open_clip_vit, rope, timm_vit
    from clipself_tpu_torch.ops.attention import attention_masked
    from clipself_tpu_torch.ops.layer_norm import layer_norm_plain
    from clipself_tpu_torch.ops.rope_roll import rolled_rope_plain, unpack_tables

    def rope_plain(x, packed, packed_bwd):
        return rolled_rope_plain(x, *unpack_tables(packed))

    def rope_qk_plain(q, k, packed, packed_bwd):
        tables = unpack_tables(packed)
        return rolled_rope_plain(q, *tables), rolled_rope_plain(k, *tables)

    saved = (eva_vit.multi_head_attention, eva_vit.layer_norm, rope.rolled_rope, rope.rolled_rope_qk,
             open_clip_vit.multi_head_attention, timm_vit.multi_head_attention, coca.multi_head_attention,
             hf_vit.multi_head_attention)
    # the EVA tower's dispatch: unmasked calls took the flash kernel (a rel-pos
    # bias is a mask, plain on every path)
    eva_vit.multi_head_attention, eva_vit.layer_norm = attention_masked, layer_norm_plain
    rope.rolled_rope, rope.rolled_rope_qk = rope_plain, rope_qk_plain
    # the ViT towers' dispatch, and a CoCa cross block's where the keys are
    # as many as the queries: unmasked calls took the flash kernel
    open_clip_vit.multi_head_attention = timm_vit.multi_head_attention = attention_masked
    coca.multi_head_attention = hf_vit.multi_head_attention = attention_masked
    reset_counts()
    try:
        with plain_nms():
            yield
    finally:
        (eva_vit.multi_head_attention, eva_vit.layer_norm, rope.rolled_rope, rope.rolled_rope_qk,
         open_clip_vit.multi_head_attention, timm_vit.multi_head_attention, coca.multi_head_attention,
         hf_vit.multi_head_attention) = saved
    if any(read_counts().values()):
        fail(f"the plain path launched kernels: {read_counts()}")


@contextlib.contextmanager
def plain_nms():
    """Swap the plain NMS in where `detector/nms.py` calls the kernel's
    wrapper; fails if the NMS kernel launched inside."""
    from clipself_tpu_torch.detector import nms as det_nms
    from clipself_tpu_torch.ops import nms as ops_nms

    saved, before = det_nms.nms_keep_mask, ops_nms.LAUNCHES.count
    det_nms.nms_keep_mask = ops_nms.nms_keep_mask_plain
    try:
        yield
    finally:
        det_nms.nms_keep_mask = saved
    if ops_nms.LAUNCHES.count != before:
        fail("the plain NMS path launched the NMS kernel")


@contextlib.contextmanager
def drawn_once():
    """`models/factory.py::create_model` with each (config, seed)'s initial
    weights drawn once in this process: `create_model` draws every weight on
    the host from its seed (seconds a tower, most of a model's build), and
    this script builds the same models again and again (evaluator, parity,
    trainer, detector). A later call of a config and seed already drawn
    builds the modules and loads the values of the first draw, which are
    bit for bit what a fresh draw gives; `pretrained=` calls draw as before.
    Every module that holds `create_model` by name takes the wrapper."""
    import torch

    from clipself_tpu_torch.models import factory

    original, drawn = factory.create_model, {}

    def create_model(name_or_cfg, **kw):
        cfg = factory.get_model_config(name_or_cfg) if isinstance(name_or_cfg, str) else name_or_cfg
        key = (cfg, kw.get("seed", 0))
        if kw.get("pretrained") or key not in drawn:
            model = original(cfg, **kw)
            if not kw.get("pretrained"):
                drawn[key] = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
            return model
        model = factory.model_class(cfg)(cfg, dtype=kw.get("dtype", torch.bfloat16),
                                         grad_checkpointing=kw.get("grad_checkpointing", False))
        model.load_state_dict(drawn[key])
        return model.to(kw["device"]).eval()

    for m in list(sys.modules.values()):
        if getattr(m, "create_model", None) is original:
            m.create_model = create_model
    try:
        yield
    finally:  # the modules imported inside hold the wrapper too
        for m in list(sys.modules.values()):
            if getattr(m, "create_model", None) is create_model:
                m.create_model = original


def cuda_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean device time of one ``fn()`` between two CUDA events. With
    ``graph`` the ``iters`` calls are captured into one CUDA graph and
    replayed: a kernel of some ten microseconds is otherwise timed at the
    pace of the host's launches, not at its own."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reps = 1
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(iters):
                fn()
        captured.replay()
        torch.cuda.synchronize()
        reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        if graph:
            captured.replay()
        else:
            for _ in range(iters):
                fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def min_row_cos(a, b) -> float:
    import torch

    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()


def ulp(t, dtype):
    """Spacing of ``dtype`` at |t| (t float32; zeros get the smallest normal)."""
    import torch

    mant = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    tiny = torch.finfo(dtype).tiny
    mag = torch.clamp(t.abs(), min=tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - mant)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Records:
    """Per kernel, one record for each shape and type it was checked at:
    error, kernel / plain / library times and the card's bound."""

    def __init__(self):
        self.rows: dict[str, list[dict]] = {}

    def add(self, name, what, shape, dtype, *, err, ms, plain_ms, library_ms, moved, flops,
            note="", design=None, peak=None):
        """``moved``: bytes of every input read once and every output written
        once; ``flops``: operations on these inputs; ``peak``: the card's rate
        for them (by default the dense bf16 tensor cores for bfloat16, float32
        outside the tensor cores otherwise); ``design``: which of a kernel's
        hand-written designs the shape and type took. ``bound_ms`` is the
        function's, whatever the design does on top."""
        import torch

        if peak is None:
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_SIMT_FLOPS
        by_bytes, by_ops = moved / PEAK_BYTES_S * 1e3, flops / peak * 1e3
        rec = dict(
            what=what, shape=list(shape), dtype=str(dtype)[6:], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=library_ms,
            l2_resident=moved < L2_BYTES,
        )
        if design is not None:
            rec["design"] = design
            note += f"design {design} "
        self.rows.setdefault(name, []).append(rec)
        lib = "none" if library_ms is None else f"{library_ms:.4f}"
        print(
            f"kernel {name} {what} {list(shape)} {rec['dtype']}: max_abs {err:.3e} {note}"
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
            f"bound_ms {rec['bound_ms']:.4f} ({ms / rec['bound_ms']:.2f}x, {rec['bound_by']}"
            f"{'; the timed calls repeat on bytes that fit the L2' if rec['l2_resident'] else ''})",
            flush=True,
        )

    def primary(self, name: str, what: str, shape, dtype: str = "bfloat16") -> dict:
        """The record of one shape (bfloat16 unless told): the row's own numbers."""
        for rec in self.rows[name]:
            if (rec["what"], rec["shape"], rec["dtype"]) == (what, list(shape), dtype):
                return rec
        fail(f"no {dtype} record of {name} {what} at {list(shape)}")


def check_rope(torch, dev, records, gen, shape, grid, head_dim, backward):
    """The kernel on one tensor and on two (q and k in one launch, as the
    towers call it), forward and, with ``backward``, on the gradients with
    the packed backward table, against the plain version on the same
    inputs."""
    from clipself_tpu_torch.models.rope import rope_tables, rope_tables_bwd, rope_tables_packed
    from clipself_tpu_torch.ops import rope_roll

    b, n, w = shape
    key = (grid, grid, head_dim, 1, 16, dev)
    tables = rope_tables(*key)
    a_bwd, b_bwd = rope_tables_bwd(*key)
    packed, packed_bwd = rope_tables_packed(*key)
    directions = [("forward", packed, tables)]
    if backward:
        # the backward: the same kernel on dy with the rolled tables in
        # swapped slots, against autograd of the plain forward
        directions.append(("backward", packed_bwd, (tables[0], b_bwd, a_bwd)))
    for dt in (torch.float32, torch.bfloat16):
        design = rope_roll.kernel_design(dt, head_dim)
        for what, table, plain_tables in directions:
            back = what == "backward"
            q, k = (torch.randn(b, n, w, generator=gen, device=dev).to(dt) for _ in range(2))
            if back:
                leaves = [torch.zeros_like(t, requires_grad=True) for t in (q, k)]
                want = [
                    torch.autograd.grad(rope_roll.rolled_rope_plain(x, *tables), x, dy)[0].float()
                    for x, dy in zip(leaves, (q, k))
                ]
            else:
                want = [rope_roll.rolled_rope_plain(x, *tables).float() for x in (q, k)]
            mags = [rope_roll.rolled_rope_plain(x.float().abs(), *(t.abs() for t in plain_tables)) for x in (q, k)]
            for xs, label in (((q,), what), ((q, k), f"{what} q,k")):
                got = rope_roll.rolled_rope_packed(xs, table, backward=back)
                torch.cuda.synchronize()
                diffs = [(g.float() - wnt).abs() for g, wnt in zip(got, want)]
                err_ulp = max((d / ulp(m, dt)).max().item() for d, m in zip(diffs, mags))
                records.add(
                    "rope_roll", label, shape, dt, err=max(d.max().item() for d in diffs),
                    ms=cuda_ms(lambda: rope_roll.rolled_rope_packed(xs, table, backward=back), graph=True),
                    plain_ms=cuda_ms(
                        lambda: [rope_roll.rolled_rope_plain(x, *plain_tables) for x in xs], graph=True
                    ),
                    note=f"max_ulp {err_ulp:.2f} (bar {ROPE_MAX_ULP}) ", design=design, library_ms=None,
                    # every tensor read and written once, the packed table read
                    # once; y = x*cos + roll*sin: four operations an element
                    moved=2 * nbytes(*xs) + nbytes(table), flops=4 * len(xs) * q.numel(),
                )
                if not err_ulp <= ROPE_MAX_ULP:
                    fail(f"rope_roll {label} {dt} {shape} off by {err_ulp} ULP")


def sdpa(torch, q, k, v, scale, mask=None):
    """The library's attention on the same [B, N, H, D] tensors (with an
    additive ``mask`` broadcast against [B, H, N, N])."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, scale=scale
    )
    return out.transpose(1, 2)


def check_attention(torch, dev, records, gen, shape, train, graph=False):
    """The forward on [B, N, H, D] per-head views of [B, N, W] projections;
    with ``train`` also the forward with its LSE and the one-pass backward
    (plain float32 on the bf16-valued inputs is the bar for bf16). With
    ``graph`` the kernel, plain and library calls are timed from a CUDA
    graph (`cuda_ms`): at CoCa's small shapes the host's launch pace would
    hide their device times; the library's backward stays eager."""
    from clipself_tpu_torch.ops import attention

    b, n, h, d = shape
    scale = d ** -0.5
    flops = 4 * b * h * n * n * d  # the two products Q K^T and P V
    for dt in (torch.float32, torch.bfloat16):
        iters = 5 if dt == torch.float32 else 10
        # matrix products: float32 at float32 accuracy is the TF32 split's
        peak = PEAK_F32_FLOPS if dt == torch.float32 else PEAK_BF16_FLOPS
        q, k, v = (
            torch.randn(b, n, h * d, generator=gen, device=dev).to(dt).view(b, n, h, d) for _ in range(3)
        )
        got = attention.flash_attention_fwd(q, k, v, scale).float()
        f = [t.float() for t in (q, k, v)]
        want = attention.attention_plain(*f, scale)
        max_abs = (got - want).abs().max().item()
        cos = min_row_cos(got, want)
        del got, want
        records.add(
            "flash_attention", "forward", shape, dt, err=max_abs,
            ms=cuda_ms(lambda: attention.flash_attention_fwd(q, k, v, scale), iters, graph=graph),
            plain_ms=cuda_ms(lambda: attention.attention_plain(q, k, v, scale), iters, graph=graph),
            library_ms=cuda_ms(lambda: sdpa(torch, q, k, v, scale), iters, graph=graph),
            moved=4 * nbytes(q), flops=flops, note=f"min_row_cos {cos:.7f} ",
            design=attention.kernel_design(dt, d), peak=peak,
        )
        if dt == torch.float32 and not max_abs <= ATTN_F32_MAX_ABS:
            fail(f"flash_attention f32 {shape} max abs {max_abs}")
        if dt == torch.bfloat16 and not cos >= ATTN_BF16_MIN_COS:
            fail(f"flash_attention bf16 {shape} min row cosine {cos}")
        if not train:
            continue
        out, lse = attention.flash_attention_fwd(q, k, v, scale, return_lse=True)
        out32, lse32 = attention.attention_lse_plain(*f, scale)
        lse_err = (lse - lse32).abs().max().item()
        records.add(
            "flash_attention", "forward with lse", shape, dt, err=lse_err,
            ms=cuda_ms(lambda: attention.flash_attention_fwd(q, k, v, scale, return_lse=True), iters, graph=graph),
            plain_ms=cuda_ms(lambda: attention.attention_lse_plain(q, k, v, scale), iters, graph=graph),
            library_ms=None, moved=4 * nbytes(q) + nbytes(lse), flops=flops,
            note=f"(of the lse, bar {LSE_MAX_ABS}) ", design=attention.kernel_design(dt, d), peak=peak,
        )
        if not lse_err <= LSE_MAX_ABS:
            fail(f"flash_attention lse {dt} {shape} max abs {lse_err}")
        do = torch.randn(q.shape, generator=gen, device=dev).to(dt)
        got = attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
        again = attention.flash_attention_bwd(q, k, v, out, lse, do, scale)
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = attention.attention_bwd_plain(*f, out32, lse32, do.float(), scale)
        del out32, lse32
        errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        rel = max(e / w.abs().max().item() for e, w in zip(errs, want))
        coss = [min_row_cos(g, w) for g, w in zip(got, want)]
        finite = all(torch.isfinite(g).all().item() for g in got)
        del got, want, f
        # the library's backward alone: autograd of its forward, kept graph,
        # timed eagerly always (autograd's backward does not capture into a
        # CUDA graph here: the engine ties the capture to the legacy stream)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = sdpa(torch, *leaves, scale)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), iters)
        records.add(
            "flash_attention_bwd", "backward", shape, dt, err=max(errs),
            ms=cuda_ms(lambda: attention.flash_attention_bwd(q, k, v, out, lse, do, scale), iters, graph=graph),
            plain_ms=cuda_ms(lambda: attention.attention_bwd_plain(q, k, v, out, lse, do, scale), 5, graph=graph),
            library_ms=lib_bwd_ms,
            # q, k, v, out, dO and the lse read, dq, dk, dv written; five
            # products (S, dP, dV, dK, dQ)
            moved=8 * nbytes(q) + nbytes(lse), flops=flops * 5 // 2,
            note=f"rel {rel:.3e} min_row_cos {min(coss):.6f} second call {'EQUAL' if repeats else 'DIFFERS'} "
            + ("(library eager) " if graph else ""),
            design=attention.kernel_design(dt, d, backward=True), peak=peak,
        )
        del lib_out, leaves
        if not finite:
            fail(f"flash_attention_bwd {dt} {shape}: non-finite gradient")
        if not repeats:
            fail(f"flash_attention_bwd {dt} {shape}: a second call on the same inputs gave other bits")
        if dt == torch.float32 and not rel <= BWD_F32_MAX_REL:
            fail(f"flash_attention_bwd f32 {shape} relative error {rel} (bar {BWD_F32_MAX_REL})")
        if dt == torch.bfloat16 and not min(coss) >= BWD_BF16_MIN_COS:
            fail(f"flash_attention_bwd bf16 {shape} min row cosine {min(coss)}")


# the views of a [B, N, W] tensor that the tower's LayerNorms see
LN_VIEWS = {
    "": lambda t: t,
    " rows 1: of": lambda t: t[:, 1:],  # the dense pass's final norm
    " row 0 of": lambda t: t[:, 0],     # the CLS pass's final norm
}


def check_layer_norm(torch, dev, records, gen, shape, view, backward, eps=1e-6, tag=""):
    """The forward (with and without statistics) and, with ``backward``,
    the backward against their plain versions on the ``view`` of a
    ``shape`` tensor, at ``eps``; ``tag`` is appended to each record's name
    (the HF towers' rows: eps 1e-12)."""
    from clipself_tpu_torch.ops import layer_norm as ln

    w = shape[-1]
    for dt in (torch.float32, torch.bfloat16):
        x = LN_VIEWS[view]((torch.randn(shape, generator=gen, device=dev) * 3 + 0.5).to(dt))
        dy = LN_VIEWS[view](torch.randn(shape, generator=gen, device=dev).to(dt)).contiguous()
        weight = torch.randn(w, generator=gen, device=dev) * 0.2 + 1.0
        bias = torch.randn(w, generator=gen, device=dev) * 0.1
        # the library call takes the affine in x's type
        lib_w, lib_b = weight.to(dt), bias.to(dt)
        what = (f"{view} {list(shape)}:" if view else "") + tag

        def err_ulps(got, want, mag):
            diff = (got.float() - want.float()).abs()
            if dt == torch.bfloat16:
                diff = torch.clamp(diff - ulp(want.float(), dt), min=0.0)
            return (diff / ulp(mag, torch.float32)).max().item()

        want, mu, rstd = ln.layer_norm_stats_plain(x, weight, bias, eps)
        xf = x.float()
        mag = (xf.abs() + xf.abs().mean(-1, keepdim=True)) * (rstd[..., None] * weight.abs())
        mag = mag + bias.abs()
        for stats in (False, True):
            out = ln.layer_norm_fwd(x, weight, bias, eps, return_stats=stats)
            got = out[0] if stats else out
            err = err_ulps(got, want, mag)
            if stats:
                stat_err = max(
                    ((out[1] - mu).abs() / ulp(xf.abs().mean(-1), torch.float32)).max().item(),
                    ((out[2] - rstd).abs() / ulp(rstd, torch.float32)).max().item(),
                )
                err = max(err, stat_err)
            records.add(
                "layer_norm", f"forward{' with stats' if stats else ''}{what}", x.shape, dt,
                err=(got.float() - want.float()).abs().max().item(),
                ms=cuda_ms(lambda: ln.layer_norm_fwd(x, weight, bias, eps, return_stats=stats), graph=True),
                plain_ms=cuda_ms(lambda: ln.layer_norm_plain(x, weight, bias, eps), graph=True),
                library_ms=cuda_ms(
                    lambda: torch.nn.functional.layer_norm(x, (w,), lib_w, lib_b, eps), graph=True
                ),
                # x read, y written, the affine read, the statistics written
                moved=2 * nbytes(x) + nbytes(weight, bias) + (nbytes(mu, rstd) if stats else 0),
                flops=8 * x.numel(), note=f"max_ulp {err:.2f} (bar {LN_MAX_ULP}) ",
            )
            if not err <= LN_MAX_ULP:
                fail(f"layer_norm {dt} {what} {tuple(x.shape)} stats={stats} off by {err} ULP")
        if not backward:
            continue
        # both sides take the kernel forward's statistics
        _, mu, rstd = ln.layer_norm_fwd(x, weight, bias, eps, return_stats=True)
        got = ln.layer_norm_bwd(x, dy, mu, rstd, weight)
        design = ln.describe_bwd(x, dy, got[0])
        want = ln.layer_norm_bwd_plain(x, dy, mu, rstd, weight)
        g = dy.float() * weight
        xhat = (xf - mu[..., None]) * rstd[..., None]
        mag = rstd[..., None] * (
            g.abs() + g.abs().mean(-1, keepdim=True)
            + xhat.abs() * (g * xhat).abs().mean(-1, keepdim=True)
        )
        err = err_ulps(got[0], want[0], mag)
        sum_rel = max(
            ((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got[1:], want[1:])
        )
        # the library's backward as one call, on its own forward's statistics
        _, lib_mean, lib_rstd = torch.ops.aten.native_layer_norm(x, [w], lib_w, lib_b, eps)
        records.add(
            "layer_norm_bwd", f"backward{what}", x.shape, dt,
            err=(got[0].float() - want[0].float()).abs().max().item(),
            ms=cuda_ms(lambda: ln.layer_norm_bwd(x, dy, mu, rstd, weight), graph=True),
            plain_ms=cuda_ms(lambda: ln.layer_norm_bwd_plain(x, dy, mu, rstd, weight), graph=True),
            library_ms=cuda_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [w], lib_mean, lib_rstd, lib_w, lib_b, [True, True, True]
                ),
                graph=True,
            ),
            # x, dy, the statistics and the weight read; dx, dweight, dbias
            # written (the per-block partial sums are scratch, not counted)
            moved=3 * nbytes(x) + nbytes(mu, rstd) + 3 * nbytes(weight),
            flops=14 * x.numel(),
            note=f"max_ulp {err:.2f} (bar {LN_MAX_ULP}) sums rel {sum_rel:.3e} (bar {LN_SUM_MAX_REL}) ",
            design=design,
        )
        if not err <= LN_MAX_ULP:
            fail(f"layer_norm_bwd {dt} {what} {tuple(x.shape)} dx off by {err} ULP")
        if not sum_rel <= LN_SUM_MAX_REL:
            fail(f"layer_norm_bwd {dt} {what} {tuple(x.shape)} dweight/dbias off by {sum_rel}")


# (kind, images, boxes, IoU threshold, timed[, classes, frame side]): the
# detector's own shapes first (RPN candidates, final class-wise NMS over the
# 65 OV-COCO classes at 640^2, one image), then edge cases, then the final
# NMS over the 1203 OV-LVIS classes at 896^2 (offsets up to ~1.08e6)
NMS_CASES = (
    ("anchors", 8, 2000, 0.7, True), ("class_offset", 8, 2000, 0.4, True),
    ("anchors", 1, 2000, 0.7, True), ("invalid_tail", 8, 1999, 0.7, False),
    ("plain", 2, 1, 0.5, False), ("none_valid", 2, 300, 0.5, False),
    ("identical", 2, 300, 0.5, False), ("zero_area", 2, 515, 0.5, False),
    ("duplicates", 2, 300, 0.4, False),
    # below zero even disjoint pairs suppress: the kernel's shortcut for empty
    # intersections must be off
    ("plain", 2, 300, -0.5, False),
    ("class_offset", 8, 2000, 0.4, True, 1203, 896),
)


def check_nms(torch, dev, records):
    """The kernels' keep mask against the plain version's, flag for flag,
    and against the plain mirror of their two phases."""
    from clipself_tpu_torch.detector.data import synthetic_nms_case
    from clipself_tpu_torch.ops import nms

    for seed, (kind, b, n, thr, timed, *frame) in enumerate(NMS_CASES):
        boxes, valid = (t.to(dev) for t in synthetic_nms_case(kind, b, n, seed, *frame))
        got = nms.nms_keep_mask(boxes, valid, thr)
        torch.cuda.synchronize()
        want = nms.nms_keep_mask_plain(boxes, valid, thr)
        differ = (got != want).sum().item()
        mirror_differs = (nms.nms_keep_mask_blockwise_plain(boxes, valid, thr) != want).sum().item()
        kept = got.sum(dim=1)
        what = f"keep mask {kind} thr {thr}" + (" %d classes %dpx" % tuple(frame) if frame else "")
        if not timed:
            print(
                f"kernel nms {what} [{b}, {n}, 4]: {differ} flags differ (the block-wise plain "
                f"mirror: {mirror_differs}), kept {kept.tolist()}",
                flush=True,
            )
        else:
            # the bound is the function's, what this data needs: each kept
            # box against every later box, ~14 float operations an IoU and
            # its test; boxes and validity read once, the mask written once
            ranks = torch.arange(n, device=dev)
            ious = ((n - 1 - ranks) * got).sum().item()
            # what the design does on top (in the note, not in the bound):
            # every pair i < j, and the bit matrix (the words from each row's
            # diagonal word on) written once and read once
            words = (n + nms.BLOCK - 1) // nms.BLOCK
            all_pairs = b * n * (n - 1) // 2
            matrix_bytes = 8 * b * sum(words - i // nms.BLOCK for i in range(n))
            mirror_ms = cuda_ms(
                lambda: nms.nms_keep_mask_blockwise_plain(boxes, valid, thr), iters=2, warmup=1
            )
            records.add(
                "nms", what, boxes.shape, torch.float32, err=float(differ),
                ms=cuda_ms(lambda: nms.nms_keep_mask(boxes, valid, thr)),
                plain_ms=cuda_ms(lambda: nms.nms_keep_mask_plain(boxes, valid, thr), iters=2, warmup=1),
                library_ms=None, moved=nbytes(boxes, valid, got), flops=14 * ious,
                design="bit matrix, block-wise scan",
                note=f"(flags that differ; the block-wise plain mirror: {mirror_differs}, "
                f"{mirror_ms:.4f} ms) kept {kept.tolist()}, the function's {ious} IoUs; the design: "
                f"{all_pairs} IoUs, {2 * matrix_bytes} bytes of bit matrix written and read, "
                f"dependent chain {words} blocks of {nms.BLOCK} boxes an image ",
            )
        if differ or mirror_differs:
            fail(
                f"nms {what} [{b}, {n}]: {differ} flags of the kernel and {mirror_differs} of the "
                "block-wise plain mirror differ from the plain version"
            )
        if got[~valid].any():
            fail(f"nms {what}: an invalid slot was kept")


def check_tf32_split(torch, dev):
    """Each TF32 product form of the float32 flash kernels (the probe's
    `tf32_probe`, through the kernels' own fragment loads, split tiles and
    products) against the float64 product, split and as one TF32 product."""
    from clipself_tpu_torch.ops import hopper_mma_probe as probe

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, ratio = 0.0, float("inf")
    for mode, k, n in probe.TF32_PRODUCTS:
        a, b = (torch.randn(shape, generator=gen, device=dev) for shape in probe.tf32_shapes(mode, k, n))
        want = probe.tf32_probe_plain(a, b, mode)
        mag = probe.tf32_probe_plain(a.abs(), b.abs(), mode)
        split = ((probe.tf32_probe(a, b, mode) - want).abs() / mag).max().item()
        one = ((probe.tf32_probe(a, b, mode, split=False) - want).abs() / mag).max().item()
        if not (split <= TF32_SPLIT_MAX_REL and one >= TF32_ONE_MIN_RATIO * split):
            fail(f"tf32 split form {(mode, k, n)}: split {split:.3e}, one TF32 product {one:.3e} of sum |a b|")
        worst, ratio = max(worst, split), min(ratio, one / max(split, 1e-30))
    print(
        f"tf32 split: {len(probe.TF32_PRODUCTS)} forms, worst {worst:.3e} of sum |a b| (bar "
        f"{TF32_SPLIT_MAX_REL}); one TF32 product at least {ratio:.0f}x that (bar {TF32_ONE_MIN_RATIO}x)",
        flush=True,
    )


def phase_kernels(torch, dev, records):
    check_tf32_split(torch, dev)
    # the rows' inputs are drawn on the card: a host draw of their ~4 G
    # values took ~35 s
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for s in MODELS:
        v = s.vision
        student = (TRAIN_BATCH, s.tokens(s.image), v.width)
        # the crop pass: the evaluator's bucket of crops for B/16 (as the
        # earlier runs), the teacher's 40 crops for L/14
        n_crops = 2 * BUCKET if s.key == "b16" else TRAIN_BATCH * TRAIN_BOXES
        crops = (n_crops, s.tokens(s.crop), v.width)
        heads = (s.heads, v.head_width)
        check_rope(torch, dev, records, gen, student, s.grid(s.image), heads[1], backward=True)
        check_rope(torch, dev, records, gen, crops, s.grid(s.crop), heads[1], backward=False)
        check_attention(torch, dev, records, gen, student[:2] + heads, train=True)
        check_attention(torch, dev, records, gen, crops[:2] + heads, train=False)
        if s.key == "b16":  # the detector's dense pass: 8 images at 640^2
            from clipself_tpu_torch.detector.config import PRESETS

            side = PRESETS[DET_PRESET].image_size
            det_shape = (DET_BATCH, s.tokens(side), v.width)
            check_rope(torch, dev, records, gen, det_shape, s.grid(side), heads[1], backward=False)
            check_attention(torch, dev, records, gen, (DET_BATCH, s.tokens(side)) + heads, train=False)
            for width in (v.width, s.hidden):
                check_layer_norm(torch, dev, records, gen, det_shape[:2] + (width,), "", backward=False)
        if s.key == "l14":  # the evaluator's own shapes: one image, one bucket
            check_attention(torch, dev, records, gen, (1, student[1]) + heads, train=False)
            check_attention(torch, dev, records, gen, (BUCKET, crops[1]) + heads, train=False)
            # the L/14 detectors' dense pass: 8 images at 896^2
            from clipself_tpu_torch.detector.config import PRESETS

            side = PRESETS[DET_L14_PRESET].image_size
            det_shape = (DET_BATCH, s.tokens(side), v.width)
            check_rope(torch, dev, records, gen, det_shape, s.grid(side), heads[1], backward=False)
            check_attention(torch, dev, records, gen, det_shape[:2] + heads, train=False)
            for width in (v.width, s.hidden):
                check_layer_norm(torch, dev, records, gen, det_shape[:2] + (width,), "", backward=False)
        torch.cuda.empty_cache()
        # the text tower's LayerNorms: a call of 64 prompts of 77 tokens
        t = s.text
        check_layer_norm(
            torch, dev, records, gen, (TEXT_BATCH, t.context_length, t.width), "", backward=False,
            eps=t.ln_eps,
        )
        for width in (v.width, s.hidden):
            check_layer_norm(torch, dev, records, gen, student[:2] + (width,), "", backward=True)
        if s.key == "b16":  # the RegionCLIP step: the recipe's batch 16, no teacher
            region = (REGION_BATCH,) + student[1:]
            check_rope(torch, dev, records, gen, region, s.grid(s.image), heads[1], backward=True)
            check_attention(torch, dev, records, gen, region[:2] + heads, train=True)
            torch.cuda.empty_cache()
            for width in (v.width, s.hidden):
                check_layer_norm(torch, dev, records, gen, region[:2] + (width,), "", backward=True)
            # the dense pass's final norm
            check_layer_norm(torch, dev, records, gen, region, " rows 1: of", backward=True)
        if s.key == "l14":
            teacher = (TRAIN_BATCH * TRAIN_BOXES, s.tokens(s.crop))
            for width in (v.width, s.hidden):
                check_layer_norm(torch, dev, records, gen, teacher + (width,), "", backward=False)
            check_layer_norm(torch, dev, records, gen, student, " rows 1: of", backward=True)
            check_layer_norm(torch, dev, records, gen, teacher + (v.width,), " row 0 of", backward=True)
    # coca_ViT-L-14's vision trunk at a batch of 8 at 224^2 (257 tokens,
    # forward and backward: coca_loss trains it) and coca_ViT-B-32's (50
    # tokens: one ragged tile)
    check_attention(torch, dev, records, gen, (COCA_BATCH, 257, 16, 64), train=True, graph=True)
    check_attention(torch, dev, records, gen, (COCA_BATCH, 50, 12, 64), train=False, graph=True)
    # the HF ViT-B/16 trunk at 224^2 (`phase_hf`; float32 on every path): the
    # distill step's student at batch 2, forward and backward (its crops'
    # [50, 197, 12, 64] and the evaluator's are the B/16 crop rows above),
    # and its LayerNorms at eps 1e-12: an evaluator batch's crops, the
    # student's rows with their backward, and the RoBERTa text tower's 64
    # rows of 77 with their backward
    check_attention(torch, dev, records, gen, (TRAIN_BATCH, 197, 12, 64), train=True, graph=True)
    # ViT-B-16's step at tensor parallelism 2 (`phase_vit_tp`): a rank's 6 of
    # the 12 heads, the student's dense pass with its backward and the
    # teacher's 40 crops
    vit = VIT_MODELS[0]
    half = (vit.heads // 2, vit.vision.head_width)
    check_attention(torch, dev, records, gen, (TRAIN_BATCH, vit.tokens(vit.image)) + half, train=True)
    check_attention(torch, dev, records, gen, (TRAIN_BATCH * TRAIN_BOXES, vit.tokens(vit.crop)) + half, train=False)
    # the pipeline's microbatch, one B/16 image at 1024^2 (`phase_vit_tp`'s
    # `pipeline_ring_rank`), forward and backward
    b16 = MODELS[0]
    micro = (PP_BATCH // PP_MICROBATCHES, b16.tokens(b16.image))
    check_rope(torch, dev, records, gen, micro + (b16.vision.width,), b16.grid(b16.image), b16.vision.head_width,
               backward=True)
    check_attention(torch, dev, records, gen, micro + (b16.heads, b16.vision.head_width), train=True)
    for width in (b16.vision.width, b16.hidden):
        check_layer_norm(torch, dev, records, gen, micro + (width,), "", backward=True)
    torch.cuda.empty_cache()
    for shape, backward in (((2 * BUCKET, 197, 768), False), ((TRAIN_BATCH, 197, 768), True),
                            ((HF_TEXT_ROWS, 77, 768), True)):
        check_layer_norm(torch, dev, records, gen, shape, "", backward=backward, eps=1e-12, tag=" eps 1e-12")
    # the large towers' head dims, which the bf16 wgmma design takes on two
    # 64-column panels and the f32 tf32x3 design on 16-wide tiles, zero-filled
    # past the head_dim (88: ViT-g-14, EVA01-CLIP-g-14; 104: ViT-bigG-14)
    # or exactly (80: ViT-H-14; 112: EVA02-CLIP-bigE-14, ViT-e-14), over
    # the L/14-size grid at 896^2 (also g-14's): one image, 16 heads
    l14 = MODELS[-1]
    for d in WIDE_HEAD_DIMS:
        check_attention(torch, dev, records, gen, (1, l14.tokens(l14.image), 16, d), train=True)
        torch.cuda.empty_cache()
    # the timm towers' LayerNorms on their channels-last rows: ConvNeXt-Base
    # at 1024^2 (eps 1e-6) at stage 1's width 128 and stage 4's 1024 (the
    # dense head norm's shape too), forward and backward, and the head norm
    # of an evaluator batch's pooled crops; Swin-B at 896^2 (eps 1e-5) at its
    # first patch merging, 4C = 512
    from clipself_tpu_torch.models.convnext import CONVNEXT_ARCHS
    from clipself_tpu_torch.models.swin import SWIN_ARCHS

    cn, sw = (s for s in TOWER_MODELS if s.timm)
    dims, side = CONVNEXT_ARCHS[cn.vision.timm_model_name][1], cn.image // 4
    swin_c, swin_side = SWIN_ARCHS[sw.vision.timm_model_name][0], sw.image // 8
    for shape, eps, backward in (
        ((cn.eval_batch, side, side, dims[0]), 1e-6, True),
        ((cn.eval_batch, side // 8, side // 8, dims[-1]), 1e-6, True),
        ((cn.eval_batch * BUCKET, dims[-1]), 1e-6, False),
        ((sw.eval_batch, swin_side, swin_side, 4 * swin_c), 1e-5, True),
    ):
        check_layer_norm(torch, dev, records, gen, shape, "", backward=backward, eps=eps)
    torch.cuda.empty_cache()
    check_nms(torch, dev, records)


def phase_eval(torch, dev, s: Model):
    import numpy as np

    from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.models.factory import create_model

    model = create_model(s.model, device=dev, dtype=torch.bfloat16, seed=SEED)
    cfg = model.cfg

    def batch(i):
        # staged on the card, as the JAX evaluator bench stages them
        host = synthetic_panoptic_batch(
            i, batch=s.eval_batch, image_size=s.image, max_anns=MAX_ANNS, valid_anns=VALID_ANNS,
            crop_size=s.crop, mask_hw=s.grid(s.image), n_classes=N_CLASSES, seed=SEED,
        )
        return {k: (v if k == "boxes" else torch.as_tensor(v, device=dev)) for k, v in host.items()}

    warm = [batch(N_BATCHES + i) for i in range(EVAL_WARMUP)]
    batches = [batch(i) for i in range(N_BATCHES)]
    emb = class_embeddings(N_CLASSES, cfg.embed_dim, seed=SEED)

    def timed(ave_pool: bool) -> dict:
        tag = f"{s.key} eval" + (" image_ave_pool" if ave_pool else "")
        run = lambda bs: evaluate_zero_shot(  # noqa: E731
            model, bs, emb, device=dev, ann_bucket=BUCKET, image_ave_pool=ave_pool
        )
        run(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = run(batches)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts()
        ips = s.eval_batch * N_BATCHES / dt
        crops = "mean dense feature of each crop" if ave_pool else "CLS embedding of each crop"
        print(
            f"{tag} {s.model} zero-shot: {N_BATCHES} batches x {s.eval_batch} images "
            f"{s.image}px, {VALID_ANNS} valid of {MAX_ANNS} anns (bucket {BUCKET}), crops "
            f"{s.crop}px ({crops}), {cfg.vision.layers} blocks: {dt:.3f} s after {EVAL_WARMUP} "
            f"warm-up batches, {dt / N_BATCHES * 1e3:.3f} ms a batch, {ips:.3f} images/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB",
            flush=True,
        )
        print(f"{tag} mAcc " + json.dumps(res, sort_keys=True), flush=True)
        print(f"{tag} launches " + json.dumps(launches), flush=True)
        if len(res) != 12 or not all(np.isfinite(v) for v in res.values()):
            fail(f"{tag}: evaluator result not finite: {res}")
        expect = expected_launches(cfg.vision.layers, evals=N_BATCHES, ave_pool=ave_pool)
        if launches != expect:
            fail(f"{tag} launch counts {launches}, expected {expect}")
        return launches

    paths = {f"{s.key}_eval": timed(False)}
    if s.key == "b16":  # the evaluator's `--image-ave-pool` mode, on the same batches
        paths[f"{s.key}_eval_ave_pool"] = timed(True)
    return model, batches[0], paths


def phase_parity(torch, dev, s: Model, model_bf16, batch):
    from clipself_tpu_torch.models.factory import create_model

    images = batch["images"]
    model_f32 = create_model(s.model, device=dev, dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        dense_k32 = model_f32.encode_dense(images, keep_shape=True)
        dense_k16 = model_bf16.encode_dense(images, keep_shape=True)
        # the plain path: the same model with the kernels' plain versions
        with plain_path():
            dense_p32 = model_f32.encode_dense(images, keep_shape=True)
    torch.cuda.synchronize()
    f32_abs = (dense_k32 - dense_p32).abs().max().item()
    f32_cos = min_row_cos(dense_k32, dense_p32)
    bf16_abs = (dense_k16.float() - dense_p32).abs().max().item()
    bf16_cos = min_row_cos(dense_k16, dense_p32)
    shape = list(dense_p32.shape)
    print(
        f"{s.key} parity dense map {shape} f32 kernels vs f32 plain: max_abs {f32_abs:.3e} "
        f"min_row_cos {f32_cos:.7f} (bar max_abs {PATH_F32_MAX_ABS})",
        flush=True,
    )
    print(
        f"{s.key} parity dense map {shape} bf16 kernels vs f32 plain: max_abs {bf16_abs:.3e} "
        f"min_row_cos {bf16_cos:.7f} (bar min_row_cos {PATH_BF16_MIN_COS})",
        flush=True,
    )
    for t in (dense_k32, dense_k16, dense_p32):
        if not torch.isfinite(t).all():
            fail("non-finite dense map")
    if not f32_abs <= PATH_F32_MAX_ABS:
        fail(f"{s.key} f32 kernel path off the plain path by {f32_abs}")
    if not bf16_cos >= PATH_BF16_MIN_COS:
        fail(f"{s.key} bf16 kernel path min row cosine {bf16_cos}")
    return model_f32


def phase_train(
    torch, dev, s: Model, logs_dir, recompute=False, *, extra=(), tag=None, batch=TRAIN_BATCH,
    warmup=None, timed=None, profiled=0, expect=None, unlocked=None, group_of=None,
):
    """The distill step through the trainer's entry point: ``warmup``
    steps, ``timed`` steps (the median reported), then ``profiled`` steps
    under the profiler (their kernel ms a step); ``extra`` trainer flags;
    ``expect`` the launch counts (by default the EVA tower's); ``unlocked``
    the lock groups trained (by default every block); ``group_of`` the
    lock group of a trainable parameter's name (by default its block),
    every group of which must move."""
    from clipself_tpu_torch.train import main as train_main
    from clipself_tpu_torch.train.optim import _BLOCK, trainable_labels

    layers = s.vision.layers
    unlocked = layers if unlocked is None else unlocked
    group_of = group_of or (lambda name: _BLOCK.match(name).group(1))
    freeze_bn_stats = "--lock-image-freeze-bn-stats" in extra
    lock_image = "--no-lock-image" not in extra
    if warmup is None:
        warmup = RECOMPUTE_WARMUP if recompute else TRAIN_WARMUP
    if timed is None:
        timed = RECOMPUTE_STEPS if recompute else TRAIN_TIMED
    steps = warmup + timed + profiled
    tag = tag or f"{s.key} train" + (" recompute" if recompute else "")
    argv = [
        "--synthetic", "--model", s.model, "--precision", "bf16", "--device", str(dev),
        "--batch-size", str(batch), "--det-image-size", str(s.image),
        "--max-boxes", str(TRAIN_BOXES), "--lock-image-unlocked-groups", str(unlocked),
        "--steps-per-epoch", str(steps), "--epochs", "1", "--log-every-n-steps", "1",
        "--lr", "1e-5", "--warmup", "1", "--seed", str(SEED),
        "--logs", logs_dir, "--name", tag.replace(" ", "_"),
    ] + (["--grad-checkpointing"] if recompute else []) + list(extra)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    prof = {}
    with profiled_steps(torch, warmup + timed, steps, prof) if profiled else contextlib.nullcontext():
        run = train_main.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    # the median step of the timed window: a step that the host delayed
    # does not move it
    step_ms = [batch / h["images_per_sec"] * 1e3 for h in hist[warmup:warmup + timed]]
    median_ms = statistics.median(step_ms)
    ips = batch / median_ms * 1e3
    print(
        f"{tag} {s.model} distill step: batch {batch} at {s.image}px, {TRAIN_BOXES} boxes, "
        f"crops {s.crop}px, {unlocked} groups unlocked, bf16{''.join(' ' + a for a in extra)}: "
        f"{len(step_ms)} timed steps after {warmup} warm-up, median step {median_ms:.3f} ms, "
        f"{ips:.3f} images/s (ms per step {[round(t, 3) for t in step_ms]}; warm-up "
        f"{[round(batch / h['images_per_sec'] * 1e3, 3) for h in hist[:warmup]]})",
        flush=True,
    )
    if profiled:
        k = prof["kernel_ms"] / profiled
        print(f"{tag} profiled {profiled} steps: kernels {k:.3f} ms a step, window "
              f"{prof['wall_ms'] / profiled:.3f} ms a step; device idle {1 - k / median_ms:.1%} of the "
              f"median unprofiled step", flush=True)
    print(f"{tag} losses {json.dumps([round(x, 6) for x in losses])}", flush=True)
    print(f"{tag} peak memory {peak_gib:.3f} GiB (max_memory_allocated)", flush=True)
    print(f"{tag} launches {json.dumps(launches)}", flush=True)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"{tag} losses {losses}")
    expect = expect(steps) if expect else expected_launches(layers, steps=steps, recompute=recompute)
    if launches != expect:
        fail(f"{tag} launch counts {launches}, expected {expect}")
    student, teacher = run["state"].model, run["teacher"]
    if student.visual.grad_checkpointing != recompute:
        fail(f"{tag}: the student's grad_checkpointing is {student.visual.grad_checkpointing}")
    labels = trainable_labels(
        (n for n, _ in student.named_parameters()), unlocked, layers, lock_image=lock_image,
        freeze_bn_stats=freeze_bn_stats,
    )
    t_params = dict(teacher.named_parameters())
    moved, groups, frozen = set(), set(), 0
    for name, p in student.named_parameters():
        if not torch.isfinite(p).all():
            fail(f"non-finite parameter {name} after training")
        same = torch.equal(p, t_params[name])
        if labels[name] == "freeze":
            frozen += 1
            if not same:
                fail(f"frozen parameter {name} moved")
            continue
        groups.add(group_of(name))
        if not same:
            moved.add(group_of(name))
    if moved != groups:
        fail(f"{tag}: unlocked groups that moved: {sorted(moved)} of {sorted(groups)}")
    print(f"{tag} checks: losses finite, {len(groups)} unlocked groups moved, {frozen} frozen tensors "
          f"unchanged", flush=True)
    del run, student, teacher
    return dict(images_per_sec=ips, losses=losses, peak_gib=peak_gib, launches=launches,
                median_ms=median_ms, kernel_ms=prof["kernel_ms"] / profiled if profiled else None)


def phase_train_parity(torch, dev, s: Model, kernels=None, extract_type="v2", unlocked=None,
                       lock_image=True, prepare=None):
    """One step's loss and trainable gradients from the same weights and
    batch (batch 1) on f32 kernels, bf16 kernels and the f32 plain path;
    the kernel legs must launch every one of ``kernels`` (by default every
    kernel of the EVA tower; an empty list: none, and then none may
    launch); ``unlocked`` lock groups train (by default every block), all
    of the image tower without ``lock_image``; ``prepare(model)`` sets
    weights after the draw (both legs' the same)."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.data.loader import SyntheticDistillData
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import trainable_labels

    cfg = get_model_config(s.model)
    if s.parity_layers is not None:
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=s.parity_layers)
        )
    layers = cfg.vision.layers
    unlocked = layers if unlocked is None else unlocked
    host = SyntheticDistillData(
        batch_size=1, det_size=s.image, crop_size=s.crop, max_anns=TRAIN_BOXES, seed=SEED
    ).batch
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}

    def one_step(dtype, plain):
        model = create_model(cfg, device=dev, dtype=dtype, seed=SEED)
        if prepare is not None:
            prepare(model)
        teacher = copy.deepcopy(model).requires_grad_(False)
        named = list(model.named_parameters())
        labels = trainable_labels((n for n, _ in named), unlocked, layers, lock_image=lock_image)
        for name, p in named:
            p.requires_grad_(labels[name] == "train")
        reset_counts()
        with plain_path() if plain else contextlib.nullcontext():
            loss, _ = clipself_loss(model, teacher, batch, extract_type=extract_type)
            loss.backward()
        # every kernel of the tower, forward and backward (the NMS kernel
        # belongs to the detector)
        wanted = [k for k in read_counts() if k != "nms"] if kernels is None else kernels
        if not plain and not all(read_counts()[k] for k in wanted):
            fail(f"kernel path missed a kernel: {read_counts()}")
        if not wanted and any(read_counts().values()):
            fail(f"a tower that runs no kernel launched one: {read_counts()}")
        grads = {n: p.grad.float() for n, p in named if p.grad is not None}
        out = loss.item()
        del model, teacher, loss
        torch.cuda.empty_cache()
        return out, grads

    loss_p, g_p = one_step(torch.float32, plain=True)
    loss_k, g_k = one_step(torch.float32, plain=False)
    loss_h, g_h = one_step(torch.bfloat16, plain=False)
    if not (g_p.keys() == g_k.keys() == g_h.keys()) or not g_p:
        fail("the three paths produced gradients for different parameters")
    rel, cos = {}, {}
    for name, w in g_p.items():
        rel[name] = (g_k[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        cos[name] = torch.nn.functional.cosine_similarity(
            g_h[name].flatten(), w.flatten(), dim=0
        ).item()
    worst_rel = max(rel, key=rel.get)
    worst_cos = min(cos, key=cos.get)
    print(
        f"{s.key} train parity {s.model}, {layers} of {s.vision.layers} blocks, batch 1, "
        f"{len(g_p)} trainable gradients: loss f32 plain {loss_p:.7f}, f32 kernels {loss_k:.7f} "
        f"(|d| {abs(loss_k - loss_p):.3e}, bar {STEP_LOSS_MAX_ABS}), bf16 kernels {loss_h:.7f}",
        flush=True,
    )
    print(
        f"{s.key} train parity gradients: f32 kernels vs f32 plain max rel {rel[worst_rel]:.3e} "
        f"({worst_rel}; bar {STEP_GRAD_F32_MAX_REL}); bf16 kernels vs f32 plain min cosine "
        f"{cos[worst_cos]:.6f} ({worst_cos}; bar {STEP_GRAD_BF16_MIN_COS})",
        flush=True,
    )
    finite = all(torch.isfinite(g).all().item() for d in (g_p, g_k, g_h) for g in d.values())
    if not finite or not all(map(math.isfinite, (loss_p, loss_k, loss_h))):
        fail("non-finite loss or gradient in train parity")
    if not abs(loss_k - loss_p) <= STEP_LOSS_MAX_ABS:
        fail(f"f32 kernel loss off the plain loss by {abs(loss_k - loss_p)}")
    if not rel[worst_rel] <= STEP_GRAD_F32_MAX_REL:
        fail(f"f32 kernel gradient {worst_rel} off by {rel[worst_rel]} of its max")
    if not cos[worst_cos] >= STEP_GRAD_BF16_MIN_COS:
        fail(f"bf16 kernel gradient {worst_cos} cosine {cos[worst_cos]}")


def phase_parallel(torch, dev, s: Model, logs_dir) -> dict:
    """The distill step through `train.main` on a (1, 1, 1) mesh against the
    same run without a launcher (see 7a above); returns the launches of the
    sharded run."""
    from clipself_tpu_torch.tools.train_repeat import run_once

    layers, w, t = s.vision.layers, PARALLEL_WARMUP, PARALLEL_TIMED
    steps = w + t + PARALLEL_PROFILED
    argv = [
        "--synthetic", "--model", s.model, "--precision", "bf16", "--device", str(dev),
        "--batch-size", str(TRAIN_BATCH), "--det-image-size", str(s.image),
        "--max-boxes", str(TRAIN_BOXES), "--lock-image-unlocked-groups", str(layers),
        "--steps-per-epoch", str(steps), "--epochs", "1", "--log-every-n-steps", "1",
        "--lr", "1e-5", "--warmup", "1", "--seed", str(SEED), "--logs", logs_dir,
    ]

    def one(tag: str, sharded: bool) -> dict:
        t0 = time.perf_counter()
        prof = {}
        reset_counts()
        extra = ["--name", tag] + (["--n-devices", "1"] if sharded else [])
        with profiled_steps(torch, w + t, steps, prof):
            out = run_once(argv + extra, PARALLEL_WEIGHT, sharded)
        torch.cuda.synchronize()
        step_ms = [TRAIN_BATCH / h["images_per_sec"] * 1e3 for h in out["history"][w:w + t]]
        median_ms = statistics.median(step_ms)
        out.update(launches=read_counts(), median_ms=median_ms, images_per_sec=TRAIN_BATCH / median_ms * 1e3,
                   kernel_ms=prof["kernel_ms"] / PARALLEL_PROFILED, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
        return out

    try:
        plain = one("parallel_unwrapped", False)
        sharded = one("parallel_sharded", True)
    finally:
        shutil.rmtree(logs_dir, ignore_errors=True)
    tag = f"{s.key} train sharded"
    for name, r in (("unwrapped", plain), ("sharded (1, 1, 1)", sharded)):
        print(
            f"{tag}: {name} {s.model} distill step, batch {TRAIN_BATCH} at {s.image}px, {TRAIN_BOXES} "
            f"crops at {s.crop}px, bf16: median of {t} timed steps after {w} warm-up {r['median_ms']:.3f} ms, "
            f"{r['images_per_sec']:.3f} images/s; kernels {r['kernel_ms']:.3f} ms a step under the profiler; "
            f"run {r['seconds']:.1f} s; mesh {r['mesh']}, {r['tp_modules']} modules with a tensor-parallel "
            f"group; launches {json.dumps(r['launches'])}",
            flush=True,
        )
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(sharded["losses"], plain["losses"])]
    rel_first, rel_later = rel[0], max(rel[1:])
    rel_g = ((sharded["grad"] - plain["grad"]).abs().max() / plain["grad"].abs().max()).item()
    abs_w = (sharded["after"] - plain["after"]).abs().max().item()
    print(f"{tag}: losses {json.dumps([round(x, 7) for x in sharded['losses']])} against "
          f"{json.dumps([round(x, 7) for x in plain['losses']])}: the first rel {rel_first:.3e}, the first "
          f"step's {PARALLEL_WEIGHT} gradient max rel {rel_g:.3e} (bar {PARALLEL_MAX_REL}); later losses max "
          f"rel {rel_later:.3e} (bar {PARALLEL_LATER_LOSS_MAX_REL}), the weight after {steps} steps max |d| "
          f"{abs_w:.3e} (bar {PARALLEL_WEIGHT_MAX_ABS}); host cost of the wrappers "
          f"{sharded['median_ms'] - plain['median_ms']:+.3f} ms a step at "
          f"{sharded['kernel_ms'] - plain['kernel_ms']:+.3f} ms of kernels", flush=True)
    expect = expected_launches(layers, steps=steps)
    if sharded["mesh"] != (1, 1, 1) or plain["mesh"] is not None:
        fail(f"{tag}: meshes {sharded['mesh']} and {plain['mesh']}, expected (1, 1, 1) and none")
    if not sharded["tp_modules"]:
        fail(f"{tag}: no module carries the tensor-parallel plan")
    if not (len(sharded["losses"]) == len(plain["losses"]) == steps
            and all(map(math.isfinite, sharded["losses"] + plain["losses"]))):
        fail(f"{tag}: losses {sharded['losses']} and {plain['losses']}")
    if not (rel_first <= PARALLEL_MAX_REL and rel_g <= PARALLEL_MAX_REL):
        fail(f"{tag}: the sharded first step is off the unwrapped one: loss {rel_first}, gradient {rel_g}")
    if not (rel_later <= PARALLEL_LATER_LOSS_MAX_REL and abs_w <= PARALLEL_WEIGHT_MAX_ABS):
        fail(f"{tag}: the sharded run drifts from the unwrapped one: losses {rel_later}, weight {abs_w}")
    if not sharded["launches"] == plain["launches"] == expect:
        fail(f"{tag}: launches {sharded['launches']} and {plain['launches']}, expected {expect}")
    return {"b16_train_sharded": sharded["launches"],
            "b16_detector_train_sharded": detector_sharded(torch, dev, logs_dir)}


def detector_sharded(torch, dev, logs_dir) -> dict:
    """`detector.train.main --synthetic` at DET_PRESET (batch 8, bf16) under
    a one-process launch (a (1, 1, 1) `data` mesh over a world-size-1 NCCL
    group, the heads under DistributedDataParallel) beside the same run
    without a launcher; returns the launched run's launches."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.detector import train as det_train
    from clipself_tpu_torch.detector.config import PRESETS
    from clipself_tpu_torch.tools.train_repeat import one_process_launch

    cfg = PRESETS[DET_PRESET]
    w, t = PARALLEL_DET_WARMUP, PARALLEL_DET_TIMED
    argv = [
        "--synthetic", "--preset", DET_PRESET, "--device", str(dev), "--batch-size", str(DET_BATCH),
        "--epochs", "1", "--steps-per-epoch", str(w + t), "--log-every", "1", "--seed", str(SEED),
    ]

    def one(tag: str, sharded: bool) -> dict:
        t0 = time.perf_counter()
        reset_counts()
        try:
            with one_process_launch() if sharded else contextlib.nullcontext():
                run = det_train.main(argv + ["--output", os.path.join(logs_dir, tag)])
            torch.cuda.synchronize()
            launches = read_counts()
        finally:
            shutil.rmtree(logs_dir, ignore_errors=True)
        hist = run["history"]
        out = {
            "losses": [h["metrics"]["loss"] for h in hist], "mesh": run["mesh"], "launches": launches,
            "median_ms": statistics.median(h["step_ms"] for h in hist[w:]),
            "heads": {k: v.detach().clone() for k, v in run["state"].model.state_dict().items()},
            "seconds": time.perf_counter() - t0,
        }
        del run
        torch.cuda.empty_cache()
        return out

    plain = one("detector_unwrapped", False)
    sharded = one("detector_sharded", True)
    tag = f"b16 detector train sharded {DET_PRESET}"
    for name, r in (("unwrapped", plain), ("sharded (1, 1, 1)", sharded)):
        print(f"{tag}: {name} batch {DET_BATCH}, bf16: median of {t} timed steps after {w} warm-up "
              f"{r['median_ms']:.3f} ms, {DET_BATCH / r['median_ms'] * 1e3:.3f} images/s; run "
              f"{r['seconds']:.1f} s; mesh {r['mesh']}; launches {json.dumps(r['launches'])}", flush=True)
    heads_equal = plain["heads"].keys() == sharded["heads"].keys() and all(
        torch.equal(v, sharded["heads"][k]) for k, v in plain["heads"].items()
    )
    print(f"{tag}: losses {json.dumps(sharded['losses'])} against {json.dumps(plain['losses'])}: "
          f"{'EQUAL' if sharded['losses'] == plain['losses'] else 'DIFFER'}; heads after {w + t} steps "
          f"{'EQUAL' if heads_equal else 'DIFFER'}", flush=True)
    if sharded["mesh"] != (1, 1, 1) or plain["mesh"] is not None:
        fail(f"{tag}: meshes {sharded['mesh']} and {plain['mesh']}, expected (1, 1, 1) and none")
    if not (len(plain["losses"]) == w + t and all(map(math.isfinite, plain["losses"]))):
        fail(f"{tag}: losses {plain['losses']}")
    if sharded["losses"] != plain["losses"] or not heads_equal:
        fail(f"{tag}: the launched run is off the unwrapped one")
    expect = expected_launches(get_model_config(cfg.clip_model).vision.layers, det_steps=w + t)
    if not sharded["launches"] == plain["launches"] == expect:
        fail(f"{tag}: launches {sharded['launches']} and {plain['launches']}, expected {expect}")
    return sharded["launches"]


def phase_text(torch, dev, s: Model, model, model_f32) -> dict:
    """The text tower's main path: `tools/text_embeddings.py::build_text_embeddings`
    over the OV-COCO classes and a background row, on
    the evaluator's bf16 model (seeded random weights); then its parity
    against the plain float32 path of the parity phase's float32 model (the
    same weights). Returns the launch counts of the timed run."""
    import importlib.util

    import numpy as np

    from clipself_tpu_torch.detector.classes import coco_split
    from clipself_tpu_torch.models.factory import get_tokenizer
    from clipself_tpu_torch.tools.text_embeddings import build_text_embeddings, category_prompts

    t = s.text
    lists = {"coco": coco_split()["all"] + ["background"]}
    build_text_embeddings(model, lists["coco"][:TEXT_WARMUP_CLASSES])  # warm-up
    torch.cuda.synchronize()
    # the float32 model of the parity phase is resident too: the phase's own
    # peak is the peak less what else was allocated
    others = (torch.cuda.memory_allocated() - sum(p.numel() * p.element_size() for p in model.parameters())) / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    mats = {k: build_text_embeddings(model, names, timings=timings) for k, names in lists.items()}
    dt = time.perf_counter() - t0  # the matrices are on the host: the device is done
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 - others
    per_class = [len(category_prompts(c)) for names in lists.values() for c in names]
    calls = sum(-(-n // TEXT_BATCH) for n in per_class)
    tok = timings["tokenize"]
    print(
        f"{s.key} text {s.model} text tower (width {t.width}, {t.heads} heads, {t.layers} blocks, "
        f"{t.context_length} tokens), bf16: {len(per_class)} classes ({', '.join(f'{k} {len(v)}' for k, v in lists.items())}), "
        f"{sum(per_class)} prompts in {calls} calls: {dt:.3f} s, {sum(per_class) / dt:.1f} prompts/s; "
        f"of it tokenizing on the host {tok:.3f} s, the rest (encoding, launches, copies) "
        f"{dt - tok:.3f} s, {sum(per_class) / (dt - tok):.1f} prompts/s; peak {peak:.3f} GiB (the "
        f"model's float32 weights and the work; {others:.3f} GiB of other resident tensors left out)",
        flush=True,
    )
    print(f"{s.key} text launches {json.dumps(launches)}", flush=True)
    for k, m in mats.items():
        n = len(m)
        gram = m @ m.T
        off = (gram.sum() - np.trace(gram)) / (n * (n - 1))
        print(
            f"{s.key} text class matrix {k}: shape {list(m.shape)}, row norms "
            f"{np.linalg.norm(m, axis=-1).min():.6f}-{np.linalg.norm(m, axis=-1).max():.6f}, mean "
            f"off-diagonal cosine {off:.6f} (seeded random weights)",
            flush=True,
        )
        if m.shape != (n, model.cfg.embed_dim) or not np.isfinite(m).all():
            fail(f"{s.key} text class matrix {k}: shape {m.shape} or not finite")
        if not np.allclose(np.linalg.norm(m, axis=-1), 1.0, atol=1e-3):
            fail(f"{s.key} text class matrix {k}: rows not unit norm")
    expect = expected_launches(0, text_calls=calls, text_layers=t.layers)
    if launches != expect:
        fail(f"{s.key} text launch counts {launches}, expected {expect}")
    if s.key == "b16":
        found = importlib.util.find_spec("regex") is not None
        print(f"text: the `regex` package is {'' if found else 'not '}installed here "
              "(for information: the port's tokenizer never imports it)", flush=True)

    # parity: one batch of 64 prompts and the OV-COCO matrix, bf16 and f32
    # kernels against the plain float32 path (the plain LayerNorm)
    prompts = [p for c in lists["coco"][:2] for p in category_prompts(c)][:TEXT_BATCH]
    tokens = torch.as_tensor(get_tokenizer(model.cfg)(prompts), device=dev)
    with torch.inference_mode():
        reset_counts()
        k32 = model_f32.encode_text(tokens, normalize=True)
        if read_counts()["layer_norm"] != 2 * t.layers + 1:
            fail(f"{s.key} text: a forward launched {read_counts()} kernels")
        k16 = model.encode_text(tokens, normalize=True)
        with plain_path():
            p32 = model_f32.encode_text(tokens, normalize=True)
    m32 = build_text_embeddings(model_f32, lists["coco"])
    with plain_path():
        mp32 = build_text_embeddings(model_f32, lists["coco"])
    mats16 = torch.as_tensor(mats["coco"])
    for what, (got32, got16, want) in (
        (f"batch of {TEXT_BATCH} prompts", (k32, k16, p32)),
        (f"class matrix coco {list(mats['coco'].shape)}",
         (torch.as_tensor(m32), mats16, torch.as_tensor(mp32))),
    ):
        f32_abs = (got32.float() - want.float()).abs().max().item()
        bf16_cos = min_row_cos(got16, want)
        print(
            f"{s.key} text parity {what}: f32 kernels vs f32 plain max_abs {f32_abs:.3e} (bar "
            f"{PATH_F32_MAX_ABS}); bf16 kernels vs f32 plain min_row_cos {bf16_cos:.7f} (bar "
            f"{PATH_BF16_MIN_COS})",
            flush=True,
        )
        if not f32_abs <= PATH_F32_MAX_ABS:
            fail(f"{s.key} text {what}: f32 kernel path off the plain path by {f32_abs}")
        if not bf16_cos >= PATH_BF16_MIN_COS:
            fail(f"{s.key} text {what}: bf16 kernel path min row cosine {bf16_cos}")
    return launches


def phase_model(torch, dev, s: Model, logs_dir) -> tuple[dict, dict]:
    """Phases 3 to 7 for one model; returns the launch counts by main path
    and the synthetic train run's numbers."""
    model_bf16, batch0, paths = phase_eval(torch, dev, s)
    model_f32 = phase_parity(torch, dev, s, model_bf16, batch0)
    paths[f"{s.key}_text"] = phase_text(torch, dev, s, model_bf16, model_f32)
    del model_bf16, model_f32, batch0
    torch.cuda.empty_cache()
    try:
        l14 = s.key == "l14"
        train = phase_train(torch, dev, s, logs_dir, warmup=L14_TRAIN_WARMUP if l14 else None,
                            timed=L14_TRAIN_TIMED if l14 else None)
        paths[f"{s.key}_train"] = train["launches"]
        torch.cuda.empty_cache()
        if s.key == "l14":
            again = phase_train(torch, dev, s, logs_dir, recompute=True)
            paths[f"{s.key}_train_recompute"] = again["launches"]
            delta = abs(again["losses"][0] - train["losses"][0])
            print(
                f"{s.key} train recompute vs not: first loss |d| {delta:.3e} (bar "
                f"{RECOMPUTE_LOSS_MAX_ABS}), peak memory {again['peak_gib']:.3f} GiB vs "
                f"{train['peak_gib']:.3f} GiB, images/s of the median step "
                f"{again['images_per_sec']:.3f} vs {train['images_per_sec']:.3f}",
                flush=True,
            )
            if not delta <= RECOMPUTE_LOSS_MAX_ABS:
                fail(f"{s.key}: the recomputing run's first loss is off by {delta}")
    finally:
        shutil.rmtree(logs_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_train_parity(torch, dev, s)
    torch.cuda.empty_cache()
    return paths, train


def vit_expected_launches(
    layers: int, *, evals=0, evals_v1=0, steps=0, steps_v1=0, tower_norms=2
) -> dict:
    """Launches of the OpenCLIP ViT's paths: ``evals`` evaluator batches at
    extract type v2, ``evals_v1`` at v1, ``steps`` distill steps at v2 and
    ``steps_v1`` at v1, for a tower of ``layers`` blocks. A pass has 2
    LayerNorms a block plus ``tower_norms``: `ln_pre` and `ln_post` (the
    EVA01 tower, whose blocks have no sub-LN either, has its final `norm`
    alone, and no RoPE: its counts are these with ``tower_norms`` 1). A dense pass (v2) runs
    layers - 1 flash blocks (the last takes the value path), a crop pass all
    of them; a mask-attention pass (v1) none: every block takes the additive
    mask, plain attention. A v2 batch is a dense and a crop pass; a v1 batch
    two mask-attention passes (RoIs, masks) and a crop pass. A step is the
    teacher's crop pass and the student's pass, whose backward runs the flash
    backward on its flash blocks and the LayerNorm backward on every block's
    two norms and `ln_post` (`ln_pre`'s input and weights are frozen). No
    RoPE (the tower has none), no NMS."""
    norms, dense, crop = 2 * layers + tower_norms, layers - 1, layers
    students = steps + steps_v1
    return {
        "nms": 0,
        "flash_attention": evals * (dense + crop) + evals_v1 * crop + students * crop + steps * dense,
        "flash_attention_bwd": steps * dense,
        "rope_roll": 0,
        "rope_roll_bwd": 0,
        "layer_norm": (2 * evals + 3 * evals_v1 + 2 * students) * norms,
        "layer_norm_bwd": students * (2 * layers + 1),
    }


def masked_attention_row(torch, dev, s: Model, model, images, boxes) -> None:
    """The v1 path's attention, a plain op (`attention_masked`: the JAX
    package runs XLA there, no Pallas kernel): one block's call at the
    evaluator's shape in bf16, its CUDA-event time beside
    `scaled_dot_product_attention` with the same float mask (a yardstick) and
    the card's bound for the same products."""
    from clipself_tpu_torch.ops.attention import attention_masked

    gh = s.grid(s.image)
    masks = model.visual.boxes_to_grid_masks(boxes, gh, gh)
    mask = model.visual.attention_mask(masks)
    b, n = mask.shape[0], mask.shape[-1]
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    q, k, v = (torch.randn((b, n, s.heads, s.vision.head_width), generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    scale = s.vision.head_width ** -0.5
    lib_mask = mask.to(q.dtype)  # the library takes a float mask in the query's dtype
    with torch.inference_mode():
        ms = cuda_ms(lambda: attention_masked(q, k, v, scale, mask), iters=5, warmup=1)
        lib = cuda_ms(lambda: sdpa(torch, q, k, v, scale, lib_mask), iters=5, warmup=1)
        err = (attention_masked(q, k, v, scale, mask).float()
               - sdpa(torch, q, k, v, scale, lib_mask).float()).abs().max().item()
    flops = 4 * b * s.heads * n * n * s.vision.head_width
    bound = max(nbytes(q, k, v, q) / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS) * 1e3
    print(f"{s.key} plain masked attention (v1) [{b},{n},{s.heads},{s.vision.head_width}] bf16 with a "
          f"[{b},1,{n},{n}] float32 mask: {ms:.4f} ms a call, library (scaled_dot_product_attention, "
          f"the mask in bf16) {lib:.4f} ms, bound {bound:.4f} ms (operations); max_abs against the library "
          f"{err:.3e}; {s.vision.layers} calls a pass, two passes a v1 batch", flush=True)


def vit_eval(torch, dev, s: Model) -> dict:
    """The OpenCLIP ViT through `evaluate_zero_shot` (bf16, seeded random
    weights): v2 over `N_BATCHES` (B/16) or `VIT_L14_BATCHES` (L/14) after
    `EVAL_WARMUP`, at B/16 v1 (mask-attention pooling) over
    `VIT_V1_BATCHES` and one v3 call; each with ms a batch, images/s, peak
    memory, the kernels' ms a batch over `VIT_PROFILED` batches under the
    profiler and the launch counts. Then parity against the plain float32
    path: the dense map and the v1 pooled features. Returns the launch
    counts by path."""
    import numpy as np

    from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.models.factory import create_model

    model = create_model(s.model, device=dev, dtype=torch.bfloat16, seed=SEED)
    layers = s.vision.layers

    def batch(i):
        host = synthetic_panoptic_batch(
            i, batch=s.eval_batch, image_size=s.image, max_anns=MAX_ANNS, valid_anns=VALID_ANNS,
            crop_size=s.crop, mask_hw=s.grid(s.image), n_classes=N_CLASSES, seed=SEED,
        )
        return {k: (v if k == "boxes" else torch.as_tensor(v, device=dev)) for k, v in host.items()}

    emb = class_embeddings(N_CLASSES, model.cfg.embed_dim, seed=SEED)
    b16 = s.key == "vit_b16"
    modes = [("v2", N_BATCHES if b16 else VIT_L14_BATCHES)] + ([("v1", VIT_V1_BATCHES)] if b16 else [])
    paths = {}
    batches = []
    for et, n in modes:
        tag = f"{s.key} eval {et}"
        warm = [batch(N_BATCHES + i) for i in range(EVAL_WARMUP)]
        batches = [batch(i) for i in range(n)]
        run = lambda bs: evaluate_zero_shot(  # noqa: E731
            model, bs, emb, device=dev, ann_bucket=BUCKET, extract_type=et
        )
        run(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = run(batches)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run(batches[:VIT_PROFILED])
            torch.cuda.synchronize()
        k = kernel_ms(torch, prof) / VIT_PROFILED
        ms = dt / n * 1e3
        print(
            f"{tag} {s.model} zero-shot: {n} batches x {s.eval_batch} images {s.image}px, "
            f"{VALID_ANNS} valid of {MAX_ANNS} anns (bucket {BUCKET}), crops {s.crop}px, {layers} "
            f"blocks, extract type {et}: {ms:.3f} ms a batch after {EVAL_WARMUP} warm-up batches, "
            f"{s.eval_batch * n / dt:.3f} images/s, peak {peak:.3f} GiB; kernels {k:.3f} ms a batch "
            f"({VIT_PROFILED} profiled), device idle {1 - k / ms:.1%}",
            flush=True,
        )
        print(f"{tag} mAcc " + json.dumps(res, sort_keys=True), flush=True)
        print(f"{tag} launches " + json.dumps(launches), flush=True)
        if len(res) != 12 or not all(np.isfinite(v) for v in res.values()):
            fail(f"{tag}: evaluator result not finite: {res}")
        expect = vit_expected_launches(layers, **({"evals_v1": n} if et == "v1" else {"evals": n}))
        if launches != expect:
            fail(f"{tag} launch counts {launches}, expected {expect}")
        paths[f"{s.key}_eval" + ("_v1" if et == "v1" else "")] = launches
    images = batches[0]["images"]
    boxes = torch.as_tensor(batches[0]["boxes"][:, :BUCKET, :4], device=dev)
    if b16:
        with torch.inference_mode():
            v1_ref = model.encode_pseudo_boxes(images, boxes, extract_type="v1")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v1, v2 = model.visual.extract_roi_features(images, boxes, "v3")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            v2_ref = model.encode_pseudo_boxes(images, boxes, extract_type="v2")
        c1 = min_row_cos(v1, v1_ref)
        print(f"{s.key} v3 {s.model}: one call on {list(boxes.shape[:2])} boxes {ms:.3f} ms; its v1 "
              f"half against a v1 call min_row_cos {c1:.7f} (the same operations; bar 0.99999); its "
              f"v2 half against a v2 call (the value path of the masked trunk against the dense "
              f"trunk's) min_row_cos {min_row_cos(v2, v2_ref):.6f}", flush=True)
        if v1.shape != v2.shape or not (torch.isfinite(v1).all() and torch.isfinite(v2).all()) or not c1 >= 0.99999:
            fail(f"{s.key} v3: shapes {tuple(v1.shape)} {tuple(v2.shape)}, v1 half cosine {c1}")

        masked_attention_row(torch, dev, s, model, images, boxes)

    # parity: the dense map and the v1 pooled features against the plain f32 path
    model_f32 = create_model(s.model, device=dev, dtype=torch.float32, seed=SEED)
    with torch.inference_mode():
        got = {}
        for what, fn in (
            ("dense map", lambda m: m.encode_dense(images, keep_shape=True)),
            ("v1 pooled features", lambda m: m.encode_pseudo_boxes(images, boxes, extract_type="v1")),
        ):
            k32, k16 = fn(model_f32), fn(model)
            with plain_path():
                p32 = fn(model_f32)
            got[what] = (k32, k16, p32)
    torch.cuda.synchronize()
    for what, (k32, k16, p32) in got.items():
        f32_abs = (k32 - p32).abs().max().item()
        bf16_cos = min_row_cos(k16, p32)
        print(
            f"{s.key} parity {what} {list(p32.shape)}: f32 kernels vs f32 plain max_abs {f32_abs:.3e} "
            f"(bar {PATH_F32_MAX_ABS}); bf16 kernels vs f32 plain min_row_cos {bf16_cos:.7f} "
            f"(bar {PATH_BF16_MIN_COS})",
            flush=True,
        )
        if not all(torch.isfinite(t).all() for t in (k32, k16, p32)):
            fail(f"{s.key} {what}: not finite")
        if not f32_abs <= PATH_F32_MAX_ABS:
            fail(f"{s.key} {what}: f32 kernel path off the plain path by {f32_abs}")
        if not bf16_cos >= PATH_BF16_MIN_COS:
            fail(f"{s.key} {what}: bf16 kernel path min row cosine {bf16_cos}")
    del model, model_f32, got
    torch.cuda.empty_cache()
    return paths


def phase_open_clip_vit(torch, dev, logs_dir) -> dict:
    """The plain OpenCLIP / OpenAI ViT tower: `vit_eval` of ViT-B-16 at
    1024^2 and ViT-L-14-336 at 896^2; then ViT-B-16 through the trainer
    (`--force-quick-gelu`, batch 2, 20 boxes, every block unlocked: 3 + 5
    steps and `VIT_PROFILED` under the profiler), one `--extract-type v1`
    run of 2 steps at batch 2 (peak memory) and one step's parity at batch
    1. Returns the launch counts by path."""
    t0 = time.perf_counter()
    paths = {}
    for s in VIT_MODELS:
        paths.update(vit_eval(torch, dev, s))
    s = VIT_MODELS[0]
    layers = s.vision.layers
    try:
        train = phase_train(
            torch, dev, s, logs_dir, extra=["--force-quick-gelu"], tag=f"{s.key} train",
            profiled=VIT_PROFILED, expect=lambda n: vit_expected_launches(layers, steps=n),
        )
        paths[f"{s.key}_train"] = train["launches"]
        torch.cuda.empty_cache()
        v1 = phase_train(
            torch, dev, s, logs_dir, extra=["--extract-type", "v1"], tag=f"{s.key} train v1",
            warmup=1, timed=1, expect=lambda n: vit_expected_launches(layers, steps_v1=n),
        )
        paths[f"{s.key}_train_v1"] = v1["launches"]
    finally:
        shutil.rmtree(logs_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_train_parity(
        torch, dev, s, kernels=["flash_attention", "flash_attention_bwd", "layer_norm", "layer_norm_bwd"]
    )
    torch.cuda.empty_cache()
    print(f"open_clip_vit phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def vit_tp_steps(torch, dev, dtype, steps: int, profile_from=None, mesh_shape=None, weights=None) -> dict:
    """``steps`` distill steps of ViT-B-16 at the B/16 recipe's shapes (batch
    2 at 1024^2, 20 crops at 224^2, every block unlocked, extract type v2) in
    ``dtype`` on the seeded weights (or on ``weights``, their state dict), in
    one process or, with ``mesh_shape``, on this rank of that mesh: the
    losses, the first step's gradient of `TP_WEIGHT` (gathered whole, on the
    host), the launches of the run, and from step ``profile_from`` on, under
    the profiler, the ms a step and the kernels' ms a step."""
    from functools import partial

    from clipself_tpu_torch.data.loader import SyntheticDistillData
    from clipself_tpu_torch.models.factory import create_model, model_class
    from clipself_tpu_torch.parallel.mesh import create_mesh, full_leaf, shard_batch, shard_model
    from clipself_tpu_torch.train.methods import clipself_loss
    from clipself_tpu_torch.train.optim import Optimizer, make_schedule, set_trainable
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    s = VIT_MODELS[0]
    cfg = s.vision
    layers = cfg.layers
    if weights is None:
        model = create_model(s.model, device=dev, dtype=dtype, seed=SEED)
    else:
        from clipself_tpu_torch.core.config import get_model_config

        full = get_model_config(s.model)
        model = model_class(full)(full, dtype)
        model.load_state_dict(weights)
        model = model.to(dev)
    teacher = copy.deepcopy(model).requires_grad_(False)
    host = SyntheticDistillData(TRAIN_BATCH, s.image, s.crop, TRAIN_BOXES).batch
    set_trainable(model, layers, layers)
    mesh = None
    if mesh_shape is not None:
        mesh = create_mesh(mesh_shape, dev)
        for m in (model, teacher):
            shard_model(m, mesh)
        host = shard_batch(mesh, host)
    opt = Optimizer(model, make_schedule("const", 1e-5, 0, steps), unlocked_groups=layers,
                    num_layers=layers, mesh=mesh)
    grads, update = [], opt.step

    def step_after_reading_the_gradient(count):
        if not grads:
            g = dict(zip(opt.names, opt.params))[TP_WEIGHT].grad
            grads.append((g if mesh is None else full_leaf(TP_WEIGHT, g, mesh)).float().cpu().numpy().copy())
        update(count)

    opt.step = step_after_reading_the_gradient
    step = make_train_step(partial(clipself_loss, group=None if mesh is None else mesh.batch_group), teacher,
                           mesh=mesh)
    state = TrainState(model, opt)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    reset_counts()
    losses, out = [], {}
    for i in range(steps):
        if i == profile_from:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            t0 = time.perf_counter()
        losses.append(float(step(state, batch)["loss"]))
    torch.cuda.synchronize()
    if profile_from is not None:
        timed = steps - profile_from
        out["step_ms"] = (time.perf_counter() - t0) * 1e3 / timed
        prof.stop()
        out["kernel_ms"] = kernel_ms(torch, prof) / timed
        out["top"] = top_kernels(torch, prof)
    out.update(losses=losses, grad=grads[0], launches=read_counts())
    return out


def pipeline_expected_launches(blocks: int, ticks: int) -> dict:
    """A stage's launches in one forward and backward of the pipeline: each
    of its ``blocks`` EVA02 blocks on each of the ``ticks`` microbatch ticks
    it computes (a bubble tick skips them) launches one flash forward and one
    flash backward, one RoPE launch each way (q and k together) and four
    LayerNorms each way (`norm1`, `norm2` and the two sub-LNs). No NMS."""
    n = blocks * ticks
    return {"nms": 0, "flash_attention": n, "flash_attention_bwd": n, "rope_roll": n, "rope_roll_bwd": n,
            "layer_norm": 4 * n, "layer_norm_bwd": 4 * n}


def eva_block_fn(torch, dev, s: Model):
    """(one block's {name: tensor}, x) -> x: an EVA block of ``s``'s tower at
    its image size, called with the given tensors (`torch.func.functional_call`)."""
    from torch.func import functional_call

    from clipself_tpu_torch.models.eva_vit import EvaBlock

    block = EvaBlock(s.vision).to(dev)
    grid = (s.grid(s.image), s.grid(s.image))
    return lambda blk, x: functional_call(block, blk, (x, grid))


def pipeline_inputs(torch, dev) -> tuple:
    """The pipeline's float32 tokens [PP_BATCH, 4097, 768] and the ring's
    float32 q, k, v [RING_SHAPE], drawn on the card from seeded CUDA
    generators (the same values in every process)."""
    s = MODELS[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((PP_BATCH, s.tokens(s.image), s.vision.width), generator=gen, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    return x, [torch.randn(RING_SHAPE, generator=gen, device=dev) for _ in range(3)]


def pipeline_ring_rank(torch, dev, eva_blocks: dict) -> dict:
    """This rank's runs of the pipeline (`parallel/pipeline.py`) over a `pp`
    group of the two ranks, EVA02-CLIP-B/16's blocks ``eva_blocks``
    ({name: [12, ...]}) cut to its stage, and of ring attention
    (`ops/ring_attention.py`) over an `sp` group of the two, each in float32
    then bf16: one forward and backward of a sum-of-squares loss (the
    output, the float32 gradients on the host, the launches, whether every
    gradient is finite), then one under the profiler (ms and kernel ms)."""
    import torch.distributed as dist

    from clipself_tpu_torch.ops.ring_attention import ring_attention, sequence_shard
    from clipself_tpu_torch.parallel.pipeline import pipeline_apply, stage_params

    pp, sp = dist.new_group([0, 1]), dist.new_group([0, 1])
    stacked = {k: v.to(dev) for k, v in eva_blocks.items()}
    block = eva_block_fn(torch, dev, MODELS[0])
    x, qkv = pipeline_inputs(torch, dev)
    scale = RING_SHAPE[-1] ** -0.5
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def pipeline(dtype):
        st = {k: v.clone().requires_grad_() for k, v in stage_params(stacked, pp).items()}
        y = pipeline_apply(st, block, x.to(dtype), PP_MICROBATCHES, pp)
        y.float().square().sum().backward()
        return y, st

    def ring(dtype):
        shards = dict(zip("qkv", (sequence_shard(t.to(dtype), sp).clone().requires_grad_() for t in qkv)))
        y = ring_attention(*shards.values(), scale, sp)
        y.float().square().sum().backward()
        return y, shards

    out = {}
    for prec, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for name, fn in (("pipeline", pipeline), ("ring", ring)):
            torch.cuda.synchronize()
            reset_counts()
            y, leaves = fn(dtype)
            torch.cuda.synchronize()
            r = {"launches": read_counts(), "out": y.detach().float().cpu().numpy(),
                 "finite": all(bool(t.grad.isfinite().all()) for t in leaves.values())}
            if prec == "f32":
                r["grads"] = {k: t.grad.cpu().numpy() for k, t in leaves.items()}
            del y, leaves
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            t0 = time.perf_counter()
            fn(dtype)
            torch.cuda.synchronize()
            r["ms"] = (time.perf_counter() - t0) * 1e3
            prof.stop()
            r["kernel_ms"], r["top"] = kernel_ms(torch, prof), top_kernels(torch, prof)
            out[name, prec] = r
    return out


def pipeline_ring_refs(torch, dev, eva_blocks: dict) -> dict:
    """The one-process references of `pipeline_ring_rank`, float32 on the
    card: the 12 blocks in turn on the whole batch and the plain full
    attention (`attention_plain`), each output and its sum-of-squares
    gradients, on the host."""
    from clipself_tpu_torch.ops.attention import attention_plain

    s = MODELS[0]
    block = eva_block_fn(torch, dev, s)
    x, qkv = pipeline_inputs(torch, dev)
    whole = {k: v.to(dev).requires_grad_() for k, v in eva_blocks.items()}
    for i in range(s.vision.layers):
        x = block({k: v[i] for k, v in whole.items()}, x)
    x.square().sum().backward()
    ref = {"pipeline": x.detach().cpu().numpy(), "pipeline_grads": {k: v.grad.cpu().numpy() for k, v in whole.items()}}
    qkv = dict(zip("qkv", (t.requires_grad_() for t in qkv)))
    y = attention_plain(*qkv.values(), RING_SHAPE[-1] ** -0.5)
    y.square().sum().backward()
    ref["ring"] = y.detach().cpu().numpy()
    ref["ring_grads"] = {k: t.grad.cpu().numpy() for k, t in qkv.items()}
    return ref


def check_pipeline_ring(torch, ref: dict, got: dict) -> dict:
    """Each rank's pipeline and ring runs (`pipeline_ring_rank`) against the
    one-process references at the bars; prints every run's numbers with the
    card's name and power limit. Returns rank 0's bf16 launches of each
    (`b16_pipeline_pp2`, `ring_sp2`)."""
    import numpy as np

    s, where = MODELS[0], card()
    per, rows = s.vision.layers // PP_STAGES, RING_SHAPE[1] // 2
    checks = {  # tag, launches expected, rank's share of a reference, bars (f32 output, f32 gradients, bf16 cosine)
        "pipeline": (f"{s.key} pipeline pp2", pipeline_expected_launches(per, PP_MICROBATCHES),
                     lambda t, rank: t[rank * per:(rank + 1) * per], (PP_OUT_MAX_REL, PP_GRAD_MAX_REL, PP_BF16_MIN_COS)),
        "ring": ("ring sp2", dict.fromkeys(_counters(), 0), lambda t, rank: t[:, rank * rows:(rank + 1) * rows],
                 (RING_MAX_REL, RING_MAX_REL, RING_BF16_MIN_COS)),
    }

    def rel(a, b) -> float:
        return float(np.abs(a - b).max() / np.abs(b).max())

    for name, (tag, expect, share, (out_bar, grad_bar, cos_bar)) in checks.items():
        for prec in ("f32", "bf16"):
            for rank in (0, 1):
                r = got[rank][name, prec]
                # the pipeline's output is whole on every rank; the ring's is the rank's rows
                out_ref = ref[name] if name == "pipeline" else share(ref[name], rank)
                line = f"{tag}: {prec} rank {rank}"
                if prec == "f32":
                    want = {k: share(g, rank) for k, g in ref[f"{name}_grads"].items()}
                    out_rel = rel(r["out"], out_ref)
                    grad_rel = max(rel(r["grads"][k], w) for k, w in want.items())
                    line += (f" output max rel {out_rel:.3e} (bar {out_bar}), gradients of {len(want)} tensors "
                             f"max rel {grad_rel:.3e} (bar {grad_bar})")
                    if r["grads"].keys() != want.keys() or not (out_rel <= out_bar and grad_rel <= grad_bar):
                        fail(f"{tag}: f32 rank {rank} output rel {out_rel}, gradients rel {grad_rel} (bars "
                             f"{out_bar}, {grad_bar}), tensors {sorted(r['grads'])}")
                else:
                    cos = min_row_cos(torch.from_numpy(r["out"]), torch.from_numpy(out_ref))
                    line += f" output min row cosine against float32 {cos:.7f} (bar {cos_bar})"
                    if not cos >= cos_bar:
                        fail(f"{tag}: bf16 rank {rank} output min row cosine {cos} (bar {cos_bar})")
                print(f"{line}; gradients finite {r['finite']}; launches {json.dumps(r['launches'])} (expected "
                      f"{json.dumps(expect)}); forward + backward under the profiler {r['ms']:.3f} ms, "
                      f"kernels {r['kernel_ms']:.3f} ms ({r['top']}); {where}", flush=True)
                if not r["finite"]:
                    fail(f"{tag}: {prec} rank {rank} gradients not finite")
                if r["launches"] != expect:
                    fail(f"{tag}: {prec} rank {rank} launches {r['launches']}, expected {expect}")
    return {"b16_pipeline_pp2": got[0]["pipeline", "bf16"]["launches"], "ring_sp2": got[0]["ring", "bf16"]["launches"]}


def vit_tp_rank(rank: int, port: int, path: str, queue) -> None:
    """One of the two ranks of `phase_vit_tp` (a spawned process on card 0):
    its float32 and bf16 runs of `vit_tp_steps` on `TP_MESH` over gloo, then
    the pipeline and the ring (`pipeline_ring_rank`), on the weights the
    script drew, read from ``path`` (a host draw in each rank took
    seconds)."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2)
        saved = torch.load(path, map_location="cpu")
        out = {
            "f32": vit_tp_steps(torch, dev, torch.float32, TP_F32_STEPS, mesh_shape=TP_MESH, weights=saved["vit"]),
            "bf16": vit_tp_steps(torch, dev, torch.bfloat16, TP_WARMUP + TP_TIMED, TP_WARMUP, TP_MESH,
                                 saved["vit"]),
        }
        del saved["vit"]
        torch.cuda.empty_cache()
        out["pipeline_ring"] = pipeline_ring_rank(torch, dev, saved["eva_blocks"])
        queue.put((rank, out))
    except Exception:  # handed to the script's process, which fails with it
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_vit_tp(torch, dev) -> dict:
    """ViT-B-16's distill step at tensor parallelism 2 (`vit_tp_steps`): the
    one-process runs, then two spawned ranks on the one card over gloo with
    CUDA tensors (a (1, 1, 2) mesh: each rank holds 6 of the 12 heads and
    half of each MLP); float32: the first loss and gradient against one
    process; bf16: the losses, the first gradient's cosine against the
    one-process bf16 and float32 gradients (each row's printed), step ms and
    kernel ms; every rank's launches equal to the one-process run's. Then
    the pipeline and the ring in the same ranks (`pipeline_ring_rank`),
    their references computed here while the ranks boot
    (`pipeline_ring_refs`, `check_pipeline_ring`). Returns the launches of
    rank 0's bf16 runs (`vitb16_train_tp2`, `b16_pipeline_pp2`, `ring_sp2`)."""
    import socket

    import torch.multiprocessing as mp

    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.parallel.pipeline import stack_block_params

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    single = {
        "f32": vit_tp_steps(torch, dev, torch.float32, TP_F32_STEPS),
        "bf16": vit_tp_steps(torch, dev, torch.bfloat16, TP_WARMUP + TP_TIMED, TP_WARMUP),
    }
    torch.cuda.empty_cache()
    s = VIT_MODELS[0]
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    path = os.path.join(root, "weights.pt")
    eva = create_model(MODELS[0].model, device="cpu", dtype=torch.float32, seed=SEED)
    eva_blocks, _ = stack_block_params(eva.visual.state_dict())
    del eva
    torch.save({"vit": create_model(s.model, device="cpu", dtype=torch.float32, seed=SEED).state_dict(),
                "eva_blocks": eva_blocks}, path)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=vit_tp_rank, args=(r, port, path, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        # the pipeline's and the ring's references while the ranks boot
        ref = pipeline_ring_refs(torch, dev, eva_blocks)
        del eva_blocks
        torch.cuda.empty_cache()
        got = dict(queue.get(timeout=600) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    errors = [v for v in got.values() if isinstance(v, str)]
    if errors:
        fail(f"vit_b16 train tp2: a rank failed:\n{errors[0]}")
    tag = f"{s.key} train tp2"
    expect = vit_expected_launches(s.vision.layers, steps=TP_WARMUP + TP_TIMED)

    def cosines(a, b) -> tuple[float, float, float, int]:
        """(cosine of the whole gradients, their worst row's, the worst row's
        among the rows of ``b`` whose norm is at least `TP_ROW_FLOOR` of its
        median row norm, the number of rows below that floor)."""
        a, b = torch.from_numpy(a).double(), torch.from_numpy(b).double()
        whole = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
        rows = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        norms = b.norm(dim=-1)
        kept = norms >= TP_ROW_FLOOR * norms.median()
        return whole, rows.min().item(), rows[kept].min().item(), int((~kept).sum())

    g32 = single["f32"]["grad"]
    print(f"{tag}: yardstick, the one-process bf16 gradient against the float32 one: cosine %.7f, worst row "
          f"%.6f, worst row above the norm floor %.6f (%d rows below it)" % cosines(single["bf16"]["grad"], g32),
          flush=True)
    for prec in ("f32", "bf16"):
        one = single[prec]
        for rank in (0, 1):
            r = got[rank][prec]
            rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], one["losses"])]
            g, w = r["grad"], one["grad"]
            g_rel = float(abs(g - w).max() / abs(w).max())
            cos, row_cos, floored, low = cosines(g, w)
            line = (f"{tag}: {prec} rank {rank} losses {json.dumps([round(x, 7) for x in r['losses']])} against "
                    f"{json.dumps([round(x, 7) for x in one['losses']])} (max rel {max(rel):.3e}); {TP_WEIGHT} "
                    f"first gradient max rel {g_rel:.3e}, cosine {cos:.7f}, worst row {row_cos:.7f}, worst row "
                    f"above the norm floor {floored:.7f} ({low} rows below it); launches {json.dumps(r['launches'])}")
            if prec == "bf16":
                cos32, row32, floored32, low32 = cosines(g, g32)
                line += (f"; against the float32 gradient: cosine {cos32:.7f}, worst row {row32:.6f}, worst row "
                         f"above the norm floor {floored32:.6f} ({low32} rows below it); "
                         f"{r['step_ms']:.3f} ms a step, kernels {r['kernel_ms']:.3f} ms a step under the "
                         f"profiler (one process {one['step_ms']:.3f} / {one['kernel_ms']:.3f})")
            print(line, flush=True)
            if r["launches"] != one["launches"]:
                fail(f"{tag}: rank {rank} {prec} launches {r['launches']}, one process {one['launches']}")
            if not all(map(math.isfinite, r["losses"])):
                fail(f"{tag}: rank {rank} {prec} losses {r['losses']}")
            if prec == "f32" and not (rel[0] <= TP_F32_LOSS_MAX_REL and g_rel <= TP_F32_GRAD_MAX_REL):
                fail(f"{tag}: rank {rank} f32 first loss rel {rel[0]}, gradient max rel {g_rel} (bars "
                     f"{TP_F32_LOSS_MAX_REL}, {TP_F32_GRAD_MAX_REL})")
            if prec == "bf16" and not (max(rel) <= TP_BF16_LOSS_MAX_REL and cos >= TP_BF16_GRAD_MIN_COS
                                       and cos32 >= TP_BF16_GRAD_F32_MIN_COS):
                fail(f"{tag}: rank {rank} bf16 losses rel {max(rel)}, gradient cosine {cos} against one process "
                     f"in bf16 and {cos32} against float32 (bars {TP_BF16_LOSS_MAX_REL}, {TP_BF16_GRAD_MIN_COS}, "
                     f"{TP_BF16_GRAD_F32_MIN_COS})")
    if single["bf16"]["launches"] != expect:
        fail(f"{tag}: one-process launches {single['bf16']['launches']}, expected {expect}")
    one = single["bf16"]
    for name, r in (("one process", one), ("rank 0", got[0]["bf16"]), ("rank 1", got[1]["bf16"])):
        print(f"{tag}: {name} {s.model} distill step, batch {TRAIN_BATCH} at {s.image}px, {TRAIN_BOXES} crops at "
              f"{s.crop}px, bf16, mean of {TP_TIMED} after {TP_WARMUP} warm-up, under the profiler: "
              f"{r['step_ms']:.3f} ms, kernels {r['kernel_ms']:.3f} ms, idle {1 - r['kernel_ms'] / r['step_ms']:.1%}; "
              f"over the {TP_TIMED} steps: {r['top']}", flush=True)
    paths = check_pipeline_ring(torch, ref, {rank: got[rank]["pipeline_ring"] for rank in (0, 1)})
    print(f"{tag} phase, with the pipeline and the ring: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"vitb16_train_tp2": got[0]["bf16"]["launches"], **paths}


def timm_norms(s: Model) -> int:
    """The LayerNorms of one pass of a timm tower: ConvNeXt has its stem's,
    one before each later stage's downsampling conv, one a block and the
    head norm; Swin its patch embedding's, two a block, one a patch merging
    and the final norm."""
    from clipself_tpu_torch.models.convnext import CONVNEXT_ARCHS
    from clipself_tpu_torch.models.swin import SWIN_ARCHS

    name = s.vision.timm_model_name
    if name.startswith("convnext"):
        depths = CONVNEXT_ARCHS[name][0]
        return len(depths) + sum(depths) + 1
    depths = SWIN_ARCHS[name][1]
    return 2 * sum(depths) + len(depths) + 1


def tower_expected_launches(s: Model, evals=0, evals_v1=0, steps=0) -> dict:
    """The launch counts of the ModifiedResNet (none: BatchNorm, and the
    attention pool's attention is plain, as the JAX package runs no Pallas
    kernel there), of a timm tower (LayerNorms alone: `timm_norms` a pass;
    its attention, Swin's window attention, is plain; a v2 evaluator batch
    is a dense and a crop pass, a v1 batch the RoI pass, the mask pass and
    a crop pass, a step the teacher's crop pass and the student's, whose
    backward runs every norm of its pass) or of the EVA01 tower
    (`vit_expected_launches` with its one final norm) over ``evals`` v2
    and ``evals_v1`` v1 evaluator batches and ``steps`` train steps."""
    if s.vision.resnet_layers:
        return {k: 0 for k in _counters()}
    if s.timm:
        norms = timm_norms(s)
        return {**{k: 0 for k in _counters()}, "layer_norm": (2 * evals + 3 * evals_v1 + 2 * steps) * norms,
                "layer_norm_bwd": steps * norms}
    return vit_expected_launches(s.vision.layers, tower_norms=1, evals=evals, evals_v1=evals_v1, steps=steps)


def draw_layer_scale(torch, model) -> None:
    """ConvNeXt's layer scale starts at 1e-6, so on seeded weights its
    blocks barely touch the map: every `gamma` is drawn uniform in [0.1, 1)
    instead, from a CUDA generator seeded `SEED`, the same draws on every
    model it is called on."""
    from clipself_tpu_torch.models.convnext import ConvNeXtBlock

    gen = None
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvNeXtBlock):
                if gen is None:
                    gen = torch.Generator(device=m.gamma.device).manual_seed(SEED)
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=gen, device=m.gamma.device) * 0.9 + 0.1)


def strided_norm_inputs(torch, model, images) -> tuple[int, int]:
    """(LayerNorm calls of one dense pass, those whose input was not
    contiguous): the timm towers keep their maps channels-last, so each
    norm reads [.., C] rows where they lie; a non-contiguous 4-D input would
    make the kernel's wrapper raise, and a copy before the norm is what this
    rules out."""
    from clipself_tpu_torch.models.eva_vit import LayerNorm

    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: seen.append(a[0].is_contiguous()))
             for m in model.modules() if isinstance(m, LayerNorm)]
    try:
        model.encode_dense(images, keep_shape=True)
    finally:
        for h in hooks:
            h.remove()
    return len(seen), seen.count(False)


def tower_eval(torch, dev, s: Model) -> dict:
    """The tower through `evaluate_zero_shot` (bf16, seeded random weights):
    `TOWER_BATCHES` v2 batches after `EVAL_WARMUP`, with ms a batch,
    images/s, peak memory, the kernels' ms a batch over `TOWER_PROFILED`
    batches under the profiler and the launch counts; for the ResNet and
    the timm towers also one v1 call (the ResNet: the attention pool of 7x7
    RoI-aligned maps; ConvNeXt and Swin: the trunk map RoI-aligned to the
    crop-size grid and pooled through the head). Then parity against the
    plain float32 path: the dense map, the image embedding and (ResNet,
    timm) the v1 RoI features, ConvNeXt's layer scales drawn first
    (`draw_layer_scale`). Returns the launch counts by path."""
    import numpy as np

    from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.models.factory import create_model

    rn = bool(s.vision.resnet_layers)
    convnext = s.timm and s.vision.timm_model_name.startswith("convnext")
    model = create_model(s.model, device=dev, dtype=torch.bfloat16, seed=SEED)

    def batch(i):
        host = synthetic_panoptic_batch(
            i, batch=s.eval_batch, image_size=s.image, max_anns=MAX_ANNS, valid_anns=VALID_ANNS,
            crop_size=s.crop, mask_hw=s.grid(s.image), n_classes=N_CLASSES, seed=SEED,
        )
        return {k: (v if k == "boxes" else torch.as_tensor(v, device=dev)) for k, v in host.items()}

    emb = class_embeddings(N_CLASSES, model.cfg.embed_dim, seed=SEED)
    warm = [batch(TOWER_BATCHES + i) for i in range(EVAL_WARMUP)]
    batches = [batch(i) for i in range(TOWER_BATCHES)]
    tag = f"{s.key} eval"

    def run(bs, et="v2"):
        return evaluate_zero_shot(model, bs, emb, device=dev, ann_bucket=BUCKET, extract_type=et)

    run(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run(batches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(batches[:TOWER_PROFILED])
        torch.cuda.synchronize()
    k = kernel_ms(torch, prof) / TOWER_PROFILED
    ms = dt / TOWER_BATCHES * 1e3
    print(
        f"{tag} {s.model} zero-shot: {TOWER_BATCHES} batches x {s.eval_batch} images {s.image}px, "
        f"{VALID_ANNS} valid of {MAX_ANNS} anns (bucket {BUCKET}), crops {s.crop}px, extract type v2: "
        f"{ms:.3f} ms a batch after {EVAL_WARMUP} warm-up batches, {s.eval_batch * TOWER_BATCHES / dt:.3f} "
        f"images/s, peak {peak:.3f} GiB; kernels {k:.3f} ms a batch ({TOWER_PROFILED} profiled), device "
        f"idle {1 - k / ms:.1%}",
        flush=True,
    )
    print(f"{tag} mAcc " + json.dumps(res, sort_keys=True), flush=True)
    print(f"{tag} launches " + json.dumps(launches), flush=True)
    if len(res) != 12 or not all(np.isfinite(v) for v in res.values()):
        fail(f"{tag}: evaluator result not finite: {res}")
    expect = tower_expected_launches(s, evals=TOWER_BATCHES)
    if launches != expect:
        fail(f"{tag} launch counts {launches}, expected {expect}")
    paths = {f"{s.key}_eval": launches}
    if rn or s.timm:
        reset_counts()
        t0 = time.perf_counter()
        res = run(batches[:1], "v1")
        torch.cuda.synchronize()
        ms, launches = (time.perf_counter() - t0) * 1e3, read_counts()
        how = ("the attention pool of 7x7 RoI-aligned stage-4 maps" if rn else
               "the trunk map RoI-aligned to the crop-size grid, pooled through the head")
        print(f"{tag} v1 {s.model}: one batch {ms:.3f} ms (the RoIs pooled by {how}; masks by the tower's "
              f"mask_pool); mAcc {json.dumps(res, sort_keys=True)}; launches {json.dumps(launches)}", flush=True)
        expect = tower_expected_launches(s, evals_v1=1)
        if len(res) != 12 or not all(np.isfinite(v) for v in res.values()) or launches != expect:
            fail(f"{tag} v1: result {res}, launches {launches}, expected {expect}")
        paths[f"{s.key}_eval_v1"] = launches

    images = batches[0]["images"]
    boxes = torch.as_tensor(batches[0]["boxes"][:, :BUCKET, :4], device=dev)
    if s.timm:
        with torch.inference_mode():
            calls, strided = strided_norm_inputs(torch, model, images)
        print(f"{s.key} LayerNorm inputs of one dense pass: {calls} calls, {strided} not contiguous "
              "(channels-last maps read in place, no copy before a norm)", flush=True)
        if strided or calls != timm_norms(s):
            fail(f"{s.key}: {strided} of {calls} LayerNorm inputs not contiguous (expected 0 of {timm_norms(s)})")
    model_f32 = create_model(s.model, device=dev, dtype=torch.float32, seed=SEED)
    if convnext:
        draw_layer_scale(torch, model)
        draw_layer_scale(torch, model_f32)
    legs = [("dense map", lambda m: m.encode_dense(images, keep_shape=True)),
            ("image embedding", lambda m: m.encode_image(images))]
    if rn or s.timm:
        legs.append(("v1 RoI features", lambda m: m.encode_pseudo_boxes(images, boxes, extract_type="v1")))
    with torch.inference_mode():
        got = {}
        for what, fn in legs:
            k32, k16 = fn(model_f32), fn(model)
            with plain_path():
                p32 = fn(model_f32)
            got[what] = (k32, k16, p32)
    torch.cuda.synchronize()
    for what, (k32, k16, p32) in got.items():
        f32_abs = (k32 - p32).abs().max().item()
        bf16_cos = min_row_cos(k16, p32)
        print(
            f"{s.key} parity {what} {list(p32.shape)}: f32 kernels vs f32 plain max_abs {f32_abs:.3e} "
            f"(bar {PATH_F32_MAX_ABS}); bf16 kernels vs f32 plain min_row_cos {bf16_cos:.7f} "
            f"(bar {PATH_BF16_MIN_COS})",
            flush=True,
        )
        if not all(torch.isfinite(t).all() for t in (k32, k16, p32)):
            fail(f"{s.key} {what}: not finite")
        if not f32_abs <= PATH_F32_MAX_ABS:
            fail(f"{s.key} {what}: f32 kernel path off the plain path by {f32_abs}")
        if not bf16_cos >= PATH_BF16_MIN_COS:
            fail(f"{s.key} {what}: bf16 kernel path min row cosine {bf16_cos}")
    del model, model_f32, got
    torch.cuda.empty_cache()
    return paths


def timm_group(name: str) -> str:
    """The part of a timm tower a trainable parameter belongs to: a stage
    (`trunk.stages.{s}`, `trunk.layers.{s}`), else the stem, patch
    embedding, final or head norm, or the projection."""
    parts = name.split(".")
    return ".".join(parts[1:4] if parts[2] in ("stages", "layers") else parts[1:3])


def phase_towers(torch, dev, logs_dir) -> dict:
    """The ModifiedResNet (RN50), the EVA01 variant (EVA01-CLIP-B-16) and the
    timm towers (convnext_base at 1024^2, Swin-B at 896^2): `tower_eval`,
    then the trainer (batch 2, 20 boxes, 40 crops at 224^2, every lock
    group unlocked, the timm towers with `--no-lock-image`:
    `TOWER_TRAIN_WARMUP` + `TOWER_TRAIN_TIMED` steps and `TOWER_PROFILED`
    under the profiler; RN50 also one step with
    `--lock-image-freeze-bn-stats`, whose BatchNorm statistics must keep
    their bits) and one step's parity at batch 1 (ConvNeXt's layer scales
    drawn first). Returns the launch counts by path."""
    t0 = time.perf_counter()
    paths = {}
    for s in TOWER_MODELS:
        t_model = time.perf_counter()
        rn = bool(s.vision.resnet_layers)
        paths.update(tower_eval(torch, dev, s))
        unlocked = RN_GROUPS if rn else s.vision.layers
        # a ResNet parameter's part: the stem (lock group 1), a stage (groups 2-5), the pool
        group_of = (lambda name: name.split(".")[1] if name.startswith(("visual.layer", "visual.attnpool"))
                    else "stem") if rn else timm_group if s.timm else None
        extra = ["--no-lock-image"] if s.timm else []
        common = dict(unlocked=unlocked, group_of=group_of,
                      expect=lambda n, s=s: tower_expected_launches(s, steps=n))
        try:
            train = phase_train(torch, dev, s, logs_dir, extra=extra, tag=f"{s.key} train",
                                warmup=TOWER_TRAIN_WARMUP, timed=TOWER_TRAIN_TIMED, profiled=TOWER_PROFILED,
                                **common)
            paths[f"{s.key}_train"] = train["launches"]
            torch.cuda.empty_cache()
            if rn:
                frozen = phase_train(torch, dev, s, logs_dir, extra=["--lock-image-freeze-bn-stats"],
                                     tag=f"{s.key} train frozen bn stats", warmup=0, timed=1, **common)
                paths[f"{s.key}_train_frozen_bn"] = frozen["launches"]
        finally:
            shutil.rmtree(logs_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        kernels = ([] if rn else ["layer_norm", "layer_norm_bwd"] if s.timm
                   else ["flash_attention", "flash_attention_bwd", "layer_norm", "layer_norm_bwd"])
        convnext = s.timm and s.vision.timm_model_name.startswith("convnext")
        phase_train_parity(
            torch, dev, s, unlocked=unlocked, kernels=kernels, lock_image=not s.timm,
            prepare=(lambda m: draw_layer_scale(torch, m)) if convnext else None,
        )
        torch.cuda.empty_cache()
        print(f"{s.key} tower done in {time.perf_counter() - t_model:.1f} s", flush=True)
    print(f"towers phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths



def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def coca_expected_launches(cfg, *, forwards=0, backwards=0, images=0, decodes=0) -> dict:
    """Launches of a CoCa over the OpenCLIP ViT with the attentional pooler:
    ``forwards`` model forwards (of which ``backwards`` run backward),
    ``images`` image encodings alone and ``decodes`` decoder calls
    (`decode_text`, one a generated position). The vision trunk's blocks
    take the flash kernel (unmasked self-attention); the pooler, the text
    tower and the decoder run plain attention (cross or causal). LayerNorms:
    the tower's `ln_pre`, two a block, the pooler's `ln_q` and `ln_k` and
    `ln_post`; the text tower's two a block and `ln_final` (on the CLS
    position); the decoder's two a self block, three a cross block
    (`ln_1`, `ln_1_kv`, `ln_2`) and `ln_final`. Every parameter is trainable,
    so a backward runs the LayerNorm backward for every norm of its forward."""
    v, t, m = cfg.vision, cfg.text, cfg.multimodal
    vision_norms = 1 + 2 * v.layers + 3
    decode_norms = (2 * t.layers + 1) + (5 * m.layers + 1)
    return {
        "nms": 0,
        "flash_attention": (forwards + images) * v.layers,
        "flash_attention_bwd": backwards * v.layers,
        "rope_roll": 0,
        "rope_roll_bwd": 0,
        "layer_norm": (forwards + images) * vision_norms + (forwards + decodes) * decode_norms,
        "layer_norm_bwd": backwards * (vision_norms + decode_norms),
    }


def coca_parity(torch, model, model_f32, images, texts) -> dict:
    """Image latents, text latents and decoder logits of the bf16 kernels
    and the f32 kernels against the f32 plain path (min row cosine, max
    abs); fails under `PATH_BF16_MIN_COS` (bf16) or over `PATH_F32_MAX_ABS`
    (f32) on any of them."""
    def run(m):
        out = m(images, texts)
        return {"image latents": out["image_features"], "text latents": out["text_features"],
                "decoder logits": out["logits"]}

    with torch.inference_mode():
        k16, k32 = run(model), run(model_f32)
        with plain_path():
            p32 = run(model_f32)
    rows = {}
    for what in p32:
        cos, f32_abs = min_row_cos(k16[what], p32[what]), (k32[what] - p32[what]).abs().max().item()
        rows[what] = (cos, f32_abs)
        print(f"coca parity {what} {list(p32[what].shape)}: bf16 kernels vs f32 plain min_row_cos {cos:.7f} "
              f"(bar {PATH_BF16_MIN_COS}); f32 kernels vs f32 plain max_abs {f32_abs:.3e} "
              f"(bar {PATH_F32_MAX_ABS})", flush=True)
        if not all(torch.isfinite(x[what]).all() for x in (k16, k32, p32)):
            fail(f"coca {what}: not finite")
    for what, (cos, f32_abs) in rows.items():
        if not cos >= PATH_BF16_MIN_COS:
            fail(f"coca {what}: bf16 kernel path min row cosine {cos}")
        if not f32_abs <= PATH_F32_MAX_ABS:
            fail(f"coca {what}: f32 kernel path off the plain path by {f32_abs}")
    return rows


def greedy_parity(torch, model_f32, images, sot: int, eot: int) -> None:
    """Greedy captions of the f32 kernel path against the f32 plain path:
    EQUAL, or the first differing position's top-2 logit gap (the plain
    path's) under `COCA_TIE_GAP`."""
    from clipself_tpu_torch.models.coca import generate

    got = generate(model_f32, images, sot, eot, max_len=COCA_MAX_LEN)
    with plain_path():
        want = generate(model_f32, images, sot, eot, max_len=COCA_MAX_LEN)
        diff = (got != want).nonzero()
        gap = None
        if len(diff):
            b, pos = diff[0].tolist()
            with torch.inference_mode():
                logits = model_f32.decode_text(model_f32._encode_image(images[b:b + 1])[1], want[b:b + 1])
            top2 = torch.topk(logits[0, pos - 1].float(), 2).values
            gap = (top2[0] - top2[1]).item()
    print(f"coca greedy {list(got.shape)}: f32 kernels vs f32 plain tokens "
          + ("EQUAL" if gap is None else f"differ first at row {b} position {pos}, top-2 logit gap {gap:.3e} "
             f"(bar {COCA_TIE_GAP})"), flush=True)
    if gap is not None and not gap < COCA_TIE_GAP:
        fail(f"coca greedy tokens differ at row {b} position {pos} with a top-2 gap of {gap}")


def phase_coca(torch, dev) -> dict:
    """coca_ViT-L-14 at full width and depth on seeded random weights, drawn
    once on the card (a host draw of its 0.64 G values takes seconds) and
    shared by the bf16 and the f32 model: forward and `coca_loss` over 8
    images at 224^2 and 8 captions from `get_tokenizer`, timed (images/s)
    and profiled (kernel ms); parity of the image latents, text latents and
    decoder logits; one backward in bf16 (the vision tower's gradients
    finite); greedy captions of `COCA_MAX_LEN` tokens (ms a generated
    position, the f32 kernel path against the f32 plain path). Every run's
    launches equal `coca_expected_launches`. Returns the launch counts by
    path."""
    from clipself_tpu_torch.models.coca import coca_loss, generate
    from clipself_tpu_torch.models.factory import get_model_config, get_tokenizer, model_class
    from clipself_tpu_torch.tokenizer import tokenize

    t0 = time.perf_counter()
    cfg = get_model_config(COCA_MODEL)
    with torch.device(dev):
        model = model_class(cfg)(cfg, dtype=torch.bfloat16)
        model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
        model_f32 = model_class(cfg)(cfg, dtype=torch.float32)
    model_f32.load_state_dict(model.state_dict())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    size = cfg.vision.image_size
    images = torch.randn((COCA_BATCH, size, size, 3), generator=gen, device=dev)
    texts = torch.as_tensor(get_tokenizer(COCA_MODEL)(list(COCA_CAPTIONS)), device=dev).long()
    sot, eot = (int(tokenize("")[0, i]) for i in (0, 1))
    smi = card()
    paths = {}

    def step():
        return coca_loss(model(images, texts), texts)[0]

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        for _ in range(COCA_TIMED):
            loss = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / COCA_TIMED * 1e3
        paths["coca_forward"] = read_counts()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step()
            torch.cuda.synchronize()
        k_ms = kernel_ms(torch, prof)
    print(f"coca forward + coca_loss kernels: {top_kernels(torch, prof)}", flush=True)
    print(f"coca {COCA_MODEL} forward + coca_loss, {COCA_BATCH} images {size}px and {COCA_BATCH} captions of "
          f"{texts.shape[1]} tokens, bf16: {ms:.3f} ms a call ({COCA_TIMED} after 1), "
          f"{COCA_BATCH / ms * 1e3:.3f} images/s, kernels {k_ms:.3f} ms, device idle {1 - k_ms / ms:.1%}, "
          f"loss {loss.item():.5f}; {smi}", flush=True)
    expect = coca_expected_launches(cfg, forwards=COCA_TIMED)
    if paths["coca_forward"] != expect:
        fail(f"coca forward launch counts {paths['coca_forward']}, expected {expect}")
    if not math.isfinite(loss.item()):
        fail(f"coca loss {loss.item()}")

    coca_parity(torch, model, model_f32, images, texts)

    # one backward in bf16: every parameter trainable
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss = step()
    loss.backward()
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t1) * 1e3
    paths["coca_backward"] = read_counts()
    grads = [p.grad for name, p in model.named_parameters() if name.startswith("visual.")]
    finite = all(g is not None and torch.isfinite(g).all().item() for g in grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads)).item()
    model.zero_grad(set_to_none=True)
    print(f"coca backward of coca_loss, bf16: forward + backward {bwd_ms:.3f} ms (one call), loss "
          f"{loss.item():.5f}, {len(grads)} vision gradients finite {finite}, their norm {norm:.4e}; "
          f"launches {json.dumps(paths['coca_backward'])}", flush=True)
    expect = coca_expected_launches(cfg, forwards=1, backwards=1)
    if paths["coca_backward"] != expect:
        fail(f"coca backward launch counts {paths['coca_backward']}, expected {expect}")
    if not finite:
        fail("coca backward: a vision gradient is missing or not finite")

    # greedy captions: ms a generated position in bf16, then f32 kernels vs plain
    generate(model, images, sot, eot, max_len=4)
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    tokens = generate(model, images, sot, eot, max_len=COCA_MAX_LEN)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t1) * 1e3
    paths["coca_generate"] = read_counts()
    steps = COCA_MAX_LEN - 1
    with torch.inference_mode():
        img_tokens = model._encode_image(images)[1]
        with torch.profiler.profile(activities=acts) as prof:
            model.decode_text(img_tokens, tokens)
            torch.cuda.synchronize()
    print(f"coca one decode step [{COCA_BATCH}, {COCA_MAX_LEN}] kernels {kernel_ms(torch, prof):.3f} ms: "
          f"{top_kernels(torch, prof)}", flush=True)
    print(f"coca greedy generate bf16, {COCA_BATCH} images, max_len {COCA_MAX_LEN}: {gen_ms:.3f} ms, "
          f"{gen_ms / steps:.3f} ms a generated position (the whole buffer decoded each step), "
          f"first caption {tokens[0].tolist()}; {smi}", flush=True)
    expect = coca_expected_launches(cfg, images=1, decodes=steps)
    if paths["coca_generate"] != expect:
        fail(f"coca generate launch counts {paths['coca_generate']}, expected {expect}")
    # a row starts with the start token and ends at its first end token or
    # pad (the pad id is a real token, and a generated one ends the row)
    ends = (tokens[:, 1:] == eot) | (tokens[:, 1:] == model_f32.pad_id)
    if not ((tokens[:, 0] == sot).all() and ends.any(dim=1).all()):
        fail(f"coca greedy captions malformed: {tokens.tolist()}")
    greedy_parity(torch, model_f32, images, sot, eot)
    del model, model_f32
    torch.cuda.empty_cache()
    print(f"coca phase: {time.perf_counter() - t0:.1f} s (bar 45 s)", flush=True)
    return paths


def hf_vit_config():
    """`hf-vit-tiny-test` with the trunk at ViTConfig's defaults (ViT-B/16:
    width 768, 12 layers of 12 heads, FFN 3072, patch 16, `qkv_bias`, eps
    1e-12) at 224^2 and embed 512, named HF_VIT."""
    from clipself_tpu_torch.core.config import get_model_config

    cfg = get_model_config("hf-vit-tiny-test")
    vision = dataclasses.replace(cfg.vision, image_size=HF_VIT_SIZE, hf_trunk_kwargs=HF_VIT_KWARGS)
    return dataclasses.replace(cfg, name=HF_VIT, embed_dim=HF_EMBED, vision=vision)


def hf_text_config():
    """HF_TEXT_MODEL with its text tower keyed by the model type
    HF_TEXT_TYPE (the registry names a hub id, whose config.json is not in
    the repository); everything else as the registry has it."""
    from clipself_tpu_torch.core.config import get_model_config

    cfg = get_model_config(HF_TEXT_MODEL)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, hf_model_name=HF_TEXT_TYPE))


@contextlib.contextmanager
def registered(cfg):
    """`get_model_config` answers ``cfg.name`` with ``cfg`` in every module
    that holds it by name (the trainer's `--model` among them)."""
    from clipself_tpu_torch.core import config

    original = config.get_model_config

    def get_model_config(name):
        return cfg if name == cfg.name else original(name)

    holders = [m for m in list(sys.modules.values()) if getattr(m, "get_model_config", None) is original]
    for m in holders:
        m.get_model_config = get_model_config
    try:
        yield
    finally:
        for m in holders:
            m.get_model_config = original


def hf_expected_launches(*, vit_passes=0, vit_backwards=0, text_passes=0, text_backwards=0,
                         clip_vit_passes=0, clip_vit_backwards=0) -> dict:
    """Launches of the HF paths: a pass of the HF ViT-B/16 trunk runs the
    flash forward in each of its 12 layers and 25 LayerNorms (2 a layer and
    the final `layernorm`); its backward with every parameter trainable the
    flash backward and the LayerNorm backward of each. A pass of the RoBERTa
    text trunk runs 25 LayerNorms (the embeddings' and 2 a layer) and no
    flash kernel (its attention takes the padding mask: plain); a pass of
    roberta-ViT-B-32's OpenCLIP ViT-B/32 the flash forward in its 12 blocks
    and 26 LayerNorms (2 a block, `ln_pre`, `ln_post`), and with every
    parameter trainable the backward of each."""
    return {
        "nms": 0,
        "flash_attention": 12 * (vit_passes + clip_vit_passes),
        "flash_attention_bwd": 12 * (vit_backwards + clip_vit_backwards),
        "rope_roll": 0,
        "rope_roll_bwd": 0,
        "layer_norm": 25 * (vit_passes + text_passes) + 26 * clip_vit_passes,
        "layer_norm_bwd": 25 * (vit_backwards + text_backwards) + 26 * clip_vit_backwards,
    }


def hf_parity(torch, tag, legs: dict) -> None:
    """Each leg's f32 kernel path against the f32 plain path (max abs under
    `PATH_F32_MAX_ABS`) and its bf16 model against the plain path (min row
    cosine at least `PATH_BF16_MIN_COS`); ``legs``: what -> (f32 kernels,
    bf16 kernels, f32 plain)."""
    for what, (k32, k16, p32) in legs.items():
        f32_abs = (k32 - p32).abs().max().item()
        bf16_cos = min_row_cos(k16, p32)
        print(f"{tag} parity {what} {list(p32.shape)}: f32 kernels vs f32 plain max_abs {f32_abs:.3e} (bar "
              f"{PATH_F32_MAX_ABS}); bf16 kernels vs f32 plain min_row_cos {bf16_cos:.7f} (bar "
              f"{PATH_BF16_MIN_COS})", flush=True)
        if not all(torch.isfinite(t).all() for t in (k32, k16, p32)):
            fail(f"{tag} {what}: not finite")
        if not f32_abs <= PATH_F32_MAX_ABS:
            fail(f"{tag} {what}: f32 kernel path off the plain path by {f32_abs}")
        if not bf16_cos >= PATH_BF16_MIN_COS:
            fail(f"{tag} {what}: bf16 kernel path min row cosine {bf16_cos}")


def hf_group(name: str) -> str:
    """The part of the HF trunk adapter a trainable parameter belongs to: a
    layer (`trunk.encoder.layer.{i}`), else the embeddings, the final norm
    or the head."""
    parts = name.split(".")
    return ".".join(parts[1:5] if parts[2:4] == ["encoder", "layer"] else parts[1:3])


def hf_ids(torch, dev, rows: int, length: int, vocab: int, pad: int, bos: int, eos: int, seed: int = SEED):
    """[rows, length] RoBERTa-style ids: the start id, 3 to length - 2
    random ids, the end id, then the pad id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.full((rows, length), pad, np.int64)
    for r in range(rows):
        n = int(rng.integers(3, length - 1))
        ids[r, 0], ids[r, n + 1] = bos, eos
        ids[r, 1:n + 1] = rng.integers(3, vocab, n)
    return torch.as_tensor(ids, device=dev)


def phase_hf(torch, dev, logs_dir) -> dict:
    """The HF towers without transformers at full width: (a) the HF ViT-B/16
    trunk adapter (`hf_vit_config`) through `evaluate_zero_shot` (ms a
    batch, images/s, the kernels' ms under the profiler, idle share), the
    dense map and image embedding against the plain f32 path, and the
    distill step through the trainer with --no-lock-image; (b) the RoBERTa
    text tower of `hf_text_config` through CLIP.forward and `clip_loss`
    (timed and profiled), its text and image embeddings against the plain
    f32 path, the text tower alone, and one bf16 backward into both towers.
    Weights are drawn once on the card for each model. Every run's launches
    equal `hf_expected_launches`. Returns the launch counts by path."""
    import numpy as np

    from clipself_tpu_torch.data.synthetic import class_embeddings, synthetic_panoptic_batch
    from clipself_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from clipself_tpu_torch.models.clip import CLIP
    from clipself_tpu_torch.train.contrastive import clip_loss

    t0 = time.perf_counter()
    smi = card()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    paths = {}

    def draw(cfg):
        with torch.device(dev):
            m16 = CLIP(cfg, torch.bfloat16)
            m16.init_weights(torch.Generator(device=dev).manual_seed(SEED))
            m32 = CLIP(cfg, torch.float32)
        m32.load_state_dict(m16.state_dict())
        return m16.eval(), m32.eval()

    # (a) the trunk adapter
    vit_cfg = hf_vit_config()
    with registered(vit_cfg):
        s = Model("hf_vit_b16", HF_VIT, image=HF_VIT_SIZE, eval_batch=2)
        model, model_f32 = draw(vit_cfg)
        trunk = model.visual.hf_config
        print(f"hf_vit_b16 trunk: {trunk.num_hidden_layers} layers, width {trunk.hidden_size}, "
              f"{trunk.num_attention_heads} heads, FFN {trunk.intermediate_size}, patch {trunk.patch_size} at "
              f"{HF_VIT_SIZE}px (dense grid {s.grid(s.image)}), {trunk.hidden_act} GELU, eps "
              f"{trunk.layer_norm_eps}; float32 trunk, bf16 head", flush=True)

        def batch(i):
            host = synthetic_panoptic_batch(
                i, batch=s.eval_batch, image_size=s.image, max_anns=MAX_ANNS, valid_anns=VALID_ANNS,
                crop_size=s.crop, mask_hw=s.grid(s.image), n_classes=N_CLASSES, seed=SEED,
            )
            return {k: (v if k == "boxes" else torch.as_tensor(v, device=dev)) for k, v in host.items()}

        emb = class_embeddings(N_CLASSES, HF_EMBED, seed=SEED)
        batches = [batch(i) for i in range(HF_EVAL_BATCHES + 1)]

        def run(bs):
            return evaluate_zero_shot(model, bs, emb, device=dev, ann_bucket=BUCKET)

        run(batches[-1:])
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        res = run(batches[:-1])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        paths["hf_vit_eval"] = launches = read_counts()
        with torch.profiler.profile(activities=acts) as prof:
            run(batches[:1])
            torch.cuda.synchronize()
        k = kernel_ms(torch, prof)
        ms = dt / HF_EVAL_BATCHES * 1e3
        print(f"hf_vit_b16 eval zero-shot: {HF_EVAL_BATCHES} batches x {s.eval_batch} images {s.image}px, "
              f"{VALID_ANNS} valid of {MAX_ANNS} anns (bucket {BUCKET}), crops {s.crop}px: {ms:.3f} ms a batch "
              f"after 1, {s.eval_batch * HF_EVAL_BATCHES / dt:.3f} images/s; kernels {k:.3f} ms a batch (1 "
              f"profiled), device idle {1 - k / ms:.1%}; {smi}", flush=True)
        print(f"hf_vit_b16 eval kernels: {top_kernels(torch, prof)}", flush=True)
        print(f"hf_vit_b16 eval mAcc {json.dumps(res, sort_keys=True)}; launches {json.dumps(launches)}",
              flush=True)
        expect = hf_expected_launches(vit_passes=2 * HF_EVAL_BATCHES)
        if len(res) != 12 or not all(np.isfinite(v) for v in res.values()) or launches != expect:
            fail(f"hf_vit_b16 eval: result {res}, launches {launches}, expected {expect}")
        images = batches[0]["images"]
        with torch.inference_mode():
            legs = {}
            for what, fn in (("dense map", lambda m: m.encode_dense(images, keep_shape=True)),
                             ("image embedding", lambda m: m.encode_image(images))):
                k32, k16 = fn(model_f32), fn(model)
                with plain_path():
                    legs[what] = (k32, k16, fn(model_f32))
        hf_parity(torch, "hf_vit_b16", legs)
        del model, model_f32, legs
        torch.cuda.empty_cache()
        try:
            train = phase_train(
                torch, dev, s, logs_dir, extra=["--no-lock-image"], tag="hf_vit_b16 train",
                warmup=HF_TRAIN_WARMUP, timed=HF_TRAIN_TIMED, profiled=HF_TRAIN_PROFILED, group_of=hf_group,
                expect=lambda n: hf_expected_launches(vit_passes=2 * n, vit_backwards=n),
            )
        finally:
            shutil.rmtree(logs_dir, ignore_errors=True)
        paths["hf_vit_train"] = train["launches"]
    torch.cuda.empty_cache()

    # (b) the RoBERTa text tower
    cfg = hf_text_config()
    model, model_f32 = draw(cfg)
    c = model.text.hf_config
    print(f"hf_roberta text tower: {c.num_hidden_layers} layers, width {c.hidden_size}, "
          f"{c.num_attention_heads} heads, FFN {c.intermediate_size}, vocabulary {c.vocab_size}, eps "
          f"{c.layer_norm_eps}, pad id {c.pad_token_id}, {cfg.text.pooler_type}, {cfg.text.proj} projection; "
          f"float32 trunk, bf16 projection; vision {cfg.name}'s ViT-B/32", flush=True)
    size = cfg.vision.image_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    images = torch.randn((HF_TEXT_ROWS, size, size, 3), generator=gen, device=dev)
    texts = hf_ids(torch, dev, HF_TEXT_ROWS, 77, c.vocab_size, c.pad_token_id, 0, 2)

    def step(m):
        return clip_loss(*m(images, texts))

    with torch.inference_mode():
        step(model)
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        for _ in range(HF_TEXT_TIMED):
            loss = step(model)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / HF_TEXT_TIMED * 1e3
        paths["hf_roberta_forward"] = launches = read_counts()
        with torch.profiler.profile(activities=acts) as prof:
            step(model)
            torch.cuda.synchronize()
        k = kernel_ms(torch, prof)
        reset_counts()
        t1 = time.perf_counter()
        model.encode_text(texts)
        torch.cuda.synchronize()
        text_ms = (time.perf_counter() - t1) * 1e3
        paths["hf_roberta_text"] = text_launches = read_counts()
    print(f"hf_roberta forward + clip_loss, {HF_TEXT_ROWS} images {size}px and {HF_TEXT_ROWS} id rows of "
          f"{texts.shape[1]}, bf16: {ms:.3f} ms a call ({HF_TEXT_TIMED} after 1), {HF_TEXT_ROWS / ms * 1e3:.3f} "
          f"images/s, kernels {k:.3f} ms, device idle {1 - k / ms:.1%}, loss {loss.item():.5f}; the text tower "
          f"alone {text_ms:.3f} ms (one call); {smi}", flush=True)
    print(f"hf_roberta forward kernels: {top_kernels(torch, prof)}", flush=True)
    print(f"hf_roberta launches: forward {json.dumps(launches)}; text tower {json.dumps(text_launches)}",
          flush=True)
    expect = hf_expected_launches(text_passes=HF_TEXT_TIMED, clip_vit_passes=HF_TEXT_TIMED)
    if launches != expect or text_launches != hf_expected_launches(text_passes=1):
        fail(f"hf_roberta launch counts {launches} / {text_launches}, expected {expect} and "
             f"{hf_expected_launches(text_passes=1)}")
    if not math.isfinite(loss.item()):
        fail(f"hf_roberta loss {loss.item()}")
    with torch.inference_mode():
        legs = {}
        for what, fn in (("text embedding", lambda m: m.encode_text(texts, normalize=True)),
                         ("image embedding", lambda m: m.encode_image(images, normalize=True))):
            k32, k16 = fn(model_f32), fn(model)
            with plain_path():
                legs[what] = (k32, k16, fn(model_f32))
    hf_parity(torch, "hf_roberta", legs)
    del model_f32, legs
    reset_counts()
    t1 = time.perf_counter()
    loss = step(model)
    loss.backward()
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t1) * 1e3
    paths["hf_roberta_backward"] = launches = read_counts()
    # the RoBERTa trunk's pooler is built (as the JAX trunk keeps it) but the
    # mean pooler never reads it
    grads = {n: p.grad for n, p in model.named_parameters()
             if n != "logit_scale" and not n.startswith("text.transformer.pooler.")}
    finite = all(g is not None and torch.isfinite(g).all().item() for g in grads.values())
    norms = {t: torch.sqrt(sum((g.float() ** 2).sum() for n, g in grads.items() if n.startswith(t))).item()
             for t in ("visual.", "text.")}
    print(f"hf_roberta backward of clip_loss into both towers, bf16: forward + backward {bwd_ms:.3f} ms (one "
          f"call), loss {loss.item():.5f}, {len(grads)} gradients finite {finite}, norms {json.dumps(norms)}; "
          f"launches {json.dumps(launches)}", flush=True)
    expect = hf_expected_launches(text_passes=1, text_backwards=1, clip_vit_passes=1, clip_vit_backwards=1)
    if launches != expect:
        fail(f"hf_roberta backward launch counts {launches}, expected {expect}")
    if not finite:
        fail("hf_roberta backward: a gradient is missing or not finite")
    del model, grads
    torch.cuda.empty_cache()
    print(f"hf phase: {time.perf_counter() - t0:.1f} s (bar 25 s)", flush=True)
    return paths


def stats(got, want, width=None) -> dict:
    """max abs, mean abs and min row cosine of two tensors; ``width`` cuts
    both into rows of that many values first (a last axis of 3 anchors is
    too narrow for a row cosine to mean anything)."""
    got, want = got.float(), want.float()
    if width is not None:
        n = got.numel() // width * width
        got, want = got.reshape(-1)[:n].reshape(-1, width), want.reshape(-1)[:n].reshape(-1, width)
    diff = (got - want).abs()
    return dict(max_abs=diff.max().item(), mean_abs=diff.mean().item(), min_cos=min_row_cos(got, want))


def matched(torch, ref, other, top=None):
    """One-to-one greedy matching at IoU > 0.5 of the reference's positive
    detections (the ``top`` best by score, or all) to the other leg's, per
    image: (reference detections, matched, matched with the same label, max
    score difference of a matched pair)."""
    from clipself_tpu_torch.detector.boxes import box_iou

    n_ref = n_match = same = 0
    drift = 0.0
    for (rb, rs, rl), (ob, os_, ol) in zip(zip(*ref), zip(*other)):
        order = torch.argsort(rs, descending=True, stable=True)
        order = order[rs[order] > 0][:top]
        iou = box_iou(rb[order].float(), ob.float())
        iou[:, os_ <= 0] = -1.0
        for j, row in zip(order.tolist(), iou):
            n_ref += 1
            m = int(row.argmax())
            if row[m] > 0.5:
                iou[:, m] = -1.0
                n_match += 1
                same += int(ol[m] == rl[j])
                drift = max(drift, abs(float(os_[m] - rs[j])))
    return n_ref, n_match, same, drift


def phase_detector(torch, dev, preset):
    """`evaluate_detector` at a full preset under its own protocol: OV-COCO,
    or OV-LVIS (1203 classes, frequency groups) on items with the LVIS
    fields, LVIS v1's annotations and classes an image and a resize scale
    other than 1; box AP, and mask AP with the preset's mask head. Prints the
    host's share of a batch by stage. Returns what the parity phase reuses
    and the launch counts of the timed run."""
    import numpy as np

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.data.synthetic import class_embeddings
    from clipself_tpu_torch.detector.classes import base_novel_mask, preset_split
    from clipself_tpu_torch.detector.config import PRESETS
    from clipself_tpu_torch.detector.data import (
        SyntheticDetectionData, collate, lvis_ground_truth, synthetic_eval_items,
    )
    from clipself_tpu_torch.detector.evaluate import evaluate_detector, make_predict_fn, metrics_json
    from clipself_tpu_torch.detector.fvit import create_detector
    from clipself_tpu_torch.models.factory import create_model

    cfg = PRESETS[preset]
    name, split = preset_split(preset)
    lvis = name == "lvis"
    layers = get_model_config(cfg.clip_model).vision.layers
    clip = create_model(cfg.clip_model, device=dev, dtype=torch.bfloat16, seed=SEED)
    det = create_detector(cfg, device=dev, seed=SEED + 1)
    emb = class_embeddings(cfg.num_classes + 1, cfg.embed_dim, seed=SEED)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    data = SyntheticDetectionData(
        cfg.num_classes, cfg.image_size, cfg.max_gt, seed=SEED, with_mask=cfg.with_mask
    )

    def batches(n, seed):
        out = []
        for i in range(n):
            batch = data.batch(DET_BATCH)
            if lvis:
                out += synthetic_eval_items(
                    lvis_ground_truth(batch, seed + i), num_classes=cfg.num_classes, seed=seed + i
                )
            else:
                out += synthetic_eval_items(batch)
        return out

    def run(its, timings=None):
        return evaluate_detector(
            det, clip, its, cfg, emb, device=dev, dataset_name=name, batch_size=DET_BATCH,
            split=split, timings=timings,
        )

    run(batches(DET_WARMUP, SEED + 100))  # warm-up
    items = batches(DET_BATCHES, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timings = {}
    t0 = time.perf_counter()
    metrics = run(items, timings)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    n_anchors = sum(3 * math.ceil(cfg.image_size / s) ** 2 for s in cfg.anchors.strides)
    tag = f"detector {'lvis ' if lvis else ''}eval {preset}"
    summ = timings.pop("summarize")
    per_batch = (dt - summ) / DET_BATCHES
    share = {k: round(v / DET_BATCHES * 1e3, 3) for k, v in timings.items()}
    scales = [float(it["scale"]) for it in items]
    gts = [len(it["_gt_labels_full"]) for it in items]
    print(
        f"{tag} ({cfg.clip_model}, {layers} blocks, {name} protocol"
        f"{', mask head, masks pasted at stride 4 of the original image' if cfg.with_mask else ''}): "
        f"{DET_BATCHES} batches x {DET_BATCH} images {cfg.image_size}px (scales "
        f"{min(scales):.3f}-{max(scales):.3f}, {sum(gts) / len(gts):.2f} gts an image), {n_anchors} "
        f"anchors, {cfg.test_proposals.nms_pre} -> {cfg.test_proposals.max_per_img} proposals, "
        f"{cfg.num_classes} classes, bf16: {dt:.3f} s after {DET_WARMUP} warm-up batches, "
        f"{dt / DET_BATCHES * 1e3:.3f} ms a batch, {len(items) / dt:.3f} images/s; without the "
        f"summaries (once a run, {summ * 1e3:.3f} ms) {per_batch * 1e3:.3f} ms a batch, "
        f"{DET_BATCH / per_batch:.3f} images/s; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; host ms a batch by stage "
        f"{json.dumps(share)} (predict synced; copy: the outputs back to the host; paste: masks "
        f"and gt rasters; match: an image's detections against its gts)",
        flush=True,
    )
    print(f"{tag} metrics " + metrics_json(metrics, sort_keys=True), flush=True)
    print(f"{tag} launches {json.dumps(launches)}", flush=True)
    keys = (
        {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR@300", "APr", "APc", "APf",
         "mAP", "mAP_rare", "mAP_common", "mAP_frequent"}
        if lvis else {"mAP", "AP50", "AP75", "AP50_base", "AP50_novel"}
    )
    if set(metrics) != keys | ({f"segm_{k}" for k in keys} if cfg.with_mask else set()):
        fail(f"{tag}: metric keys {sorted(metrics)}")
    # OV-COCO: every synthetic image has ground truth of base and novel
    # classes, so no group is empty and each metric is a number in [0, 1].
    # OV-LVIS: a group without ground truth is -1 (the lvis-api sentinel) or
    # NaN; a value is finite in [-1, 1], or null in the strict JSON
    lo = -1.0 if lvis else 0.0
    bad = {k: v for k, v in json.loads(metrics_json(metrics)).items()
           if (v is None and not lvis) or (v is not None and not (math.isfinite(v) and lo <= v <= 1.0))}
    if bad:
        fail(f"{tag}: metrics out of range or not finite: {bad}")
    expect = expected_launches(layers, dets=DET_BATCHES)
    if launches != expect:
        fail(f"{tag} launch counts {launches}, expected {expect}")
    # one batch's raw outputs (after the counts were read)
    batch = collate(items[:DET_BATCH])
    boxes, scores, labels = make_predict_fn(
        det, clip, cfg, torch.as_tensor(emb, device=dev),
        torch.as_tensor(base_novel_mask(split=split), device=dev),
    )(torch.as_tensor(batch["images"], device=dev), torch.as_tensor(batch["valid_hw"], device=dev))[:3]
    want = (DET_BATCH, cfg.rcnn_test.max_per_img)
    live = scores > 0
    print(
        f"{tag} predict outputs: boxes {list(boxes.shape)}, scores {list(scores.shape)}, labels "
        f"{list(labels.shape)}; detections an image {live.sum(dim=1).tolist()}, best score "
        f"{scores.max().item():.4f}",
        flush=True,
    )
    if boxes.shape != want + (4,) or scores.shape != want or labels.shape != want:
        fail(f"{tag}: detections of shape {boxes.shape}, {scores.shape}, {labels.shape}")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores[live]).all() and live.any()):
        fail(f"{tag}: non-finite or no detections")
    if not ((labels[live] >= 0) & (labels[live] < cfg.num_classes)).all() or (labels[~live] != -1).any():
        fail(f"{tag}: detection labels out of range")
    return cfg, clip, det, emb, items, launches


def phase_detector_parity(torch, dev, preset, cfg, clip_bf16, det, emb, items):
    from clipself_tpu_torch.detector.classes import base_novel_mask
    from clipself_tpu_torch.detector.data import collate
    from clipself_tpu_torch.detector.fvit import backbone_taps
    from clipself_tpu_torch.models.factory import create_model

    batch = collate(items[:DET_PARITY_IMAGES])
    images = torch.as_tensor(batch["images"], device=dev)
    ce = torch.as_tensor(emb, device=dev)
    bm = torch.as_tensor(base_novel_mask("coco"), device=dev)
    gen = torch.Generator().manual_seed(SEED)
    shape = (DET_PARITY_IMAGES, DET_FIXED_ROIS, 2)
    lo = torch.rand(shape, generator=gen) * 0.6 * cfg.image_size
    ext = (0.1 + 0.25 * torch.rand(shape, generator=gen)) * cfg.image_size
    rois = torch.cat([lo, torch.clamp(lo + ext, max=cfg.image_size)], -1).to(dev)
    clip_f32 = create_model(cfg.clip_model, device=dev, dtype=torch.float32, seed=SEED)
    torch.cuda.reset_peak_memory_stats()

    def leg(clip):
        """Every compared tensor of one path, and its detections."""
        reset_counts()
        with torch.inference_mode():
            taps, dense = backbone_taps(clip, images, cfg, True)
            _, smap, _ = det.features(taps)
            logits, deltas = det(taps, rois, ce)
            _, props, pscores = det.proposals(taps)
            dets = det.predict(taps, dense, ce, bm)
        torch.cuda.synchronize()
        out = dict(
            taps=torch.cat([t.reshape(-1, t.shape[-1]) for t in taps]),
            dense=dense.reshape(-1, dense.shape[-1]),
            rpn=torch.cat([m.reshape(-1) for m in smap]),
            logits=logits, deltas=deltas, props=props, pscores=pscores, dets=dets,
        )
        return out, (taps, dense), read_counts()

    k16, _, counts16 = leg(clip_bf16)
    k32, (taps32, dense32), counts32 = leg(clip_f32)
    for name, counts in (("bf16", counts16), ("f32", counts32)):
        if counts["nms"] != 3 or not counts["flash_attention"]:  # proposals, then predict's two
            fail(f"detector {preset} {name} kernel leg launches {counts}")
    with plain_path():
        p32, _, _ = leg(clip_f32)
    del clip_f32

    shapes = f"{preset}, {DET_PARITY_IMAGES} images"
    rows = (
        (f"backbone taps {cfg.image_size}", "taps", None), ("dense vlm map", "dense", None),
        ("rpn objectness maps", "rpn", 1024),
        (f"bbox-head cls logits ({DET_FIXED_ROIS} fixed rois an image)", "logits", None),
        (f"bbox-head box deltas ({DET_FIXED_ROIS} fixed rois an image)", "deltas", None),
    )
    for tag, leg_out in (("bf16 kernels", k16), ("f32 kernels", k32)):
        for title, key, width in rows:
            st = stats(leg_out[key], p32[key], width)
            print(
                f"detector parity {shapes}, {tag} vs f32 plain: {title}: max_abs "
                f"{st['max_abs']:.3e} mean_abs {st['mean_abs']:.3e} min_cos {st['min_cos']:.6f}",
                flush=True,
            )
            if not all(map(math.isfinite, st.values())):
                fail(f"detector parity {preset} {tag} {title}: non-finite")
            if tag == "bf16 kernels":
                bar = PATH_BF16_MIN_COS if key == "dense" else DET_BF16_MIN_COS_FLOOR
                if not st["min_cos"] >= bar:
                    fail(f"detector {preset} {tag} {title}: min cosine {st['min_cos']} (bar {bar})")
            else:
                bar = PATH_F32_MAX_ABS if key == "dense" else DET_F32_MAX_ABS
                if not st["max_abs"] <= bar:
                    fail(f"detector {preset} {tag} {title}: max abs {st['max_abs']} (bar {bar})")

    for tag, leg_out in (("bf16 kernels", k16), ("f32 kernels", k32)):
        for top in (10, None):
            n_ref, n_match, same, drift = matched(torch, p32["dets"], leg_out["dets"], top)
            print(
                f"detector parity {preset} detections, f32 plain vs {tag}: "
                f"{'top %d an image' % top if top else 'all positive'}: {n_match}/{n_ref} matched "
                f"one to one at IoU > 0.5, {same}/{n_match} same label, max score drift {drift:.4f}",
                flush=True,
            )
            if tag == "f32 kernels" and top and not n_match == same == n_ref:
                fail(f"{preset}: the f32 kernel path lost one of the plain path's top detections")

    # the NMS kernel alone: the same float32 taps through `predict` with the
    # kernel and with the plain NMS; everything else is the same code on
    # the same values, so proposals and detections must be equal bit for bit
    with torch.inference_mode():
        with plain_nms():
            _, props_p, pscores_p = det.proposals(taps32)
            dets_p = det.predict(taps32, dense32, ce, bm)
    pairs = zip((k32["props"], k32["pscores"], *k32["dets"]), (props_p, pscores_p, *dets_p))
    equal = [torch.equal(a, b) for a, b in pairs]
    n_props = (pscores_p > -1e9).sum(dim=1).tolist()
    n_dets = (dets_p[1] > 0).sum(dim=1).tolist()
    print(
        f"detector parity {preset}, f32 taps, NMS kernel vs plain NMS: proposals, scores, detections' boxes, "
        f"scores, labels equal bit for bit: {equal} ({n_props} proposals, {n_dets} detections)",
        flush=True,
    )
    if not all(equal):
        fail(f"{preset}: predict with the NMS kernel differs from predict with the plain NMS")
    print(
        f"detector parity {preset} peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"({DET_PARITY_IMAGES} images; the float32 legs keep the RoI-align's y-stage in float32)",
        flush=True,
    )


def phase_detector_train(torch, dev, preset, warmup, timed, logs_dir) -> dict:
    """The detector's training entry point, `detector.train.main`, at a full
    preset: batch 8, bf16, the recipe's AdamW, synthetic batches."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.detector import train as det_train
    from clipself_tpu_torch.detector.config import PRESETS
    from clipself_tpu_torch.detector.fvit import create_detector
    from clipself_tpu_torch.detector.rpn import num_anchors

    cfg = PRESETS[preset]
    layers = get_model_config(cfg.clip_model).vision.layers
    steps = warmup + timed
    tag = f"detector train {preset}"
    argv = [
        "--synthetic", "--preset", preset, "--device", str(dev), "--batch-size", str(DET_BATCH),
        "--epochs", "1", "--steps-per-epoch", str(steps), "--log-every", "1", "--seed", str(SEED),
        "--output", os.path.join(logs_dir, preset),
    ]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        run = det_train.main(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        saved = os.path.isfile(os.path.join(logs_dir, preset, "detector_epoch0.pkl"))
    finally:
        shutil.rmtree(logs_dir, ignore_errors=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = run["history"]
    step_ms = [h["step_ms"] for h in hist]
    median_ms = statistics.median(step_ms[warmup:])
    ips = DET_BATCH / median_ms * 1e3
    last = hist[-1]["metrics"]
    print(
        f"{tag} ({cfg.clip_model} frozen, {layers} blocks; {cfg.image_size}px, "
        f"{num_anchors(cfg)} anchors, {cfg.rpn_sample.num} anchors and {cfg.rcnn_sample.num} rois sampled an image, "
        f"{cfg.num_classes} classes{', mask head' if cfg.with_mask else ''}): batch {DET_BATCH}, bf16, "
        f"AdamW: {timed} timed steps after {warmup} warm-up, median step {median_ms:.3f} ms, "
        f"{ips:.3f} images/s (ms per step {[round(t, 3) for t in step_ms[warmup:]]}; warm-up "
        f"{[round(t, 3) for t in step_ms[:warmup]]}; a step: batch copied in, taps, loss, "
        "backward, AdamW, metrics read back)",
        flush=True,
    )
    print(f"{tag} last step's metrics {json.dumps({k: round(v, 6) for k, v in last.items()})}", flush=True)
    print(f"{tag} peak memory {peak_gib:.3f} GiB (max_memory_allocated)", flush=True)
    print(f"{tag} launches {json.dumps(launches)}", flush=True)
    if len(hist) != steps or not saved:
        fail(f"{tag}: {len(hist)} logged steps of {steps}, checkpoint written: {saved}")
    for h in hist:
        # a non-finite gradient entry makes the global norm non-finite
        if not all(map(math.isfinite, h["metrics"].values())) or not h["metrics"]["grad_norm"] > 0:
            fail(f"{tag} step {h['step']} metrics {h['metrics']}")
        if cfg.with_mask and "loss_mask" not in h["metrics"]:
            fail(f"{tag} step {h['step']}: no mask loss")
    expect = expected_launches(layers, det_steps=steps)
    if launches != expect:
        fail(f"{tag} launch counts {launches}, expected {expect}")
    init = create_detector(cfg, device=dev, seed=SEED).state_dict()
    for name, p in run["state"].model.state_dict().items():
        if not torch.isfinite(p).all() or torch.equal(p, init[name]):
            fail(f"{tag}: parameter {name} is not finite or did not move")
    print(f"{tag} checks: metrics finite every step, every parameter moved, the trunk ran no backward", flush=True)
    del run
    torch.cuda.empty_cache()
    return dict(median_ms=median_ms, images_per_sec=ips, peak_gib=peak_gib, launches=launches)


def phase_detector_train_parity(torch, dev):
    """One detector train step at batch 2 on three legs from the same
    detector weights, batch and sampler noise: the plain f32 path, f32
    kernels and bf16 kernels. Each leg's RoI stage takes the plain leg's
    proposals, so that a proposal that flips at the top-k cut cannot hide a
    fault behind another sampling of the rois."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.data.synthetic import class_embeddings
    from clipself_tpu_torch.detector.classes import class_weights
    from clipself_tpu_torch.detector.config import PRESETS
    from clipself_tpu_torch.detector.data import SyntheticDetectionData
    from clipself_tpu_torch.detector.fvit import backbone_taps, create_detector
    from clipself_tpu_torch.detector.rpn import RPNOut, flatten_rpn_outputs, num_anchors, rpn_proposals
    from clipself_tpu_torch.detector.targets import draw_noise
    from clipself_tpu_torch.models.factory import create_model

    cfg = PRESETS[DET_PRESET]
    layers = get_model_config(cfg.clip_model).vision.layers
    host = SyntheticDetectionData(cfg.num_classes, cfg.image_size, cfg.max_gt, seed=SEED).batch(DET_PARITY_IMAGES)
    bt = {k: torch.as_tensor(v, device=dev) for k, v in host.items() if k not in ("scale", "image_id")}
    emb = class_embeddings(cfg.num_classes + 1, cfg.embed_dim, seed=SEED)
    emb /= (emb ** 2).sum(-1, keepdims=True) ** 0.5
    ce = torch.as_tensor(emb, device=dev)
    cw = torch.as_tensor(class_weights("coco", cfg.bg_weight), device=dev)
    det = create_detector(cfg, device=dev, seed=SEED + 1)
    noise = draw_noise(
        torch.Generator(device=dev).manual_seed(SEED), DET_PARITY_IMAGES, num_anchors(cfg),
        cfg.train_proposals.max_per_img + cfg.max_gt,
    )

    def leg(clip, plain, props=None):
        """loss, trainable gradients, own proposals, launches, taps."""
        det.zero_grad(set_to_none=True)
        reset_counts()
        with plain_path() if plain else contextlib.nullcontext():
            taps, _ = backbone_taps(clip, bt["images"], cfg, False)
            feats, l_rpn, _, *own = det.rpn_stage(taps, bt["gt_boxes"], bt["gt_valid"], noise, bt["valid_hw"])
            l_roi, _ = det.roi_stage(
                feats, *(own if props is None else props), bt["gt_boxes"], bt["gt_labels"],
                bt["gt_valid"], noise, ce, cw,
            )
            loss = l_rpn + l_roi
            loss.backward()
        torch.cuda.synchronize()
        grads = {n: q.grad.float().clone() for n, q in det.named_parameters()}
        return loss.item(), grads, own, read_counts(), taps

    clip32 = create_model(cfg.clip_model, device=dev, dtype=torch.float32, seed=SEED).requires_grad_(False)
    loss_p, g_p, props_p, _, _ = leg(clip32, plain=True)
    loss_k, g_k, props_k, counts_k, taps_k = leg(clip32, plain=False, props=props_p)
    # the NMS kernel on this leg's own RPN outputs against the plain NMS: equal bit for bit
    with torch.no_grad():
        _, smap, dmap = det.features(taps_k)
        rpn = flatten_rpn_outputs(smap, dmap, cfg)
        p = cfg.train_proposals
        args = ((cfg.image_size, cfg.image_size), p.nms_pre, p.max_per_img, p.iou_threshold, p.min_bbox_size)
        with plain_nms():
            own_plain = rpn_proposals(rpn, *args, valid_hw=bt["valid_hw"])
    nms_equal = all(torch.equal(x, y) for x, y in zip(props_k, own_plain))
    del clip32, taps_k, smap, dmap, rpn
    clip16 = create_model(cfg.clip_model, device=dev, dtype=torch.bfloat16, seed=SEED).requires_grad_(False)
    loss_h, g_h, _, counts_h, _ = leg(clip16, plain=False, props=props_p)
    del clip16
    torch.cuda.empty_cache()

    # the proposal sets of the f32 kernel leg against the plain leg's
    live_p, live_k = props_p[1] > -1e9, props_k[1] > -1e9
    flips = []
    for i in range(DET_PARITY_IMAGES):
        a, bk = props_p[0][i][live_p[i]], props_k[0][i][live_k[i]]
        d = torch.cdist(a, bk, p=float("inf")) if len(a) and len(bk) else None
        miss_p = (d.min(dim=1).values > 1e-2).nonzero().flatten().tolist() if d is not None else []
        miss_k = (d.min(dim=0).values > 1e-2).nonzero().flatten().tolist() if d is not None else []
        flips += [(i, "plain only", a[j].tolist()) for j in miss_p] + [(i, "kernels only", bk[j].tolist()) for j in miss_k]
    n_live = live_p.sum(dim=1).tolist()
    print(
        f"detector train parity {DET_PRESET}, {DET_PARITY_IMAGES} images: proposals an image plain "
        f"{n_live}, f32 kernels {live_k.sum(dim=1).tolist()}; {len(flips)} flip between the two legs "
        f"(no counterpart within 0.01 px); the NMS kernel on the f32 kernel leg's RPN outputs against "
        f"the plain NMS: equal bit for bit {nms_equal}",
        flush=True,
    )
    for f in flips[:20]:
        print(f"detector train parity proposal flip: image {f[0]}, {f[1]}, box {[round(x, 3) for x in f[2]]}", flush=True)

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()

    def flat(g, prefix=""):
        return torch.cat([v.flatten() for k, v in g.items() if k.startswith(prefix)])

    cos_k = cos(flat(g_k), flat(g_p))
    rel_k = max((g_k[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30) for n, w in g_p.items())
    groups = {grp: cos(flat(g_h, grp + "."), flat(g_p, grp + ".")) for grp in DET_TRAIN_GROUPS}
    per_tensor = {n: cos(g_h[n], w) for n, w in g_p.items()}
    worst = min(per_tensor, key=per_tensor.get)
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(
        f"detector train parity losses: f32 plain {loss_p:.7f}, f32 kernels {loss_k:.7f} (rel {d_loss:.3e}, "
        f"bar {DET_TRAIN_LOSS_MAX_REL}), bf16 kernels {loss_h:.7f}",
        flush=True,
    )
    print(
        f"detector train parity gradients ({len(g_p)} trainable tensors): f32 kernels vs f32 plain cosine "
        f"{cos_k:.7f} (bar {DET_TRAIN_F32_MIN_COS}), max rel {rel_k:.3e} of a tensor's largest entry; "
        f"bf16 kernels vs f32 plain by group {json.dumps({k: round(v, 6) for k, v in groups.items()})} "
        f"(bar {DET_TRAIN_BF16_MIN_COS}), lowest single tensor {per_tensor[worst]:.6f} ({worst})",
        flush=True,
    )
    expect = expected_launches(layers, det_steps=1)
    for name, counts in (("f32", counts_k), ("bf16", counts_h)):
        if counts != expect:
            fail(f"detector train parity {name} kernel leg launches {counts}, expected {expect}")
    finite = all(torch.isfinite(g).all().item() for d in (g_p, g_k, g_h) for g in d.values())
    if not finite or not all(map(math.isfinite, (loss_p, loss_k, loss_h))):
        fail("detector train parity: non-finite loss or gradient")
    if not nms_equal:
        fail("detector train parity: the NMS kernel's proposals differ from the plain NMS's")
    if flips:
        fail(f"detector train parity: {len(flips)} proposals of the f32 kernel leg differ from the plain leg's")
    if not d_loss <= DET_TRAIN_LOSS_MAX_REL:
        fail(f"detector train parity: f32 kernel loss off by {d_loss} relative")
    if not cos_k >= DET_TRAIN_F32_MIN_COS:
        fail(f"detector train parity: f32 kernel gradient cosine {cos_k}")
    if not min(groups.values()) >= DET_TRAIN_BF16_MIN_COS:
        fail(f"detector train parity: bf16 kernel gradient cosines {groups}")


# ---------------------------------------------------------------------------
# the data phase: the trainer and the evaluator on files (B/16)

# COCO's common image sizes (w, h); the train files cycle them
DATA_SIZES = ((640, 480), (480, 640), (640, 427), (500, 375))
DATA_TRAIN, DATA_PROPOSALS, DATA_VAL = 16, 30, 4
# panoptic: 80 thing and 53 stuff categories; 6 thing and 4 stuff segments an image
PAN_THINGS, PAN_STUFF, SEG_THINGS, SEG_STUFF = 80, 53, 6, 4
# The windows that time the input pipeline. A loader's workers queue 2
# batches each (DataLoader's prefetch_factor) as soon as they start, and
# `device_prefetch` holds 2 more: that backlog is built before any step
# runs. So each timed window starts after as many batches as the backlog
# and is DATA_WINDOW times as long: batches built ahead of it are at most
# 1/DATA_WINDOW of it. The loaders alone: LOADER_TIMED batches after the
# workers' first 2 each. The grid run: DATA_PROFILED steps under the
# profiler after its timed window. proposals_distill: 1 + 2 steps, a check
# of the route, not timed.
DATA_WINDOW, LOADER_TIMED, DATA_PROFILED, PROP_STEPS = 2, 32, 4, 3


def photo(rng, w: int, h: int):
    """A photo-like RGB image: a smooth random field with some grain."""
    import numpy as np

    coarse = rng.uniform(0, 255, (h // 32 + 2, w // 32 + 2, 3))
    ys, xs = np.linspace(0, h // 32 + 1, h), np.linspace(0, w // 32 + 1, w)
    y0, x0 = ys.astype(int).clip(max=h // 32), xs.astype(int).clip(max=w // 32)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = coarse[y0][:, x0] * (1 - fx) + coarse[y0][:, x0 + 1] * fx
    bottom = coarse[y0 + 1][:, x0] * (1 - fx) + coarse[y0 + 1][:, x0 + 1] * fx
    field = top * (1 - fy) + bottom * fy + rng.normal(0, 6, (h, w, 3))
    return field.clip(0, 255).astype(np.uint8)


def write_corpus(root: str, embed_dim: int, entries: int, seed: int = SEED) -> dict:
    """The data phase's corpus under ``root``: `DATA_TRAIN` train PNGs and a
    COCO JSON of ``entries`` images that list them in turn (each entry is
    decoded anew, so an epoch is as long as the timed windows need), each
    file with `DATA_PROPOSALS` proposal boxes; panoptic val PNGs with their
    segment PNGs and JSON over 133 categories; a random class embedding.
    Returns the paths and the first train image's pixels."""
    import numpy as np

    from clipself_tpu_torch.data.image_io import encode_png

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, k) for k in ("train", "val", "segm")}
    for d in paths.values():
        os.makedirs(d, exist_ok=True)
    files, first = [], None
    for i in range(DATA_TRAIN):
        w, h = DATA_SIZES[i % len(DATA_SIZES)]
        pixels = photo(rng, w, h)
        first = pixels if first is None else first
        with open(os.path.join(paths["train"], f"{i:012d}.png"), "wb") as f:
            f.write(encode_png(pixels, "cycle"))
        boxes = []
        for _ in range(DATA_PROPOSALS):
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes.append([float(x), float(y), float(bw), float(bh)])
        files.append((f"{i:012d}.png", w, h, boxes))
    images, anns = [], []
    for i in range(entries):
        name, w, h, boxes = files[i % DATA_TRAIN]
        images.append({"id": i, "file_name": name, "width": w, "height": h})
        anns += [{"id": i * 100 + j, "image_id": i, "category_id": 1, "bbox": b, "area": b[2] * b[3]}
                 for j, b in enumerate(boxes)]
    train = {"images": images, "annotations": anns, "categories": [{"id": 1, "name": "object"}]}
    cats = [{"id": c + 1, "name": f"class{c}", "isthing": int(c < PAN_THINGS)}
            for c in range(PAN_THINGS + PAN_STUFF)]
    val_images, pan = [], []
    for i in range(DATA_VAL):
        w, h = DATA_SIZES[i % len(DATA_SIZES)]
        name = f"{1000 + i:012d}.png"
        with open(os.path.join(paths["val"], name), "wb") as f:
            f.write(encode_png(photo(rng, w, h), "cycle"))
        ids = np.zeros((h, w), np.int64)
        segments = []
        for s in range(SEG_STUFF):  # horizontal bands
            ids[s * h // SEG_STUFF : (s + 1) * h // SEG_STUFF] = s + 1
            segments.append({"id": s + 1, "category_id": int(rng.integers(PAN_THINGS, PAN_THINGS + PAN_STUFF)) + 1})
        for s in range(SEG_THINGS):  # boxes on top of them
            bw, bh = int(rng.integers(24, w // 3)), int(rng.integers(24, h // 3))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            seg_id = 1000 + 37 * s
            ids[y : y + bh, x : x + bw] = seg_id
            segments.append({"id": seg_id, "category_id": int(rng.integers(0, PAN_THINGS)) + 1,
                             "bbox": [x, y, bw, bh]})
        for seg in segments:
            ys, xs = np.nonzero(ids == seg["id"])
            seg["area"] = int(len(ys))
            seg.setdefault("bbox", [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                                    int(ys.max() - ys.min() + 1)])
        color = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        with open(os.path.join(paths["segm"], name), "wb") as f:
            f.write(encode_png(color, "cycle"))
        val_images.append({"id": 1000 + i, "file_name": name, "width": w, "height": h})
        pan.append({"image_id": 1000 + i, "file_name": name, "segments_info": segments})
    paths["train_json"] = os.path.join(root, "instances_train.json")
    paths["val_json"] = os.path.join(root, "panoptic_val.json")
    paths["embed"] = os.path.join(root, "embeddings.npy")
    with open(paths["train_json"], "w") as f:
        json.dump(train, f)
    with open(paths["val_json"], "w") as f:
        json.dump({"images": val_images, "annotations": pan, "categories": cats}, f)
    np.save(paths["embed"], rng.standard_normal((len(cats), embed_dim)).astype(np.float32))
    return paths, first


def host_item_ms(ds, paths: dict, s: Model) -> None:
    """One core's ms for the NumPy route's pieces on this host: a train PNG
    decoded, its det transform, a whole grid item and a panoptic eval item
    (the best of 3 each)."""
    from clipself_tpu_torch.data import datasets, image_io, transforms

    def best(fn) -> float:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    path = os.path.join(paths["train"], ds.coco.file_name(ds.image_ids[0]))
    img = image_io.open_image(path)
    val = datasets.COCOPanopticEvalDataset(
        paths["val_json"], paths["val"], paths["segm"], det_size=s.image, crop_size=s.crop,
        downsample_factor=s.vision.patch_size,
    )
    print(
        f"data host, one core: PNG decode {img.shape[1]}x{img.shape[0]} "
        f"{best(lambda: image_io.open_image(path)):.1f} ms, det transform to {s.image}^2 "
        f"{best(lambda: transforms.det_transform(img, s.image)):.1f} ms, grid item "
        f"({TRAIN_BOXES} crops at {s.crop}^2) {best(lambda: ds[0]):.1f} ms, panoptic eval item "
        f"({val.max_anns} segments) {best(lambda: val[0]):.1f} ms",
        flush=True,
    )


def native_headers() -> tuple[bool, str]:
    """Whether the C compiler finds libjpeg's and libpng's headers, which the
    native core's build needs (a preprocessor run each, before any build)."""
    missing = []
    for header in ("jpeglib.h", "png.h"):
        try:
            proc = subprocess.run(
                ["cc", "-E", "-"], input=f"#include <{header}>\n",
                capture_output=True, text=True, timeout=60,
            )
        except OSError as e:
            return False, f"cc: {e}"
        if proc.returncode != 0:
            missing.append(header)
    if missing:
        return False, f"not found by cc -E: {', '.join(missing)}"
    return True, "jpeglib.h and png.h found"


@contextlib.contextmanager
def profiled_steps(torch, start: int, stop: int, out: dict, trainer=None):
    """Profile the device over the trainer's steps ``start`` + 1 to
    ``stop``: the trainer's step function is wrapped so that after step
    ``start`` (the trainer has logged it, so the device is idle) the
    profiler starts and after step ``stop`` it stops; ``out`` gets the
    window's wall ms and the kernels' device ms (a host range mirrored onto
    the device's timeline is not a kernel and is left out, as in
    `tools/profile_paths.py`). ``trainer``: (module, name of the function
    there that makes the step), `train.main.make_train_step` by default."""
    from clipself_tpu_torch.train import main as train_main

    module, name = trainer or (train_main, "make_train_step")
    original = getattr(module, name)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def make(*args, **kwargs):
        step = original(*args, **kwargs)
        done = [0]

        def wrapped(state, batch):
            metrics = step(state, batch)
            done[0] += 1
            if done[0] in (start, stop):
                torch.cuda.synchronize()
                if done[0] == start:
                    out["prof"] = torch.profiler.profile(activities=acts)
                    out["prof"].start()
                    out["t0"] = time.perf_counter()
                else:
                    out["wall_ms"] = (time.perf_counter() - out["t0"]) * 1e3
                    out["prof"].stop()
            return metrics

        return wrapped

    setattr(module, name, make)
    try:
        yield
    finally:
        setattr(module, name, original)
    out["kernel_ms"] = kernel_ms(torch, out.pop("prof"))


def top_kernels(torch, prof, n: int = 8) -> str:
    """The ``n`` device kernels of a profiled window that took the most
    time, with their launches, and the number of kernel launches in all."""
    events = prof.key_averages()
    host = {ev.key for ev in events if ev.device_type == torch.autograd.DeviceType.CPU}
    dev = sorted((ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA and ev.key not in host),
                 key=lambda ev: -(getattr(ev, "self_device_time_total", 0) or 0))
    rows = [f"{ev.key[:48]} {ev.self_device_time_total / 1e3:.3f} ms ({ev.count})" for ev in dev[:n]]
    return f"{sum(ev.count for ev in dev)} launches; " + "; ".join(rows)


def kernel_ms(torch, prof) -> float:
    """The kernels' device ms of a profiled window (a host range mirrored
    onto the device's timeline is not a kernel and is left out, as in
    `tools/profile_paths.py`); fails if the profiler saw no device time."""
    events = prof.key_averages()
    host = {ev.key for ev in events if ev.device_type == torch.autograd.DeviceType.CPU}
    ms = sum(
        (getattr(ev, "self_device_time_total", 0) or 0) / 1e3 for ev in events
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.key not in host
    )
    if ms <= 0:
        fail("the profiler recorded no device time over the profiled window")
    return ms


def loader_rate(make_iter, skip: int, timed: int) -> tuple[float, float]:
    """(items/s over ``timed`` batches of ``TRAIN_BATCH`` items after the
    first ``skip``, seconds to the first batch) of a fresh iterator, nothing
    else running. The first ``skip`` batches are the ones the workers
    queue as they start, built during the start: leaving them out times the
    workers' own pace."""
    t0 = time.perf_counter()
    it = make_iter()
    first = start = None
    for n, _ in enumerate(zip(range(skip + timed), it)):
        if first is None:
            first = time.perf_counter()
        if n == skip - 1:
            start = time.perf_counter()
    rate = timed * TRAIN_BATCH / (time.perf_counter() - start)
    if hasattr(it, "close"):
        it.close()
    return rate, first - t0


def pinned_copy_ms(torch, dev, s: Model) -> tuple[float, int]:
    """Device ms of one train batch's host-to-device copy from pinned
    memory on a side stream, as `device_prefetch` issues it, and its bytes."""
    host = {
        "images": torch.zeros(TRAIN_BATCH, s.image, s.image, 3).pin_memory(),
        "boxes": torch.zeros(TRAIN_BATCH, TRAIN_BOXES, 5).pin_memory(),
        "crops": torch.zeros(TRAIN_BATCH, TRAIN_BOXES, s.crop, s.crop, 3).pin_memory(),
    }
    stream = torch.cuda.Stream(dev)

    def copy():
        with torch.cuda.stream(stream):
            return {k: v.to(dev, non_blocking=True) for k, v in host.items()}

    for _ in range(3):
        copy()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(10):
        copy()
    end.record(stream)
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10, nbytes(*host.values())


def phase_data(torch, dev, s: Model, logs_dir: str, synthetic: dict) -> dict:
    """The trainer and the evaluator on files at B/16's recipe: the loaders
    alone, grid_distill through the NumPy route and the native core,
    proposals_distill, and an evaluation-only run; launches checked equal
    to those of the synthetic step and evaluator at the same shapes."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.data import datasets, image_io, loader, native_loader
    from clipself_tpu_torch.train import main as train_main

    layers = s.vision.layers
    workers = min(os.cpu_count() or 1, 8)
    # batches built before a step runs: the workers' queue and device_prefetch's
    backlog = 2 * workers + loader.PREFETCH
    warmup, timed = backlog, DATA_WINDOW * backlog
    steps = warmup + timed + DATA_PROFILED
    # one pass holds every grid step and the loaders' windows
    entries = TRAIN_BATCH * max(steps, 2 * workers + LOADER_TIMED)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    paths, first = write_corpus(root, get_model_config(s.model).embed_dim, entries)
    print(
        f"data corpus: {DATA_TRAIN} train PNGs at {list(DATA_SIZES)} with {DATA_PROPOSALS} "
        f"proposals each, listed in turn as {entries} train images; {DATA_VAL} panoptic val PNGs "
        f"with {SEG_THINGS} thing and {SEG_STUFF} stuff segments over {PAN_THINGS + PAN_STUFF} "
        f"categories; rows filtered None/Sub/Up/Average/Paeth in turn; written in "
        f"{time.perf_counter() - t0:.2f} s; {workers} workers (os.cpu_count() {os.cpu_count()}, "
        f"capped at 8); backlog {backlog} batches (2 a worker, {loader.PREFETCH} in device_prefetch)",
        flush=True,
    )
    headers, why = native_headers()
    print(f"data native core: libjpeg/libpng headers: {why}", flush=True)
    if headers:
        t0 = time.perf_counter()
        native_loader.load()
        print(f"data native core built (make -C native) in {time.perf_counter() - t0:.2f} s", flush=True)
    else:
        print(f"data native core: NOT run, the --native-loader route needs the headers ({why})", flush=True)
    out = {}
    try:
        ds = datasets.GridDistillDataset(
            paths["train_json"], paths["train"], det_size=s.image, crop_size=s.crop,
            max_anns=TRAIN_BOXES, seed=SEED,
        )
        # the decoder on this host against the pixels the writer was given
        decoded = image_io.open_image(os.path.join(paths["train"], ds.coco.file_name(0)))
        if decoded is None or decoded.shape != first.shape or not (decoded == first).all():
            fail("data: the PNG decoder does not give back the written pixels")
        print(f"data check: a {first.shape[1]}x{first.shape[0]} train PNG (rows cycling the five "
              f"filters) decodes to the written pixels, equal", flush=True)
        host_item_ms(ds, paths, s)
        skip = 2 * workers
        rate, first = loader_rate(lambda: iter(loader.make_loader(
            ds, TRAIN_BATCH, num_workers=workers, pin_memory=True,
        )), skip, LOADER_TIMED)
        print(f"data loader alone, NumPy route ({workers} workers, pinned): {rate:.3f} items/s "
              f"over {LOADER_TIMED * TRAIN_BATCH} items after the first {skip} batches (the "
              f"workers' queue); the first batch came after {first:.3f} s (the fork server and "
              f"its workers starting)", flush=True)
        if headers:
            native = loader.NativeDistillLoader(ds, TRAIN_BATCH, seed=SEED, num_threads=workers)
            rate, first = loader_rate(lambda: iter(native), 2, LOADER_TIMED)
            native.close()
            print(f"data loader alone, native route ({workers} threads): {rate:.3f} items/s over "
                  f"{LOADER_TIMED * TRAIN_BATCH} items after the first 2 batches (its double "
                  f"buffer); the first came after {first:.3f} s; rows built by the NumPy route "
                  f"{native.fallback_rows}", flush=True)
        copy_ms, copy_bytes = pinned_copy_ms(torch, dev, s)
        print(f"data pinned copy of one train batch ({copy_bytes / 2 ** 20:.1f} MiB, side stream): "
              f"{copy_ms:.3f} ms, {copy_bytes / copy_ms / 1e6:.3f} GB/s", flush=True)

        val = ["--val-data", paths["val_json"], "--val-image-root", paths["val"],
               "--val-segm-root", paths["segm"], "--embed-path", paths["embed"]]
        common = [
            "--model", s.model, "--precision", "bf16", "--device", str(dev),
            "--batch-size", str(TRAIN_BATCH), "--det-image-size", str(s.image),
            "--max-boxes", str(TRAIN_BOXES), "--lock-image-unlocked-groups", str(layers),
            "--epochs", "1", "--log-every-n-steps", "1", "--lr", "1e-5", "--warmup", "1",
            "--seed", str(SEED), "--workers", str(workers), "--logs", logs_dir,
        ]
        train = ["--train-data", paths["train_json"], "--train-image-root", paths["train"]]
        synthetic_ms = 1e3 * TRAIN_BATCH / synthetic["images_per_sec"]
        runs = [("proposals", ["--dataset-type", "proposals_distill", "--steps-per-epoch",
                               str(PROP_STEPS)], PROP_STEPS)]
        runs.append(("grid", ["--dataset-type", "grid_distill", "--steps-per-epoch", str(steps)], steps))
        if headers:
            runs.append(("native", ["--dataset-type", "grid_distill", "--native-loader",
                                    "--steps-per-epoch", str(steps)], steps))
        kernel_ms = None
        for key, extra, n_steps in runs:
            tag = f"{s.key} data {key}"
            prof = {}
            reset_counts()
            # the grid runs: after the timed window, DATA_PROFILED steps under the profiler
            with contextlib.nullcontext() if key == "proposals" else \
                    profiled_steps(torch, warmup + timed, steps, prof):
                run = train_main.main(common + train + val + extra + ["--name", f"data_{key}"])
            torch.cuda.synchronize()
            launches = read_counts()
            hist = run["history"]
            losses = [h["loss"] for h in hist]
            print(f"{tag} losses {json.dumps([round(x, 6) for x in losses])}", flush=True)
            if key != "proposals":
                step_ms = [TRAIN_BATCH / h["images_per_sec"] * 1e3 for h in hist]
                window = step_ms[warmup : warmup + timed]
                median_ms = statistics.median(window)
                mean_ips = TRAIN_BATCH * len(window) / sum(window) * 1e3
                kernel_ms = prof["kernel_ms"] / DATA_PROFILED
                prof_ms = prof["wall_ms"] / DATA_PROFILED
                print(
                    f"{tag} {s.model} step from files: batch {TRAIN_BATCH} at {s.image}px, "
                    f"{TRAIN_BOXES} boxes, {timed} timed steps after {warmup} warm-up (the "
                    f"backlog), median step {median_ms:.3f} ms, {TRAIN_BATCH / median_ms * 1e3:.3f} "
                    f"images/s; over the window {mean_ips:.3f} images/s (images over its time); the "
                    f"synthetic staged step in this call {synthetic_ms:.3f} ms",
                    flush=True,
                )
                print(
                    f"{tag} device idle share over {DATA_PROFILED} profiled steps after the window "
                    f"{1 - prof['kernel_ms'] / prof['wall_ms']:.1%}: kernel time {kernel_ms:.3f} ms "
                    f"a step, wall {prof_ms:.3f} ms a step under the profiler",
                    flush=True,
                )
                print(f"{tag} ms per step: warm-up {[round(t, 3) for t in step_ms[:warmup]]}, "
                      f"timed {[round(t, 3) for t in window]}", flush=True)
            print(f"{tag} evals " + json.dumps(run["evals"], sort_keys=True), flush=True)
            print(f"{tag} launches {json.dumps(launches)}", flush=True)
            if key == "native":
                print(f"{tag} rows built by the NumPy route: {run['native_fallback_rows']}", flush=True)
            if len(losses) != n_steps or not all(map(math.isfinite, losses)):
                fail(f"{tag} losses {losses}")
            check_evals(tag, run["evals"], 2)
            expect = expected_launches(layers, steps=n_steps, evals=len(run["evals"]) * DATA_VAL)
            if launches != expect:
                fail(f"{tag} launch counts {launches}, expected {expect} (the synthetic step's and "
                     f"evaluator's at these shapes)")
            out[f"{s.key}_train_{key}"] = launches
            del run
            torch.cuda.empty_cache()
        print(f"{s.key} data: synthetic staged step {synthetic_ms:.3f} ms, its idle share derived "
              f"from the grid run's kernel time a step {1 - kernel_ms / synthetic_ms:.1%}", flush=True)

        tag = f"{s.key} data eval_only"
        reset_counts()
        t0 = time.perf_counter()
        run = train_main.main(common + val + ["--name", "data_eval_only"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts()
        print(f"{tag} {s.model}: {DATA_VAL} val images at batch 1 in {dt:.3f} s (model build "
              f"included, its initial weights drawn once a run: `drawn_once`), metrics "
              + json.dumps(run["evals"], sort_keys=True), flush=True)
        print(f"{tag} launches {json.dumps(launches)}", flush=True)
        check_evals(tag, run["evals"], 1)
        expect = expected_launches(layers, evals=DATA_VAL)
        if launches != expect:
            fail(f"{tag} launch counts {launches}, expected {expect}")
        out[f"{s.key}_eval_files"] = launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(logs_dir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the RegionCLIP phase: `train.main --dataset-type region_clip` on files, a
# staged batch, one step's parity (B/16 at the recipe's batch; L/14)

# the recipe's noun matrix has a row per class of coco_pseudo_4764.json; its
# --max-boxes default; the B/16 recipe's global batch (one card holds it
# without a teacher) and L/14 at batch 2 (with --grad-checkpointing once)
REGION_NOUNS, REGION_BOXES, REGION_BATCH, REGION_L14_BATCH = 4764, 20, 16, 2
# recipe alphas (scripts/train_regionclip_coco_eva_vit{b16,l14}.sh)
REGION_ALPHA = {"b16": 0.7, "l14": 0.95}
# from files (B/16): warm-up = the loader's backlog, then REGION_WINDOW times
# as many timed steps, then REGION_PROFILED under the profiler. The loader is
# ~3x slower than the device at batch 16 (an H100 80GB HBM3 at 700 W with 8
# workers: 21.9-30.4 against 77.5-79.3 images/s), so its backlog of 18 batches
# drains in ~7-10 steps: the warm-up leaves none of it to the window. The flags run: 2 epochs of 2 micro-steps
# with --accum-freq 2 at batch 2 (its checkpoints, ~2.2 GB each, and a loader
# an epoch set its time, not its batch); staged: 3 + 1 warm-up steps on one
# corpus batch, REGION_STAGED timed, then REGION_STAGED under the profiler;
# L/14: 1 + 3 steps from files, then 1 with --grad-checkpointing
REGION_WINDOW, REGION_PROFILED, REGION_STAGED = 1, 4, 5
REGION_L14_STEPS, REGION_FLAGS_BATCH = 4, 2
# parity: one step at batch 1 (L/14 at s.parity_layers blocks), the
# federated sampling of REGION_SAMPLE classes per step (the loss's default)
REGION_PARITY_BATCH, REGION_SAMPLE = 1, 100


def write_region_json(paths: dict, seed: int = SEED) -> str:
    """A region-noun pseudo-label JSON over the corpus's train images (as
    `coco_pseudo_4764.json` is over COCO's): each image listed in
    `paths["train_json"]` gets 1 to `REGION_BOXES` of its proposal boxes, each
    with a category drawn from `REGION_NOUNS` ids; returns its path."""
    import numpy as np

    rng = np.random.default_rng(seed + 13)
    with open(paths["train_json"]) as f:
        train = json.load(f)
    by_image = {}
    for ann in train["annotations"]:
        by_image.setdefault(ann["image_id"], []).append(ann["bbox"])
    anns = []
    for img in train["images"]:
        boxes = by_image[img["id"]][: int(rng.integers(1, REGION_BOXES + 1))]
        anns += [{"id": len(anns) + 1, "image_id": img["id"], "bbox": b, "area": b[2] * b[3],
                  "category_id": int(rng.integers(1, REGION_NOUNS + 1))} for b in boxes]
    path = os.path.join(os.path.dirname(paths["train_json"]), "region_pseudo.json")
    with open(path, "w") as f:
        json.dump({"images": train["images"], "annotations": anns,
                   "categories": [{"id": c + 1, "name": f"noun{c}"} for c in range(REGION_NOUNS)]}, f)
    return path


def write_nouns(root: str, embed_dim: int, seed: int = SEED) -> str:
    """A seeded, L2-normalized [REGION_NOUNS, embed_dim] noun matrix .npy."""
    import numpy as np

    emb = np.random.default_rng(seed + 17).standard_normal((REGION_NOUNS, embed_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    path = os.path.join(root, "nouns.npy")
    np.save(path, emb)
    return path


def staged_region_steps(torch, dev, s: Model, batch: dict, nouns, tag: str) -> dict:
    """The smoke script's own harness: the trainer's model, optimizer, step
    and loss on one corpus batch staged on the card and repeated: 3 warm-up
    steps, each loss read back, then `tools/profile_paths.py::measure`: one
    more, `REGION_STAGED` synchronised steps (ms a step, peak memory) and
    `REGION_STAGED` under the profiler (kernel classes, idle share)."""
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.tools.profile_paths import measure, report
    from clipself_tpu_torch.train.methods import make_regionclip_loss
    from clipself_tpu_torch.train.optim import build_optimizer, make_schedule
    from clipself_tpu_torch.train.step import TrainState, make_train_step

    layers = s.vision.layers
    model = create_model(s.model, device=dev, dtype=torch.bfloat16, seed=SEED)
    opt = build_optimizer(model, make_schedule("cosine", 1e-5, 1, 100), unlocked_groups=layers,
                          num_layers=layers)
    state = TrainState(model, opt)
    step = make_train_step(make_regionclip_loss(nouns, SEED), None)
    losses = [float(step(state, batch)["loss"]) for _ in range(3)]
    reset_counts()
    b = batch["images"].shape[0]
    res = measure(lambda: step(state, batch), REGION_STAGED, dev, b)
    launches = read_counts()
    report(f"{tag} staged {s.model} RegionCLIP step, batch {b} at {s.image}px, {REGION_BOXES} "
           f"boxes, {REGION_NOUNS} nouns, {layers} blocks unlocked, bf16", "step", res)
    print(f"{tag} staged: {res['wall_ms']:.3f} ms a step, {res['images_per_sec']:.3f} images/s over "
          f"{REGION_STAGED} synchronised steps; kernels {res['kernel_ms']:.3f} ms a step, device idle "
          f"{res['idle_share_derived']:.1%} (derived) / {res['idle_share_profiled']:.1%} (under the "
          f"profiler); peak {res['peak_gib']:.3f} GiB; warm-up losses "
          f"{json.dumps([round(x, 6) for x in losses])}", flush=True)
    print(f"{tag} staged launches {json.dumps(launches)}", flush=True)
    if not all(map(math.isfinite, losses)):
        fail(f"{tag} staged losses {losses}")
    expect = expected_launches(layers, region_steps=2 * REGION_STAGED + 1)  # measure's warm-up too
    if launches != expect:
        fail(f"{tag} staged launch counts {launches}, expected {expect}")
    del state, model, opt
    torch.cuda.empty_cache()
    return dict(ms=res["wall_ms"], launches=launches)


def phase_region_parity(torch, dev, s: Model, batch: dict, nouns) -> None:
    """One RegionCLIP step's loss and trainable gradients from the same
    weights, batch and noise on f32 kernels, bf16 kernels and the f32 plain
    path (L/14 at `parity_layers` blocks); the federated class mask of the
    three legs EQUAL, sampling classes that no box carries."""
    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.train.methods import _fed_class_mask, fed_loss_noise, regionclip_loss
    from clipself_tpu_torch.train.optim import trainable_labels

    cfg = get_model_config(s.model)
    if s.parity_layers is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, layers=s.parity_layers))
    layers = cfg.vision.layers
    noise = fed_loss_noise(SEED, 0, REGION_NOUNS, dev)
    boxes = batch["boxes"]
    labels, valid = boxes[..., 4].long().reshape(-1), (boxes[..., 5] > 0.5).reshape(-1)

    def one_step(dtype, plain):
        model = create_model(cfg, device=dev, dtype=dtype, seed=SEED)
        named = list(model.named_parameters())
        marks = trainable_labels((n for n, _ in named), layers, layers)
        for name, p in named:
            p.requires_grad_(marks[name] == "train")
        reset_counts()
        with plain_path() if plain else contextlib.nullcontext():
            loss, _ = regionclip_loss(model, None, batch, noun_embeddings=nouns, noise=noise)
            loss.backward()
            mask = _fed_class_mask(labels, valid, REGION_NOUNS, REGION_SAMPLE, noise)
        if not plain and not all(v for k, v in read_counts().items() if k != "nms"):
            fail(f"RegionCLIP kernel path missed a kernel: {read_counts()}")
        grads = {n: p.grad.float() for n, p in named if p.grad is not None}
        out = loss.item()
        del model, loss
        torch.cuda.empty_cache()
        return out, grads, mask

    loss_p, g_p, m_p = one_step(torch.float32, plain=True)
    loss_k, g_k, m_k = one_step(torch.float32, plain=False)
    loss_h, g_h, m_h = one_step(torch.bfloat16, plain=False)
    appeared = int(torch.unique(labels[valid]).numel())
    if not (torch.equal(m_p, m_k) and torch.equal(m_p, m_h)):
        fail(f"{s.key} region parity: the class masks of the three legs differ")
    if not int(m_p.sum()) > appeared:
        fail(f"{s.key} region parity: the mask samples no absent class ({int(m_p.sum())} of {appeared})")
    if not (g_p.keys() == g_k.keys() == g_h.keys()) or not g_p:
        fail("region parity: the three paths produced gradients for different parameters")
    rel, cos = {}, {}
    for name, w in g_p.items():
        rel[name] = (g_k[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        cos[name] = torch.nn.functional.cosine_similarity(g_h[name].flatten(), w.flatten(), dim=0).item()
    worst_rel, worst_cos = max(rel, key=rel.get), min(cos, key=cos.get)
    print(
        f"{s.key} region parity {s.model}, {layers} of {s.vision.layers} blocks, batch "
        f"{boxes.shape[0]}, {int(valid.sum())} boxes, {REGION_NOUNS} nouns, class mask of "
        f"{int(m_p.sum())} classes ({appeared} carried by a box) EQUAL in the three legs: loss f32 "
        f"plain {loss_p:.7f}, f32 kernels {loss_k:.7f} (|d| {abs(loss_k - loss_p):.3e}, relative "
        f"{abs(loss_k - loss_p) / abs(loss_p):.3e}, bar {REGION_LOSS_MAX_REL}), bf16 kernels "
        f"{loss_h:.7f} (relative {abs(loss_h - loss_p) / abs(loss_p):.3e}, reported); gradients: "
        f"f32 kernels vs f32 plain max "
        f"rel {rel[worst_rel]:.3e} ({worst_rel}; bar {STEP_GRAD_F32_MAX_REL}); bf16 kernels vs f32 "
        f"plain min cosine {cos[worst_cos]:.6f} ({worst_cos}; bar {STEP_GRAD_BF16_MIN_COS})",
        flush=True,
    )
    finite = all(torch.isfinite(g).all().item() for d in (g_p, g_k, g_h) for g in d.values())
    if not finite or not all(map(math.isfinite, (loss_p, loss_k, loss_h))):
        fail("non-finite loss or gradient in region parity")
    if not abs(loss_k - loss_p) <= REGION_LOSS_MAX_REL * abs(loss_p):
        fail(f"{s.key} region f32 kernel loss off the plain loss by {abs(loss_k - loss_p)}")
    if not rel[worst_rel] <= STEP_GRAD_F32_MAX_REL:
        fail(f"{s.key} region f32 kernel gradient {worst_rel} off by {rel[worst_rel]} of its max")
    if not cos[worst_cos] >= STEP_GRAD_BF16_MIN_COS:
        fail(f"{s.key} region bf16 kernel gradient {worst_cos} cosine {cos[worst_cos]}")


def region_run(torch, argv: list, tag: str, steps: int, layers: int, recompute: bool = False) -> dict:
    """`train.main` with ``argv``: launches counted from 0, every loss finite,
    the launch counts those of ``steps`` RegionCLIP steps."""
    from clipself_tpu_torch.train import main as train_main

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_main.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    run["launches"] = launches
    losses = [h["loss"] for h in run["history"]]
    print(f"{tag} losses {json.dumps([round(x, 6) for x in losses])}", flush=True)
    print(f"{tag} launches {json.dumps(launches)}", flush=True)
    if not losses or not all(map(math.isfinite, losses)):
        fail(f"{tag} losses {losses}")
    expect = expected_launches(layers, region_steps=steps, recompute=recompute)
    if launches != expect:
        fail(f"{tag} launch counts {launches}, expected {expect}")
    return run


def phase_region(torch, dev, s: Model, logs_dir: str, handoff: dict = None) -> dict:
    """`train.main --dataset-type region_clip` on a PNG corpus with a region
    JSON of `REGION_NOUNS` categories and a seeded noun matrix. B/16: the
    recipe's batch 16 from files, timed past the loader's backlog and
    profiled; a flags run at batch 2 (`--accum-freq 2`,
    `--save-most-recent`, `--keep-checkpoints 1`, `--export-torch`) and
    `--pretrained` on its export, loaded exactly; the staged step; one
    step's parity. L/14: batch 2 from files, one step with
    `--grad-checkpointing`, parity at reduced depth. ``handoff``, for the
    detector's hand-off check: the B/16 flags run's last `--export-torch`
    file is moved to its "export" path, and its "visual" is set to the
    exporting model's visual tower (the student's weights in memory,
    ensembled as the export is). Returns the launch counts by path."""
    import numpy as np

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.data import datasets, loader
    from clipself_tpu_torch.train import checkpoint as ckpt
    from clipself_tpu_torch.train import main as train_main

    cfg = get_model_config(s.model)
    layers = s.vision.layers
    workers = min(os.cpu_count() or 1, 8)
    backlog = 2 * workers + loader.PREFETCH
    b16 = s.key == "b16"
    batch_size = REGION_BATCH if b16 else REGION_L14_BATCH
    warmup, timed = (backlog, REGION_WINDOW * backlog) if b16 else (1, REGION_L14_STEPS - 1)
    steps = warmup + timed + (REGION_PROFILED if b16 else 0)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_region")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    try:
        t0 = time.perf_counter()
        paths, _ = write_corpus(root, cfg.embed_dim, batch_size * steps)
        region_json = write_region_json(paths)
        nouns_path = write_nouns(root, cfg.embed_dim)
        print(f"{s.key} region corpus: {DATA_TRAIN} train PNGs listed in turn as {batch_size * steps} "
              f"images, 1-{REGION_BOXES} boxes each over {REGION_NOUNS} categories, nouns "
              f"[{REGION_NOUNS}, {cfg.embed_dim}], written in {time.perf_counter() - t0:.2f} s", flush=True)
        common = [
            "--model", s.model, "--precision", "bf16", "--device", str(dev), "--dataset-type",
            "region_clip", "--train-data", region_json, "--train-image-root", paths["train"],
            "--train-embed-path", nouns_path, "--batch-size", str(batch_size), "--det-image-size",
            str(s.image), "--max-boxes", str(REGION_BOXES), "--lock-image-unlocked-groups", str(layers),
            "--alpha", str(REGION_ALPHA[s.key]), "--lr", "1e-5", "--warmup", "1", "--seed", str(SEED),
            "--log-every-n-steps", "1", "--workers", str(workers), "--logs", logs_dir,
        ]
        tag = f"{s.key} region"
        prof = {}
        with profiled_steps(torch, warmup + timed, steps, prof) if b16 else contextlib.nullcontext():
            run = region_run(torch, common + ["--epochs", "1", "--steps-per-epoch", str(steps),
                                              "--name", "region"], f"{tag} files", steps, layers)
        step_ms = [batch_size / h["images_per_sec"] * 1e3 for h in run["history"]]
        window = step_ms[warmup: warmup + timed]
        median, mean = statistics.median(window), sum(window) / len(window)
        print(
            f"{tag} files {s.model} RegionCLIP step from files: batch {batch_size} at {s.image}px, "
            f"{REGION_BOXES} boxes, {REGION_NOUNS} nouns, {layers} blocks unlocked, bf16, {workers} "
            f"workers: {timed} timed steps after {warmup} warm-up"
            + (f" (the backlog: {backlog} batches)" if b16 else "")
            + f": over the window {batch_size / mean * 1e3:.3f} images/s (images "
            f"over its time; the workers deliver in bursts, so the median step, {median:.3f} ms, "
            f"{batch_size / median * 1e3:.3f} images/s, is a device-paced or a loader-paced one); peak "
            f"{run['peak_gib']:.3f} GiB (ms per step: warm-up {[round(t, 3) for t in step_ms[:warmup]]}, "
            f"timed {[round(t, 3) for t in window]})",
            flush=True,
        )
        if b16:
            kernel = prof["kernel_ms"] / REGION_PROFILED
            wall = prof["wall_ms"] / REGION_PROFILED
            print(f"{tag} files device idle share over {REGION_PROFILED} profiled steps after the "
                  f"window {1 - kernel / wall:.1%}: kernels {kernel:.3f} ms a step, wall {wall:.3f} ms "
                  f"a step under the profiler; over the window (mean step {mean:.3f} ms) "
                  f"{1 - kernel / mean:.1%} at that kernel time", flush=True)
        out[f"{s.key}_region_files"] = run["launches"]
        first_loss = run["history"][0]["loss"]
        del run
        torch.cuda.empty_cache()

        ds = datasets.RegionCLIPDataset(region_json, paths["train"], det_size=s.image,
                                        max_anns=REGION_BOXES, seed=SEED)
        items = [ds[i] for i in range(max(batch_size, REGION_PARITY_BATCH))]
        nouns = train_main.noun_embeddings(nouns_path, dev)

        def stage(n):
            return {k: torch.as_tensor(np.stack([it[k] for it in items[:n]]), device=dev)
                    for k in items[0]}

        if b16:
            flags = common + ["--batch-size", str(REGION_FLAGS_BATCH), "--epochs", "2",
                              "--steps-per-epoch", "2", "--accum-freq", "2", "--save-frequency", "1",
                              "--save-most-recent", "--keep-checkpoints", "1", "--export-torch",
                              "--name", "region_flags"]
            t0 = time.perf_counter()
            run = region_run(torch, flags, f"{tag} flags", 4, layers)
            flags_s = time.perf_counter() - t0
            run_dir = os.path.join(logs_dir, "region_flags")
            saved = ckpt.saved_epochs(os.path.join(run_dir, "checkpoints"))
            latest = ckpt.saved_epochs(os.path.join(run_dir, "checkpoints_latest"))
            exports = sorted(n for n in os.listdir(run_dir) if n.endswith(".pt"))
            print(f"{tag} flags: batch {REGION_FLAGS_BATCH}, 2 epochs x 2 micro-steps, --accum-freq 2: "
                  f"step {run['state'].step}, checkpoints/ {saved}, checkpoints_latest/ {latest}, "
                  f"exports {exports}; {flags_s:.1f} s", flush=True)
            if (run["state"].step, saved, latest, exports) != (4, [2], [2], ["epoch_1.pt", "epoch_2.pt"]):
                fail(f"{tag} flags: step, checkpoints or exports not as the flags ask")
            out[f"{s.key}_region_flags"] = run["launches"]
            if handoff is not None:
                from clipself_tpu_torch.train.ensemble import student_teacher_ensemble

                student = {k: v.detach().to("cpu", copy=True)
                           for k, v in run["state"].model.state_dict().items() if k.startswith("visual.")}
                handoff["visual"] = student_teacher_ensemble(
                    student, {k: run["teacher_params"][k].to("cpu") for k in student}, REGION_ALPHA[s.key])
                del student
            del run
            export = os.path.join(run_dir, "epoch_2.pt")
            want = torch.load(export, map_location="cpu", weights_only=True)["state_dict"]
            pre = ["--batch-size", str(REGION_PARITY_BATCH), "--epochs", "1", "--steps-per-epoch", "1",
                   "--pretrained", export, "--seed", str(SEED + 1), "--name", "region_pretrained"]
            run = region_run(torch, common + pre, f"{tag} pretrained", 1, layers)
            got = run["teacher_params"]
            same = got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())
            print(f"{tag} --pretrained {os.path.basename(export)}: {len(want)} tensors, the "
                  f"initial weights {'EQUAL to' if same else 'DIFFER from'} the export", flush=True)
            if not same:
                fail(f"{tag}: --pretrained did not load the exported weights exactly")
            out[f"{s.key}_region_pretrained"] = run["launches"]
            if handoff is not None:
                os.replace(export, handoff["export"])
            del run, want, got
            torch.cuda.empty_cache()
            staged = staged_region_steps(torch, dev, s, stage(batch_size), nouns, tag)
            out[f"{s.key}_region_staged"] = staged["launches"]
            print(f"{tag}: from files {mean:.3f} ms a step over the window against staged "
                  f"{staged['ms']:.3f} ms (the staged step is {staged['ms'] / mean:.1%} of it)", flush=True)
        else:
            again = region_run(torch, common + ["--epochs", "1", "--steps-per-epoch", "1",
                                                "--grad-checkpointing", "--name", "region_recompute"],
                               f"{tag} recompute", 1, layers, recompute=True)
            delta = abs(again["history"][0]["loss"] - first_loss)
            print(f"{tag} recompute: one step {batch_size / again['history'][0]['images_per_sec'] * 1e3:.3f} "
                  f"ms (the first, with the loader's start), peak {again['peak_gib']:.3f} GiB; first loss "
                  f"|d| {delta:.3e} from the run without it (bar {RECOMPUTE_LOSS_MAX_ABS})", flush=True)
            if not delta <= RECOMPUTE_LOSS_MAX_ABS:
                fail(f"{tag}: the recomputing run's first loss is off by {delta}")
            out[f"{s.key}_region_recompute"] = again["launches"]
            del again
            torch.cuda.empty_cache()
        phase_region_parity(torch, dev, s, stage(REGION_PARITY_BATCH), nouns)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(logs_dir, ignore_errors=True)
    return out


def phase_detector_files(torch, dev, synthetic_ms: dict, handoff: dict) -> dict:
    """The detector's main path on files through the port's own CLIs: for
    OV-COCO (`ov_coco_vitb16`) and OV-LVIS (`ov_lvis_vitb16`, mask head) the
    port's `tools/synth_det_data.py` writes the JAX drive's set, `python -m
    clipself_tpu_torch.detector.train` (bf16, batch 8, one step an epoch,
    `DET_FILES_EPOCHS` epochs, the recipe's defaults otherwise, seeded random
    trunk) trains on it and `python -m clipself_tpu_torch.detector.evaluate`
    (`fvit-test`) scores its last checkpoint on the same files. Prints the
    first and last loss, the AP, one core's ms a train and an eval item, the
    steps' host ms beside the synthetic step's (``synthetic_ms`` by preset),
    the device's idle share over profiled steps, the checkpoints' save time
    and the launches a step and an eval batch; OV-COCO is also driven at
    the seeds `DET_FILES_SEEDS`, two processes side by side that run while
    the OV-LVIS drive runs (its host-paced readings are taken beside them:
    the script's time limit); fails on a
    non-finite loss, an AP under `DET_FILES_MIN_AP50` (OV-COCO: seed `SEED`'s
    and the median of the three seeds') or launches other than the
    synthetic path's. Then the hand-off check: ``handoff["export"]`` (a B/16
    `--export-torch` file of this run) and a vision-only copy of it, each
    as `fvit-train --clip-checkpoint`, give trunks whose taps are EQUAL to
    those of the exporting model's visual tower (``handoff["visual"]``,
    from memory, not from the file). Its files live in a temporary
    directory, deleted with the export at the end. Returns the launch
    counts by path."""
    import numpy as np

    from clipself_tpu_torch.core.config import get_model_config
    from clipself_tpu_torch.detector import evaluate as det_eval
    from clipself_tpu_torch.detector import train as det_train
    from clipself_tpu_torch.detector.classes import coco_split, lvis_split
    from clipself_tpu_torch.detector.config import PRESETS
    from clipself_tpu_torch.detector.data import DetectionDataset, collate
    from clipself_tpu_torch.models.factory import create_model
    from clipself_tpu_torch.tools import synth_det_data

    # the sets and the 220 checkpoints (~100 MB each) on local disk
    root = tempfile.mkdtemp(prefix="chip_smoke_detfiles_")
    t_phase = time.perf_counter()
    out = {}
    try:
        for dataset, preset in (("coco", DET_PRESET), ("lvis", DET_MASK_PRESET)):
            cfg = PRESETS[preset]
            layers = get_model_config(cfg.clip_model).vision.layers
            split = coco_split() if dataset == "coco" else lvis_split()
            tag = f"detector files {preset}"
            t0 = time.perf_counter()
            ann, imgs = synth_det_data.main(["--dataset", dataset, "--root", os.path.join(root, dataset)])
            ce_path = os.path.join(root, dataset, "class_embed.npy")
            ce = np.random.default_rng(SEED).standard_normal((cfg.num_classes + 1, cfg.embed_dim))
            np.save(ce_path, ce.astype(np.float32))
            print(f"{tag}: set written in {time.perf_counter() - t0:.2f} s", flush=True)
            item_ms = {}
            for train in (True, False):
                ds = DetectionDataset(ann, imgs, split["all"], image_size=cfg.image_size, max_gt=cfg.max_gt,
                                      train=train, seed=SEED, with_mask=cfg.with_mask)
                t0 = time.perf_counter()
                for i in range(len(ds)):
                    ds[i]
                item_ms["train" if train else "eval"] = (time.perf_counter() - t0) * 1e3 / len(ds)

            saves = []
            save = det_train.save_detector

            def timed_save(*args, **kwargs):
                tick = time.perf_counter()
                path = save(*args, **kwargs)
                saves.append((time.perf_counter() - tick) * 1e3)
                return path

            common = ["--preset", preset, "--ann-file", ann, "--image-root", imgs, "--class-embed", ce_path,
                      "--batch-size", str(DET_BATCH), "--device", str(dev)]
            out_dir = os.path.join(root, dataset, "out")
            prof = {}
            epochs = DET_FILES_EPOCHS[dataset]
            window = (epochs - 10, epochs - 10 + DET_FILES_PROFILED)
            det_train.save_detector = timed_save
            try:
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                with profiled_steps(torch, *window, prof, trainer=(det_train, "make_det_train_step")):
                    run = det_train.main(common + ["--epochs", str(epochs), "--seed", str(SEED),
                                                   "--output", out_dir])
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                launches = read_counts()
            finally:
                det_train.save_detector = save
            hist = run["history"]
            del run
            torch.cuda.empty_cache()
            ckpt = os.path.join(out_dir, f"detector_epoch{epochs - 1}.pkl")
            reset_counts()
            t0 = time.perf_counter()
            metrics = det_eval.main(common + ["--detector-checkpoint", ckpt])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            eval_launches = read_counts()
            torch.cuda.empty_cache()

            losses = [h["metrics"]["loss"] for h in hist]
            step_ms = [h["step_ms"] for h in hist]
            data_ms = [h["data_ms"] for h in hist]
            fed = statistics.median([d + t for d, t in zip(data_ms, step_ms)])
            kernel, wall = prof["kernel_ms"] / DET_FILES_PROFILED, prof["wall_ms"] / DET_FILES_PROFILED
            keys = ("AP", "AP50", "segm_AP", "segm_AP50") if dataset == "lvis" else ("AP50", "mAP")
            print(
                f"{tag} ({cfg.clip_model} frozen, seeded random weights; {cfg.image_size}px, batch {DET_BATCH}, "
                f"bf16, one step an epoch, {epochs} epochs): loss first {losses[0]:.6f}, last "
                f"{losses[-1]:.6f}; fvit-test {json.dumps({k: metrics[k] for k in keys})} (bar AP50"
                f"{' and segm_AP50' if dataset == 'lvis' else ''} >= {DET_FILES_MIN_AP50})",
                flush=True,
            )
            print(
                f"{tag} host: one core's ms a train item {item_ms['train']:.3f}, an eval item "
                f"{item_ms['eval']:.3f}; a step fed from files {fed:.3f} ms (median of {len(hist)}: reading "
                f"and collating the batch {statistics.median(data_ms):.3f} ms + copy, step and metrics "
                f"{statistics.median(step_ms):.3f} ms) against the synthetic step's "
                f"{synthetic_ms[preset]:.3f} ms in this run; a checkpoint save {statistics.median(saves):.3f} "
                f"ms (median of {len(saves)}, {sum(saves) / 1e3:.3f} s in all); train {train_s:.3f} s, "
                f"fvit-test {eval_s:.3f} s (the models' build included, the CLIP's initial weights "
                f"drawn once a run: `drawn_once`)",
                flush=True,
            )
            print(
                f"{tag} device idle share over epochs {window[0] + 1}-{window[1]} under the profiler (item "
                f"reads, step, save) "
                f"{1 - kernel / wall:.1%}: kernels {kernel:.3f} ms, wall {wall:.3f} ms an epoch under the profiler",
                flush=True,
            )
            per_step = {k: v // epochs for k, v in launches.items()}
            print(f"{tag} launches a step {json.dumps(per_step)}; an eval batch {json.dumps(eval_launches)}",
                  flush=True)
            if not all(math.isfinite(v) for h in hist for v in h["metrics"].values()):
                fail(f"{tag}: a non-finite loss or metric")
            if len(hist) != epochs or len(saves) != epochs:
                fail(f"{tag}: {len(hist)} logged steps and {len(saves)} saves of {epochs}")
            if launches != expected_launches(layers, det_steps=epochs):
                fail(f"{tag} launch counts {launches}, expected {expected_launches(layers, det_steps=epochs)}")
            if eval_launches != expected_launches(layers, dets=1):
                fail(f"{tag} eval launch counts {eval_launches}, expected {expected_launches(layers, dets=1)}")
            bars = ("AP50", "segm_AP50") if dataset == "lvis" else ("AP50",)
            if not all(metrics[k] >= DET_FILES_MIN_AP50 for k in bars):
                fail(f"{tag}: {json.dumps({k: metrics[k] for k in bars})} under {DET_FILES_MIN_AP50}")
            if dataset == "coco":  # the seeds' drives run beside the OV-LVIS drive
                seeds = start_seeds(preset, epochs, os.path.join(root, "seeds"), dev) + (metrics["AP50"], tag)
            out[f"b16_detector_files_{dataset}"] = launches
            out[f"b16_detector_files_{dataset}_eval"] = eval_launches

        finish_seeds(*seeds)

        # the CLIPSelf -> F-ViT hand-off: fvit-train's --clip-checkpoint (non-strict)
        # on the export and on a vision-only copy, against the exporter's tower
        cfg = PRESETS[DET_PRESET]
        export = handoff["export"]
        vision = os.path.join(root, "vision_only.pt")
        sd = torch.load(export, map_location="cpu", weights_only=True)["state_dict"]
        torch.save({"state_dict": {k: v for k, v in sd.items() if k.startswith("visual.")}}, vision)
        del sd
        ann, imgs = os.path.join(root, "coco", "instances.json"), os.path.join(root, "coco", "imgs")
        ds = DetectionDataset(ann, imgs, coco_split()["all"], image_size=cfg.image_size, max_gt=cfg.max_gt,
                              train=False)
        images = torch.as_tensor(collate([ds[0], ds[1]])["images"], device=dev)
        ref = create_model(cfg.clip_model, device=dev, dtype=torch.bfloat16)
        ref.visual.load_state_dict({k[len("visual."):]: v for k, v in handoff.pop("visual").items()})
        with torch.no_grad():
            want, _ = ref.visual_taps(images, tuple(cfg.out_indices), False)
        del ref
        for name, path in (("", export), ("a vision-only copy of ", vision)):
            run = det_train.main(["--preset", DET_PRESET, "--ann-file", ann, "--image-root", imgs,
                                  "--clip-checkpoint", path, "--epochs", "1", "--steps-per-epoch", "1",
                                  "--batch-size", "2", "--device", str(dev),
                                  "--output", os.path.join(root, "handoff")])
            with torch.no_grad():
                got, _ = run["clip"].visual_taps(images, tuple(cfg.out_indices), False)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"detector files hand-off: {name}{os.path.basename(export)} (an --export-torch file of "
                  f"this run) as fvit-train --clip-checkpoint: the trunk's {len(got)} taps "
                  f"{'EQUAL to' if same else 'DIFFER from'} those of the exporting model's visual tower",
                  flush=True)
            if not same:
                fail(f"detector files: --clip-checkpoint on {name}the export did not give the exporter's trunk")
            del run, got
        del want
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if os.path.exists(handoff["export"]):
            os.remove(handoff["export"])
    print(f"detector files phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def start_seeds(preset: str, epochs: int, root: str, dev) -> tuple:
    """Start the drive of ``preset`` at the seeds `DET_FILES_SEEDS`, each in
    a `tools/detector_seed_sweep.py` process of its own, side by side, on
    the tool's own copy of the set; returns what `finish_seeds` takes."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for seed in DET_FILES_SEEDS:
        out = os.path.join(root, f"seed{seed}")
        os.makedirs(out)
        cmd = [sys.executable, "-m", "clipself_tpu_torch.tools.detector_seed_sweep", "--root", out,
               "--preset", preset, "--seeds", str(seed), "--epochs", str(epochs), "--every", str(epochs),
               "--device", str(dev), "--json", os.path.join(out, "ap50.json")]
        with open(os.path.join(out, "log"), "w") as log:
            procs.append((seed, out, subprocess.Popen(cmd, cwd=here, stdout=log, stderr=subprocess.STDOUT)))
    return procs, time.perf_counter(), epochs


def finish_seeds(procs: list, t0: float, epochs: int, ap50: float, tag: str) -> None:
    """Wait for the seeds' drives of `start_seeds`; fails unless the median
    AP50 of theirs and ``ap50`` (seed `SEED`'s) reaches `DET_FILES_MIN_AP50`."""
    by_seed = {SEED: ap50}
    for seed, out, proc in procs:
        if proc.wait() != 0:
            with open(os.path.join(out, "log")) as log:
                print(log.read()[-4000:], flush=True)
            fail(f"{tag} seed {seed}: the drive exited {proc.returncode}")
        with open(os.path.join(out, "ap50.json")) as f:
            by_seed[seed] = json.load(f)["ap50"][str(seed)][str(epochs)]
    median = statistics.median(by_seed.values())
    print(f"{tag} AP50 by --seed after {epochs} epochs {json.dumps(by_seed)}: median {median:.4f} (bar "
          f"{DET_FILES_MIN_AP50}); seeds {[s for s, _, _ in procs]} side by side, beside the OV-LVIS drive, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if not median >= DET_FILES_MIN_AP50:
        fail(f"{tag}: the median AP50 over --seed {sorted(by_seed)} is {median}, under {DET_FILES_MIN_AP50}")


def check_evals(tag: str, evals: list, n: int) -> None:
    """``n`` evaluations, each with the evaluator's 12 metrics, every one
    finite in [0, 1] or null (a class group the val set lacks)."""
    if len(evals) != n:
        fail(f"{tag}: {len(evals)} evaluations, expected {n}")
    for e in evals:
        metrics = {k: v for k, v in e.items() if k != "epoch"}
        if len(metrics) != 12 or not all(v is None or 0.0 <= v <= 1.0 for v in metrics.values()):
            fail(f"{tag}: evaluation not finite or null: {e}")



def kernel_rows(records: Records, paths: dict) -> list:
    """One row per kernel: its launches on the main paths and its numbers
    at the L/14 student's shape in bfloat16 (RoPE: q and k in one launch, as
    the towers call it; the NMS kernels: the detector's RPN candidates,
    float32), then every record."""
    l14 = MODELS[-1]
    student = (TRAIN_BATCH, l14.tokens(l14.image))
    rows = {  # name and launch counter: source, the TPU kernel it replaces, the row's own record
        "rope_roll": (
            "rope_roll.cu", "clipself_tpu/ops/rope_roll.py:105",
            ("forward q,k", student + (l14.vision.width,)),
        ),
        "flash_attention": (
            "flash_attention.cu", "clipself_tpu/ops/attention.py:288",
            ("forward", student + (l14.heads, l14.vision.head_width)),
        ),
        "flash_attention_bwd": (
            "flash_attention_bwd.cu", "clipself_tpu/ops/flash_bwd.py:208",
            ("backward", student + (l14.heads, l14.vision.head_width)),
        ),
        "layer_norm": (
            "layer_norm.cu", "clipself_tpu/ops/layer_norm.py:139",
            ("forward", student + (l14.vision.width,)),
        ),
        "layer_norm_bwd": (
            "layer_norm.cu", "clipself_tpu/ops/layer_norm.py:171",
            ("backward", student + (l14.vision.width,)),
        ),
        "nms": (
            "nms.cu", "clipself_tpu/ops/nms_pallas.py:87",
            ("keep mask anchors thr 0.7", (DET_BATCH, 2000, 4), "float32"),
        ),
    }
    kernels = []
    for name, (src, replaces, primary) in rows.items():
        row = {
            "name": name, "route": "cuda", "source": f"clipself_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {k: p[name] for k, p in paths.items()},
            **{k: v for k, v in records.primary(name, *primary).items() if k != "what"},
            "checked_at": records.rows[name],
        }
        if name.startswith("flash"):  # the designs its rows took, by dtype and head_dim
            row["designs"] = sorted({r["design"] for r in records.rows[name] if "design" in r})
        if name == "rope_roll":  # its backward is the same kernel on the packed backward table
            row["backward_launches_by_path"] = {k: p["rope_roll_bwd"] for k, p in paths.items()}
        if row["launches"] == 0:
            fail(f"no main path launched {name}")
        kernels.append(row)
    return kernels


def descendants(root: int) -> list[int]:
    """The pids of the live processes below ``root``, from the parent links
    in /proc (zombies left out: they run nothing and go with their parent)."""
    parent = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != "Z":
            parent[int(name)] = int(ppid)
    found, level = [], {root}
    while level:
        level = {p for p, pp in parent.items() if pp in level}
        found.extend(level)
    return found


def end_processes(pids: list[int], grace_s: float = 10.0) -> None:
    """SIGTERM each process, then SIGKILL those still alive after ``grace_s``."""
    import signal

    def alive():
        live = set(descendants(os.getpid()))
        return [p for p in pids if p in live]

    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in alive():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace_s
        while alive() and time.monotonic() < deadline:
            with contextlib.suppress(ChildProcessError):
                os.waitpid(-1, os.WNOHANG)
            time.sleep(0.05)


def stop_children() -> None:
    """Stop every process this run started, so that none outlives it. The
    data phase's loaders leave a fork server and a resource tracker, which on
    their own exit only some time after this process: a worker still alive
    (an exception can hold its loader) is ended first, since the tracker
    waits for every holder of its pipe, then both stop through
    `loader.stop_worker_server`, and anything left is ended."""
    from multiprocessing import forkserver, resource_tracker

    helpers = {forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid}
    strays = [p for p in descendants(os.getpid()) if p not in helpers]
    loader = sys.modules.get("clipself_tpu_torch.data.loader")
    if loader is not None:
        end_processes(strays)
        loader.stop_worker_server()
    left = descendants(os.getpid())
    if strays or left:
        print(f"chip_smoke: ended processes still running at exit: {sorted(set(strays) | set(left))}",
              file=sys.stderr, flush=True)
    end_processes(left)


def main() -> int:
    try:
        return run()
    finally:
        stop_children()


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from clipself_tpu_torch.ops import _build

    # full float32 for every float32 product and convolution of the run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print(card(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.LIBRARY.get()
    built = _build.LIBRARY.build_seconds
    print(
        f"build: kernels from clipself_tpu_torch/csrc ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'%.2f s' % built if built is not None else 'skipped, cached'})",
        flush=True,
    )

    with drawn_once():
        return run_phases(torch, dev, t0)


def run_phases(torch, dev, t0) -> int:
    """Every phase, in order; prints the kernels' line and the last line."""
    records = Records()
    phase_kernels(torch, dev, records)
    logs_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_logs")
    # launches: every main path counted from 0 (each model's text embeddings,
    # evaluator and train runs); the backward rows launch on the train paths only
    paths = {}
    # the B/16 RegionCLIP run's --export-torch file and its exporter's visual
    # tower, kept for the detector's hand-off check
    handoff = {"export": os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_export.pt")}
    print(f"kernels done at {time.perf_counter() - t0:.1f} s", flush=True)
    for s in MODELS:
        model_paths, train = phase_model(torch, dev, s, logs_dir)
        paths.update(model_paths)
        print(f"{s.key} done at {time.perf_counter() - t0:.1f} s", flush=True)
        if s.key == "b16":
            paths.update(phase_parallel(torch, dev, s, logs_dir))
            print(f"{s.key} sharded step done at {time.perf_counter() - t0:.1f} s", flush=True)
            paths.update(phase_data(torch, dev, s, logs_dir, train))
            print(f"{s.key} data done at {time.perf_counter() - t0:.1f} s", flush=True)
        paths.update(phase_region(torch, dev, s, logs_dir, handoff=handoff if s.key == "b16" else None))
        print(f"{s.key} RegionCLIP done at {time.perf_counter() - t0:.1f} s", flush=True)
    paths.update(phase_open_clip_vit(torch, dev, logs_dir))
    print(f"OpenCLIP ViT done at {time.perf_counter() - t0:.1f} s", flush=True)
    paths.update(phase_vit_tp(torch, dev))
    print(f"OpenCLIP ViT at tp 2 done at {time.perf_counter() - t0:.1f} s", flush=True)
    paths.update(phase_towers(torch, dev, logs_dir))
    print(f"RN50, EVA01-B/16, ConvNeXt-B and Swin-B done at {time.perf_counter() - t0:.1f} s", flush=True)
    paths.update(phase_coca(torch, dev))
    print(f"CoCa done at {time.perf_counter() - t0:.1f} s", flush=True)
    paths.update(phase_hf(torch, dev, logs_dir))
    print(f"HF towers done at {time.perf_counter() - t0:.1f} s", flush=True)
    cfg, clip, det, emb, items, paths["b16_detector"] = phase_detector(torch, dev, DET_PRESET)
    phase_detector_parity(torch, dev, DET_PRESET, cfg, clip, det, emb, items)
    del clip, det
    torch.cuda.empty_cache()
    print(f"detector done at {time.perf_counter() - t0:.1f} s", flush=True)
    synthetic = phase_detector_train(torch, dev, DET_PRESET, DET_TRAIN_WARMUP, DET_TRAIN_TIMED, logs_dir)
    paths["b16_detector_train"] = synthetic["launches"]
    phase_detector_train_parity(torch, dev)
    mask = phase_detector_train(torch, dev, DET_MASK_PRESET, DET_MASK_WARMUP, DET_MASK_TIMED, logs_dir)
    paths["b16_detector_train_mask"] = mask["launches"]
    print(f"detector training done at {time.perf_counter() - t0:.1f} s", flush=True)
    paths.update(phase_detector_files(
        torch, dev, {DET_PRESET: synthetic["median_ms"], DET_MASK_PRESET: mask["median_ms"]}, handoff
    ))
    print(f"detector files done at {time.perf_counter() - t0:.1f} s", flush=True)

    # the L/14 presets: evaluation and its parity, LVIS with masks, training
    cfg, clip, det, emb, items, paths["l14_detector"] = phase_detector(torch, dev, DET_L14_PRESET)
    phase_detector_parity(torch, dev, DET_L14_PRESET, cfg, clip, det, emb, items)
    del clip, det, items
    torch.cuda.empty_cache()
    for preset in DET_LVIS_PRESETS:
        key = "l14" if "vitl14" in preset else "b16"
        paths[f"{key}_detector_lvis"] = phase_detector(torch, dev, preset)[-1]
        torch.cuda.empty_cache()
    print(f"L/14 and LVIS detector evaluation done at {time.perf_counter() - t0:.1f} s", flush=True)
    paths["l14_detector_train"] = phase_detector_train(
        torch, dev, DET_L14_PRESET, DET_TRAIN_WARMUP, DET_TRAIN_TIMED, logs_dir
    )["launches"]
    paths["l14_detector_train_mask"] = phase_detector_train(
        torch, dev, DET_L14_MASK_PRESET, DET_MASK_WARMUP, DET_MASK_TIMED, logs_dir
    )["launches"]
    print(f"L/14 detector training done at {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = kernel_rows(records, paths)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
