"""clipself_tpu_torch — the PyTorch / CUDA port of `clipself_tpu` for NVIDIA
Hopper (H100).

It keeps the JAX package's layout (`core/`, `ops/`, `models/`, `eval/`,
`data/`, `train/`, `utils/`) and names, imports `torch` and never `jax`, and
runs every kernel the JAX package ran through Pallas as a hand-written CUDA
kernel (`csrc/`, built at first use by `ops/_build.py`). Ported so far: the
dense zero-shot evaluator of the EVA02 towers (`eval/zero_shot.py`), the
CLIPSelf distillation trainer on one device (`train/main.py`, on COCO files
or synthetic data), the input pipeline without PIL (`data/`), the F-ViT
detector's evaluation and training (`detector/`), and the CLIP text tower
with its tokenizer and the prompt-ensemble class matrices
(`models/text_transformer.py`, `tokenizer.py`, `tools/text_embeddings.py`).
"""

__version__ = "0.1.0"
