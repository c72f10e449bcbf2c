"""Dataset normalization constants (a copy of `clipself_tpu/core/constants.py`).

Same values as the reference `src/open_clip/constants.py:1-2` (the standard
OpenAI CLIP image normalization).
"""

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

# Gray fill value used for masked image crops in the panoptic eval pipeline
# (reference `src/training/data.py:370`).
MASKED_CROP_FILL = 114
