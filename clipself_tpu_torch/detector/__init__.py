"""F-ViT open-vocabulary detector (frozen CLIP ViT backbone + detection heads):
the inference path, a port of `clipself_tpu/detector/`."""
