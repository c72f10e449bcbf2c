"""EVA02-CLIP towers, weights and model creation."""
