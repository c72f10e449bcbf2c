"""Hand-written kernels and the plain tensor ops around them."""
