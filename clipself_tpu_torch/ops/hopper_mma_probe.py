"""One 64 x 64 x 64 bfloat16 product through each operand form of
`csrc/hopper_mma.cuh` (`csrc/hopper_mma_probe.cu`), the header the
flash-attention kernels are built from. A test holds it against
`torch.matmul`, so that a fault in a shared-memory descriptor, a transpose
flag, the swizzled loader or the fragment map shows apart from the attention
logic. Nothing on a main path calls it."""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

# mode: what the product computes and which attention product has its form
MODES = {
    0: "a @ b.T (both K-major in shared memory: S = Q K^T)",
    1: "a @ b (a from registers, b MN-major: O = P V)",
    2: "a.T @ b (both MN-major in shared memory: dQ = dS K)",
}


def wgmma_probe_plain(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    a, b = a.float(), b.float()
    return (a @ b.T, a @ b, a.T @ b)[mode]


def wgmma_probe(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """float32 [64, 64] product of two contiguous bfloat16 [64, 64] tensors."""
    if mode not in MODES:
        raise ValueError(f"wgmma_probe: mode {mode} (takes {sorted(MODES)})")
    for t in (a, b):
        if t.shape != (64, 64) or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("wgmma_probe: takes contiguous bfloat16 [64, 64] tensors")
    if a.device.type == "cpu":
        return wgmma_probe_plain(a, b, mode)
    c = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(a.device):
        err = lib.clipself_wgmma_probe(
            mode, a.data_ptr(), b.data_ptr(), c.data_ptr(), _build.stream_handle(a)
        )
    _build.check(err, "wgmma_probe launch")
    return c
