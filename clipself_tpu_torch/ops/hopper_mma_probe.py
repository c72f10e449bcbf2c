"""One bfloat16 product through each operand form of `csrc/hopper_mma.cuh`
(`csrc/hopper_mma_probe.cu`), the header the flash-attention kernels are
built from, at the widths those kernels run it: K-major tiles of one or two
64-column panels, and products of N = 16 to 128 columns (two products past
64). A test holds it against `torch.matmul`, so that a fault in a
shared-memory descriptor, a transpose flag, the swizzled loader or the
fragment map shows apart from the attention logic. Nothing on a main path
calls it."""

from __future__ import annotations

import torch

from clipself_tpu_torch.ops import _build

# mode: what the product computes and which attention product has its form
MODES = {
    0: "a @ b.T (a [64, K], b [N, K], both K-major in shared memory: S = Q K^T)",
    1: "a @ b (a [64, 64] from registers, b [64, N] MN-major: O = P V, dV, dK, dQ)",
    2: "a.T @ b (a [64, 64], b [64, N], both MN-major in shared memory)",
}
# the (mode, K, N) forms the probe is built at (csrc/hopper_mma_probe.cu)
PRODUCTS = (
    tuple((0, k, 64) for k in (64, 80, 96, 112, 128))
    + ((0, 80, 32), (0, 128, 32), (0, 64, 16), (0, 64, 48))
    + tuple((mode, 64, n) for mode in (1, 2) for n in (16, 32, 48, 64, 80, 96, 112, 128))
)


def shapes(mode: int, k: int, n: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The shapes of a and b for a (mode, K, N) form."""
    return ((64, k), (n, k)) if mode == 0 else ((64, 64), (64, n))


def wgmma_probe_plain(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    a, b = a.float(), b.float()
    if mode == 0:
        return a @ b.T
    return a @ b if mode == 1 else a.T @ b


def wgmma_probe(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """float32 [64, N] product of two contiguous bfloat16 tensors of one of
    the `PRODUCTS` forms."""
    if mode not in MODES:
        raise ValueError(f"wgmma_probe: mode {mode} (takes {sorted(MODES)})")
    k, n = (a.shape[1], b.shape[0]) if mode == 0 else (64, b.shape[1])
    if (mode, k, n) not in PRODUCTS or (tuple(a.shape), tuple(b.shape)) != shapes(mode, k, n):
        raise ValueError(f"wgmma_probe: no mode {mode} form for a {tuple(a.shape)}, b {tuple(b.shape)}")
    for t in (a, b):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("wgmma_probe: takes contiguous bfloat16 tensors")
    if a.device.type == "cpu":
        return wgmma_probe_plain(a, b, mode)
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(a.device):
        err = lib.clipself_wgmma_probe(
            mode, k, n, a.data_ptr(), b.data_ptr(), c.data_ptr(), _build.stream_handle(a)
        )
    _build.check(err, "wgmma_probe launch")
    return c
