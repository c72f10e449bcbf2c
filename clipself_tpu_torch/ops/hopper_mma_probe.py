"""One bfloat16 product through each operand form of `csrc/hopper_mma.cuh`
(`csrc/hopper_mma_probe.cu`), the header the flash-attention kernels are
built from, at the widths those kernels run it: K-major tiles of one or two
64-column panels, and products of N = 16 to 128 columns (two products past
64). A test holds it against `torch.matmul`, so that a fault in a
shared-memory descriptor, a transpose flag, the swizzled loader or the
fragment map shows apart from the attention logic. Its float32 forms
(`tf32_probe`) run the three-product TF32 split of the float32 flash
kernels through their fragment loads and split tiles (`wgmma` for the
scores, `mma.sync` for the value products), held against the float64
product.
Nothing on a main path calls it."""

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


# The float32 forms of the TF32 three-product split that the float32 flash
# kernels run (`csrc/hopper_mma_probe.cu`, modes 3 to 6): (mode, K, N).
TF32_MODES = {
    3: "a @ b.T (a [64, K] by ldmatrix, b [N, K] a split tile; wgmma: S = Q K^T, dP = dO V^T)",
    4: "a @ b (a [16, 64] from registers, renumbered; b [64, N] by rows: O = P V)",
    5: "a @ b (a [16, K] from registers, renumbered; b [K, N] a split tile: dV, dK, dQ)",
    6: "a @ b.T (a [16, K], b [64, K], both by ldmatrix; mma.sync: the backward's scores past width 96)",
}
TF32_PRODUCTS = (
    tuple((3, k, n) for k in range(8, 129, 8) for n in (16, 32))
    + tuple((4, 64, n) for n in range(8, 129, 8))
    + tuple((5, k, n) for k in (16, 32) for n in range(8, 129, 8))
    + tuple((6, k, 64) for k in range(8, 129, 8))
)


def tf32_shapes(mode: int, k: int, n: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """The shapes of a and b for a TF32 (mode, K, N) form."""
    return {3: ((64, k), (n, k)), 4: ((16, 64), (64, n)), 5: ((16, k), (k, n)), 6: ((16, k), (64, k))}[mode]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as `cvt.rna.tf32.f32` rounds finite values: half a
    TF32 unit (bit 12) added to the magnitude, the 13 low bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """float32 with its 13 low bits cleared: TF32 rounded toward zero."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor, lo: str = "rna") -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo, hi = x rounded to TF32, lo = x - hi rounded to TF32 to
    nearest (``lo="rna"``) or cut toward zero (``"cut"``: what a tensor core
    that ignores the 13 low bits reads of the unrounded lo the kernels hand
    it)."""
    hi = tf32_round(x)
    rest = x.float() - hi
    return hi, tf32_round(rest) if lo == "rna" else tf32_cut(rest)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, split: bool = True, lo: str = "rna") -> torch.Tensor:
    """float32 a @ b as the tensor cores form it from TF32 operands, emulated
    with float64 sums of the products: lo_a hi_b + hi_a lo_b + hi_a hi_b
    (lo_a lo_b dropped) with ``split``, else hi_a hi_b alone; ``lo`` as in
    `tf32_split`."""
    ah, al = tf32_split(a, lo)
    bh, bl = tf32_split(b, lo)
    out = ah.double() @ bh.double()
    if split:
        out = out + al.double() @ bh.double() + ah.double() @ bl.double()
    return out.float()


def tf32_probe_plain(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """The float32 forms' yardstick: the float64 product, rounded to float32."""
    a, b = a.double(), b.double()
    return (a @ b.T if mode in (3, 6) else a @ b).float()


def tf32_probe(a: torch.Tensor, b: torch.Tensor, mode: int, split: bool = True) -> torch.Tensor:
    """float32 [M, N] product (M = 64 in mode 3, else 16) of two contiguous
    float32 tensors of one of the `TF32_PRODUCTS` forms, through the flash
    kernels' fragment loads, split tiles and three-product split (``split`` False: one TF32 product). On the CPU, the
    float64 product (`tf32_probe_plain`) or, without ``split``, its
    one-product emulation."""
    if mode not in TF32_MODES:
        raise ValueError(f"tf32_probe: mode {mode} (takes {sorted(TF32_MODES)})")
    k, n = (a.shape[-1], b.shape[0]) if mode in (3, 6) else (b.shape[0], b.shape[-1])
    if (mode, k, n) not in TF32_PRODUCTS or (tuple(a.shape), tuple(b.shape)) != tf32_shapes(mode, k, n):
        raise ValueError(f"tf32_probe: no mode {mode} form for a {tuple(a.shape)}, b {tuple(b.shape)}")
    for t in (a, b):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("tf32_probe: takes contiguous float32 tensors")
    if a.device.type == "cpu":
        if split:
            return tf32_probe_plain(a, b, mode)
        return tf32_matmul(a, b.T if mode in (3, 6) else b, split=False)
    c = torch.empty((a.shape[0], n), dtype=torch.float32, device=a.device)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(a.device):
        err = lib.clipself_tf32_probe(
            mode, k, n, int(split), a.data_ptr(), b.data_ptr(), c.data_ptr(), _build.stream_handle(a)
        )
    _build.check(err, "tf32_probe launch")
    return c
