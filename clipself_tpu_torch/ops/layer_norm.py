"""Fused row LayerNorm over the last axis, forward and one-pass backward.

Per row, in float32 whatever x's dtype (the fast-variance association of
the JAX tower, `clipself_tpu/models/eva_vit.py:79-84`):

    mu = mean(x), var = max(mean(x^2) - mu^2, 0), rstd = rsqrt(var + eps)
    y  = (x - mu) * (rstd * weight) + bias             in x's dtype

    g  = dy * weight, xhat = (x - mu) * rstd
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat))  in x's dtype
    dweight = sum_rows dy * xhat, dbias = sum_rows dy  float32

The CUDA kernels (`csrc/layer_norm.cu`) replace the Pallas kernels of
`clipself_tpu/ops/layer_norm.py`; `layer_norm_plain` and
`layer_norm_bwd_plain` are the same formulas in plain PyTorch. The kernels
take any width and any row count, and read x through two row strides, so a
view like `t[:, 1:]` or `t[:, 0]` of a [B, N, W] tensor is not copied.

`layer_norm` runs `LayerNormFn`, the counterpart of the JAX `custom_vjp`
(`layer_norm.py:189-213`): the forward keeps (x, mu, rstd, weight), the
backward is the one-pass kernel. Where no input needs a gradient it runs the
forward alone, which writes no statistics.

The backward kernel has two designs, and `bwd_design` picks one from the
input. "registers": a row group of G warps takes one row at a time, each
lane the same column chunks of every row (copied a row ahead into a ring in
shared memory, read into registers), and sums its dweight and dbias terms in
registers; `bwd_plan` sizes it from the width, and
`layer_norm_bwd_plan_plain` adds the sums in its order. "staged" (the first
port's): a warp a row, rows staged in shared memory, column sums there; it
takes bfloat16 rows read one element at a time, rows wider than
BWD_MAX_WIDTH and fewer rows than SMs.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools
import re
from typing import NamedTuple

import torch

from clipself_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter()      # forward launches, with or without stats
BWD_LAUNCHES = _build.LaunchCounter()  # backward launches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_constant(name: str) -> int:
    """A ``constexpr int`` of `csrc/layer_norm.cu`, the one place it is set."""
    found = re.search(rf"constexpr int {name} = (\d+);", (_build.CSRC / "layer_norm.cu").read_text())
    if found is None:
        raise RuntimeError(f"csrc/layer_norm.cu sets no constexpr int {name}")
    return int(found.group(1))


# The backward's plan, as `csrc/layer_norm.cu` takes it: a lane holds at most
# BWD_LANE_ELEMS elements of x (and as many of dy) of a row in registers,
# beside their float32 dweight and dbias sums (32 spilled in bfloat16 on an
# H100); a block runs at most BWD_BLOCK_WARPS warps; a row group's ring in
# shared memory holds BWD_STAGES rows (one it works on, the next in flight);
# at most BWD_BLOCKS_PER_SM blocks an SM run, each writing one [2, W]
# partial row that the second launch adds up.
MAX_SHARED_BYTES = _kernel_constant("kMaxSharedBytes")
BWD_LANE_ELEMS = _kernel_constant("kBwdLaneElems")
BWD_BLOCK_WARPS = _kernel_constant("kBwdMaxThreads") // 32
BWD_STAGES = _kernel_constant("kBwdStages")
BWD_BLOCKS_PER_SM = 2
BWD_MAX_WIDTH = BWD_LANE_ELEMS * 32 * BWD_BLOCK_WARPS  # of the registers design


class BwdPlan(NamedTuple):
    """How the backward kernel cuts a row and a block."""

    vec: int           # elements a load
    group_warps: int   # G: the warps that share a row
    chunks: int        # loads of x (and of dy) a lane holds of a row, at most
    groups: int        # row groups a block
    threads: int       # threads a block
    shared_bytes: int  # gamma, the row-sum exchange, the rings (later the groups' sums)


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def bwd_plan(dtype: torch.dtype, width: int, vec: int) -> BwdPlan:
    """The registers design's plan for rows of ``width`` elements of
    ``dtype`` read ``vec`` at a time: the fewest warps a row that keep a lane
    within BWD_LANE_ELEMS of x, and as many row groups as fit BWD_BLOCK_WARPS.
    Raises for rows wider than BWD_MAX_WIDTH."""
    if width > BWD_MAX_WIDTH:
        raise ValueError(
            f"layer_norm_bwd: a row of {width} is wider than the {BWD_MAX_WIDTH} elements "
            "the kernel holds in registers"
        )
    if vec < 1 or vec * dtype.itemsize > 16 or width % vec:
        raise ValueError(f"layer_norm_bwd: loads of {vec} {dtype} do not fit rows of {width}")
    nvec = width // vec
    lane_chunks = BWD_LANE_ELEMS // vec
    group_warps = -(-nvec // (32 * lane_chunks))
    groups = BWD_BLOCK_WARPS // group_warps
    if group_warps > 1:  # a group of several warps meets at one of the barriers 1..15
        groups = min(groups, 15)
    rings = 2 * groups * BWD_STAGES * _round_up(width * dtype.itemsize, 16)
    shared = 4 * _round_up(width, 4) + 16 * groups * group_warps + max(rings, 8 * groups * width)
    return BwdPlan(
        vec, group_warps, -(-nvec // (32 * group_warps)), groups, 32 * groups * group_warps, shared
    )


def bwd_max_blocks(sms: int) -> int:
    """Blocks of the backward kernel on a card of ``sms`` SMs, at most: the
    rows of its partial-sum scratch."""
    return BWD_BLOCKS_PER_SM * sms


def _staged_shared_bytes(width: int, itemsize: int, warps: int) -> int:
    return _round_up((2 * width + 2 * warps) * 4, 16) + 2 * warps * _round_up(width * itemsize, 16)


@functools.lru_cache(maxsize=None)
def bwd_max_width(dtype: torch.dtype) -> int:
    """The widest row the backward takes: the staged design's, with one row
    of x and dy in its shared memory."""
    width = MAX_SHARED_BYTES // (8 + 2 * dtype.itemsize)
    while _staged_shared_bytes(width, dtype.itemsize, 1) > MAX_SHARED_BYTES:
        width -= 1
    return width


_BWD_DESIGNS = {"registers": 0, "staged": 1}


def bwd_design(dtype: torch.dtype, width: int, vec: int, rows: int, sms: int) -> str:
    """Which backward design runs. "staged" where the registers design
    cannot run: bfloat16 rows read one element at a time (its copies move 4
    bytes or more), rows wider than BWD_MAX_WIDTH; and where the H100
    measured it faster (PERF.md, section 6): fewer rows than the card has
    SMs, where a call's fixed cost is all there is. Else "registers"."""
    if (dtype == torch.bfloat16 and vec == 1) or width > BWD_MAX_WIDTH or rows < sms:
        return "staged"
    return "registers"


def describe_bwd(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor | None) -> str:
    """The design (and plan) that `layer_norm_bwd` takes on these CUDA
    tensors, as `chip_smoke.py` names it."""
    vec, w = bwd_vec(x, dy, dx), x.shape[-1]
    if bwd_design(x.dtype, w, vec, _rows(x, "layer_norm_bwd")[0], _sm_count(x.device.index)) == "staged":
        return "staged: a warp a row in shared memory"
    plan = bwd_plan(x.dtype, w, vec)

    def n(count, noun):
        return f"{count} {noun}{'s' if count > 1 else ''}"

    return (
        f"registers: {n(plan.group_warps, 'warp')} a row, {n(plan.groups, 'row group')} a block, "
        f"{plan.vec}-element loads, {n(BWD_STAGES, 'row')} a ring"
    )


def bwd_vec(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor | None) -> int:
    """The widest load, in elements (16 bytes at most), that every row of x
    (through its two strides, `_rows`), dy and dx allows."""
    _, _, stride_outer, stride_inner = _rows(x, "layer_norm_bwd")
    size, w = x.element_size(), x.shape[-1]
    ptrs = [t.data_ptr() for t in (x, dy, dx) if t is not None]
    vec = 16 // size
    while vec > 1 and not (
        w % vec == 0 and stride_outer % vec == 0 and stride_inner % vec == 0
        and all(p % (vec * size) == 0 for p in ptrs)
    ):
        vec //= 2
    return vec


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_stats_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the row statistics: (y in x's dtype, mu,
    rstd float32 of shape x.shape[:-1]) for x [..., W] and float32 [W]
    weight and bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mu) * (rstd * weight) + bias).to(x.dtype)
    return y, mu[..., 0], rstd[..., 0]


def layer_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """Plain PyTorch version: x [..., W], weight and bias float32 [W]."""
    return layer_norm_stats_plain(x, weight, bias, eps)[0]


def layer_norm_bwd_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    mu: torch.Tensor,
    rstd: torch.Tensor,
    weight: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dweight, dbias float32 [W]) from the forward's
    float32 row statistics ``mu`` and ``rstd`` of shape x.shape[:-1]."""
    xf, dyf = x.float(), dy.float()
    mu, rstd = mu[..., None], rstd[..., None]
    xhat = (xf - mu) * rstd
    g = dyf * weight
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (g - m1 - xhat * m2)).to(x.dtype)
    rows = tuple(range(x.dim() - 1))
    return dx, (dyf * xhat).sum(dim=rows), dyf.sum(dim=rows)


def layer_norm_bwd_plan_plain(
    x: torch.Tensor,
    dy: torch.Tensor,
    mu: torch.Tensor,
    rstd: torch.Tensor,
    weight: torch.Tensor,
    blocks: int,
    plan: BwdPlan,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`layer_norm_bwd_plain` with dweight and dbias added in the kernel's
    order on ``blocks`` blocks of ``plan``: row group q of the grid takes rows
    q, q + Q, q + 2Q, ... (Q = blocks * plan.groups), a block adds its groups'
    sums in group order into its partial row, and the second launch adds
    blocks j, j + 8, ... for each j < 8, then the eight sums in order."""
    w = x.shape[-1]
    dx = layer_norm_bwd_plain(x, dy, mu, rstd, weight)[0]
    xf, dyf = x.float().reshape(-1, w), dy.float().reshape(-1, w)
    xhat = (xf - mu.reshape(-1, 1)) * rstd.reshape(-1, 1)
    terms = torch.stack((dyf * xhat, dyf))  # [2, rows, W]: dweight's and dbias's
    n_groups = blocks * plan.groups
    acc = terms.new_zeros(2, n_groups, w)
    for start in range(0, terms.shape[1], n_groups):  # each group's next row
        step = terms[:, start:start + n_groups]
        acc[:, : step.shape[1]] += step
    acc = acc.reshape(2, blocks, plan.groups, w)
    partial = acc[:, :, 0].clone()
    for g in range(1, plan.groups):
        partial += acc[:, :, g]
    lanes = terms.new_zeros(2, 8, w)
    for start in range(0, blocks, 8):
        step = partial[:, start:start + 8]
        lanes[:, : step.shape[1]] += step
    total = lanes[:, 0].clone()
    for j in range(1, 8):
        total += lanes[:, j]
    return dx, total[0], total[1]


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _rows(x: torch.Tensor, what: str) -> tuple[int, int, int, int]:
    """(rows, n_inner, stride_outer, stride_inner) of x [..., W] for the
    kernels: row r starts at (r // n_inner) * stride_outer + (r % n_inner) *
    stride_inner elements. Takes contiguous tensors of any rank and 2-D or
    3-D views whose last axis has unit stride."""
    w = x.shape[-1]
    if x.is_contiguous():
        rows = x.numel() // w
        return rows, rows, 0, w
    if x.stride(-1) != 1 or x.dim() not in (2, 3):
        raise ValueError(
            f"{what}: x must be contiguous, or a 2-D or 3-D view with unit stride "
            f"on the last axis; got shape {tuple(x.shape)} strides {x.stride()}"
        )
    if x.dim() == 2:
        return x.shape[0], x.shape[0], 0, x.stride(0)
    return x.shape[0] * x.shape[1], x.shape[1], x.stride(0), x.stride(1)


def _check_cuda_inputs(x: torch.Tensor, vectors: dict, what: str) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} (takes float32, bfloat16)")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{what}: x must be a non-empty [..., W], got {tuple(x.shape)}")
    w = x.shape[-1]
    for name, t in vectors.items():
        if t.shape != (w,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 [{w}]")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")


def layer_norm_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    return_stats: bool = False,
):
    """LayerNorm of x [..., W] as a contiguous tensor of x's dtype; with
    ``return_stats`` also the float32 row mean and rstd of shape
    x.shape[:-1], which the backward takes."""
    _check_device(x, "layer_norm")
    if x.device.type == "cpu":
        out = layer_norm_stats_plain(x, weight, bias, eps)
        return out if return_stats else out[0]
    _check_cuda_inputs(x, {"weight": weight, "bias": bias}, "layer_norm")
    rows, n_inner, stride_outer, stride_inner = _rows(x, "layer_norm")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mu = rstd = None
    if return_stats:
        mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.clipself_layer_norm_fwd(
            _DTYPES[x.dtype], x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), None if mu is None else mu.data_ptr(),
            None if rstd is None else rstd.data_ptr(),
            rows, n_inner, stride_outer, stride_inner, x.shape[-1], float(eps),
            _build.stream_handle(x),
        )
    _build.check(err, "layer_norm launch")
    LAUNCHES.add()
    return (y, mu, rstd) if return_stats else y


def layer_norm_bwd(
    x: torch.Tensor,
    dy: torch.Tensor,
    mu: torch.Tensor,
    rstd: torch.Tensor,
    weight: torch.Tensor,
    need_dx: bool = True,
    need_dwb: bool = True,
):
    """(dx, dweight, dbias) of `layer_norm_fwd` from the output gradient
    ``dy`` (contiguous, x's shape and dtype) and the forward's statistics;
    dx is contiguous in x's dtype, dweight and dbias float32 [W]. An output
    that is not needed (``need_dx``, ``need_dwb`` for the pair) is None and is
    not computed on the card. On the card, rows wider than
    `bwd_max_width(x.dtype)` raise."""
    _check_device(x, "layer_norm_bwd")
    if not (need_dx or need_dwb):
        return None, None, None
    if x.device.type == "cpu":
        dx, dw, db = layer_norm_bwd_plain(x, dy, mu, rstd, weight)
        return (dx if need_dx else None,) + ((dw, db) if need_dwb else (None, None))
    what = "layer_norm_bwd"
    _check_cuda_inputs(x, {"weight": weight}, what)
    rows, n_inner, stride_outer, stride_inner = _rows(x, what)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"{what}: dy must be a contiguous {tuple(x.shape)} {x.dtype} on {x.device}")
    for name, t in (("mu", mu), ("rstd", rstd)):
        if (
            t.shape != x.shape[:-1] or t.dtype != torch.float32
            or t.device != x.device or not t.is_contiguous()
        ):
            raise ValueError(f"{what}: {name} must be a contiguous float32 {tuple(x.shape[:-1])}")
    w, widest = x.shape[-1], bwd_max_width(x.dtype)
    if w > widest:
        raise ValueError(
            f"{what}: a row of {w} is wider than the {widest} elements of {x.dtype} "
            "the kernel holds in shared memory"
        )
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device) if need_dx else None
    vec, sms = bwd_vec(x, dy, dx), _sm_count(x.device.index)
    design = bwd_design(x.dtype, w, vec, rows, sms)
    # the staged design picks its own loads and block
    plan = bwd_plan(x.dtype, w, vec) if design == "registers" else BwdPlan(0, 0, 0, 0, 0, 0)
    dw = db = partial = None
    max_blocks = bwd_max_blocks(sms)
    if need_dwb:
        dw = torch.empty(w, dtype=torch.float32, device=x.device)
        db = torch.empty_like(dw)
        # per-block partial sums, added up by the kernel's second stage
        partial = torch.empty((2, max_blocks, w), dtype=torch.float32, device=x.device)
    lib = _build.LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.clipself_layer_norm_bwd(
            _DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), None if dx is None else dx.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if dw is None else dw.data_ptr(), None if db is None else db.data_ptr(),
            rows, n_inner, stride_outer, stride_inner, w, _BWD_DESIGNS[design], plan.vec,
            plan.group_warps, plan.groups, plan.shared_bytes, max_blocks, _build.stream_handle(x),
        )
    _build.check(err, "layer_norm_bwd launch")
    BWD_LAUNCHES.add()
    return dx, dw, db


def setup_calls() -> int:
    """Kernel set-ups (the shared-memory attribute and the occupancy query)
    this process has made: one for each LayerNorm kernel instantiation,
    shared size and device, never one a launch."""
    return _build.LIBRARY.get().clipself_layer_norm_setup_calls()


class LayerNormFn(torch.autograd.Function):
    """Fused LayerNorm with the one-pass backward: the forward keeps (x, mu,
    rstd, weight), the backward runs `layer_norm_bwd` for the gradients that
    are needed."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps, return_stats=True)
        ctx.save_for_backward(x, mu, rstd, weight)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, weight = ctx.saved_tensors
        need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
        dx, dw, db = layer_norm_bwd(
            x, dy.contiguous(), mu, rstd, weight, need_dx=need_dx, need_dwb=need_dw or need_db
        )
        return dx, dw if need_dw else None, db if need_db else None, None


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm of x [..., W] over the last axis in x's dtype,
    differentiable through `LayerNormFn`."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return LayerNormFn.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps)
