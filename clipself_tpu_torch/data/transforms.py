"""Host-side image transforms in NumPy, channels-last output: Pillow's
arithmetic without PIL, equal to `clipself_tpu/data/transforms.py` on the
same pixels.

Images are RGB uint8 [H, W, 3] arrays where the JAX package holds PIL
images. The reference preprocessing (`src/open_clip/transform.py`):
  - det transform = ResizeLongest(det_size) with bottom-right padding
    (`transform.py:169-191`) + OpenAI normalize;
  - crop transform = ResizeMaxSize(crop_size) with CENTER padding
    (`transform.py:26-49`) + OpenAI normalize;
  - `get_scale` = min(new/old) ratio (`transform.py:194-207`).
Every resize of the distillation pipelines is Pillow's 8-bit BICUBIC
(`Resample.c`): a = -0.5 over a support of 2 widened by the shrink factor,
weights in fixed point with 22 fraction bits, the horizontal pass first into
a uint8 intermediate. Only the taps of each output pixel are multiplied (a
banded product in int32, no BLAS), which is exact: the sums stay under
2^31. The detector's resizes are Pillow's 8-bit BILINEAR in the same passes
(`resize_bilinear`; `resize_bilinear_u8` for one channel), its raster
resizes NEAREST (`resize_nearest`).
"""

from __future__ import annotations

import functools

import numpy as np

from clipself_tpu_torch.core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

_MEAN = np.asarray(OPENAI_DATASET_MEAN, np.float32)
_STD = np.asarray(OPENAI_DATASET_STD, np.float32)

# Pillow's 8-bit resampling: weights with this many fraction bits, sums
# started at half a unit and shifted back (`Resample.c`)
PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's `bicubic_filter` (a = -0.5), elementwise."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    """Pillow's `bilinear_filter` (the triangle), elementwise."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


@functools.lru_cache(maxsize=4096)
def coeffs(in_size: int, out_size: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's `precompute_coeffs` for a whole-image resize along one axis:
    (index [out, K] int64 of the taps' source pixels, weights [out, K]
    float64 normalised to sum 1). Taps are centred at ``(x + 0.5) * in /
    out``, bounds rounded by ``(int)(c +- support + 0.5)`` and clamped; a
    row shorter than K is padded with weight 0 on its last source pixel.
    The double arithmetic follows the C order, elementwise over the rows:
    each row's sum runs over its taps from the first, as the C loop adds."""
    fn, base_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    inside = x[None, :] < xmax[:, None]
    taps = np.where(inside, fn((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss), 0.0)
    total = np.add.accumulate(taps, axis=1)[:, -1:]  # left to right, as the C loop
    with np.errstate(divide="ignore", invalid="ignore"):
        weight = np.where(total != 0.0, taps / total, taps)
    index = np.where(inside, xmin[:, None] + x[None, :], (xmin + xmax - 1)[:, None])
    index.flags.writeable = weight.flags.writeable = False
    return index, weight


@functools.lru_cache(maxsize=4096)
def fixed_coeffs(in_size: int, out_size: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """`coeffs` with Pillow's `normalize_coeffs_8bpc` weights for its 8-bit
    passes: ``(int)(+-0.5 + k * 2^22)``, rounded half away from zero (C
    truncation toward zero after the +-0.5), as int32."""
    index, weight = coeffs(in_size, out_size, kind)
    scaled = weight * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(scaled < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    fixed.flags.writeable = False
    return index, fixed


def _pass_u8(img: np.ndarray, out_size: int, axis: int, kind: str, lo: int = 0, hi=None) -> np.ndarray:
    """One 8-bit pass of Pillow's filter ``kind`` ("bicubic" or
    "bilinear") over a uint8 [H, W, C] image along ``axis`` (1: horizontal,
    0: vertical), computing the output pixels ``lo`` to ``hi`` of
    ``out_size``: int32 sums from 2^21 over the taps, shifted by 22 bits and
    clipped to 0-255, as `clip8` does."""
    index, fixed = fixed_coeffs(img.shape[axis], out_size, kind)
    index, fixed = index[lo:hi], fixed[lo:hi]
    shape = [1, 1, 1]
    shape[axis] = len(index)
    out_shape = tuple(len(index) if i == axis else n for i, n in enumerate(img.shape))
    acc = np.full(out_shape, 1 << (PRECISION_BITS - 1), np.int32)
    tap = np.empty(out_shape, np.int32)
    for k in range(index.shape[1]):
        np.multiply(np.take(img, index[:, k], axis=axis), fixed[:, k].reshape(shape), out=tap)
        acc += tap
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _check_size(img: np.ndarray, size: tuple[int, int]) -> None:
    if (size[0] < 1 or size[1] < 1) and tuple(size) != image_size(img):
        raise ValueError(f"resize to {tuple(size)}: height and width must be > 0")


def _resize_u8(img: np.ndarray, size: tuple[int, int], kind: str, window=None) -> np.ndarray:
    w, h = size
    _check_size(img, size)
    x0, y0, x1, y1 = window or (0, 0, w, h)
    # the part of the window inside the resize; Pillow's crop fills the rest with 0
    ix0, iy0, ix1, iy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if img.size == 0 or ix1 <= ix0 or iy1 <= iy0:
        return np.zeros((y1 - y0, x1 - x0) + img.shape[2:], np.uint8)
    out = _pass_u8(img, w, 1, kind, ix0, ix1) if w != img.shape[1] else img[:, ix0:ix1]
    out = _pass_u8(out, h, 0, kind, iy0, iy1) if h != img.shape[0] else out[iy0:iy1]
    if (ix0, iy0, ix1, iy1) != (x0, y0, x1, y1):
        whole = np.zeros((y1 - y0, x1 - x0) + img.shape[2:], np.uint8)
        whole[iy0 - y0:iy1 - y0, ix0 - x0:ix1 - x0] = out
        return whole
    return out.copy() if np.may_share_memory(out, img) else out


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``img`` uint8 [H, W, C] resized to ``size`` = (w, h), equal to
    ``Image.fromarray(img).resize(size, Image.BICUBIC)``: the horizontal
    pass first, then the vertical; a pass whose size does not change is
    skipped. An empty image resizes to black; an empty size raises, as in
    Pillow."""
    return _resize_u8(img, size, "bicubic")


def resize_bilinear(img: np.ndarray, size: tuple[int, int], window=None) -> np.ndarray:
    """``img`` uint8 [H, W, C] resized to ``size`` = (w, h), equal to
    ``Image.fromarray(img).resize(size, Image.BILINEAR)`` (the detector's
    resizes): Pillow's triangle filter, widened by the shrink factor, in
    the same 8-bit passes as `resize_bicubic`. ``window`` = (x0, y0, x1, y1)
    in the resized image's pixels: only that crop of the resized image is
    computed and returned, equal to ``.crop(window)`` of Pillow's whole
    resize (each output pixel depends on its own taps alone), the part
    outside ``size`` zero-filled as Pillow's crop fills it."""
    return _resize_u8(img, size, "bilinear", window)


def resize_bilinear_u8(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """A uint8 [H, W] image resized to ``hw`` = (h, w) exactly as
    ``PIL.Image.fromarray(img).resize((w, h), Image.BILINEAR)``:
    `resize_bilinear` on one channel."""
    return resize_bilinear(img[..., None], (hw[1], hw[0]))[..., 0]


@functools.lru_cache(maxsize=4096)
def _nearest_index(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Source index of each output pixel under Pillow's NEAREST resize
    (`ImagingScaleAffine`): a position starting at half a step and advanced
    by adding the step in double once a pixel, truncated; an index outside
    the source leaves the pixel 0. The running sum can differ from
    ``(x + 0.5) * step`` where the step is not a binary fraction (1/3, 3/7)."""
    step = in_size / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    idx = np.where(pos < 0.0, -1, pos.astype(np.int64))
    inside = (idx >= 0) & (idx < in_size)
    idx = np.clip(idx, 0, in_size - 1)
    idx.flags.writeable = inside.flags.writeable = False
    return idx, inside


def resize_nearest(m: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """A [H, W] raster resized to ``hw`` as Pillow's NEAREST resize does."""
    if m.shape == tuple(hw):
        return m.copy()
    yi, yv = _nearest_index(m.shape[0], hw[0])
    xi, xv = _nearest_index(m.shape[1], hw[1])
    out = m[yi][:, xi]
    if not (yv.all() and xv.all()):
        out[~yv] = 0
        out[:, ~xv] = 0
    return out


def resize_bilinear_f32(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """A float32 [H, W] image resized to ``size`` = (w, h) as Pillow's
    BILINEAR resize of an "F" image (`ImagingResampleHorizontal_32bpc`):
    weights normalised in double, each output a sum in double over its taps
    in order, stored as float32 after each pass."""
    w, h = size
    _check_size(img, size)
    if img.size == 0:
        return np.zeros((h, w), np.float32)
    out = img.astype(np.float32)
    for axis, n in ((1, w), (0, h)):
        if n == out.shape[axis]:
            continue
        index, weight = coeffs(out.shape[axis], n, "bilinear")
        src = out.astype(np.float64)
        shape = [1, 1]
        shape[axis] = n
        acc = np.zeros(tuple(n if i == axis else m for i, m in enumerate(out.shape)), np.float64)
        for k in range(index.shape[1]):
            acc += np.take(src, index[:, k], axis=axis) * weight[:, k].reshape(shape)
        out = acc.astype(np.float32)
    return out


def crop(img: np.ndarray, box) -> np.ndarray:
    """``Image.crop(box)``: the corners rounded as Pillow rounds them
    (``map(int, map(round, box))``, half to even), the part outside the
    image filled with 0. A box whose right or lower edge lies before its
    left or upper edge raises, as Pillow's does."""
    if box[2] < box[0] or box[3] < box[1]:
        raise ValueError(f"crop box {tuple(box)}: right < left or lower < upper")
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:], img.dtype)
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def to_normalized_array(img: np.ndarray) -> np.ndarray:
    """RGB uint8 [H, W, 3] -> float32 [H, W, 3], OpenAI-normalized."""
    arr = img.astype(np.float32)
    arr /= 255.0
    arr -= _MEAN
    arr /= _STD
    return arr


def _resize_to_max(img: np.ndarray, max_size: int) -> np.ndarray:
    h, w = img.shape[:2]
    scale = max_size / float(max(h, w))
    return resize_bicubic(img, (round(w * scale), round(h * scale)))


def resize_longest(img: np.ndarray, max_size: int, fill: int = 0) -> np.ndarray:
    """Scale so the longest side == max_size; pad bottom-right to square."""
    img = _resize_to_max(img, max_size)
    nh, nw = img.shape[:2]
    if (nw, nh) == (max_size, max_size):
        return img
    canvas = np.full((max_size, max_size) + img.shape[2:], fill, img.dtype)
    canvas[:nh, :nw] = img
    return canvas


def resize_max_center(img: np.ndarray, max_size: int, fill: int = 0) -> np.ndarray:
    """Scale so the longest side == max_size; pad symmetrically (center)."""
    img = _resize_to_max(img, max_size)
    nh, nw = img.shape[:2]
    if (nw, nh) == (max_size, max_size):
        return img
    top, left = (max_size - nh) // 2, (max_size - nw) // 2
    canvas = np.full((max_size, max_size) + img.shape[2:], fill, img.dtype)
    canvas[top : top + nh, left : left + nw] = img
    return canvas


def det_transform(img: np.ndarray, det_size: int) -> np.ndarray:
    return to_normalized_array(resize_longest(img, det_size))


def crop_transform(img: np.ndarray, crop_size: int) -> np.ndarray:
    return to_normalized_array(resize_max_center(img, crop_size))


def get_scale(old_wh: tuple[int, int], new_size: int) -> float:
    """Scale factor from original (w, h) to the padded new_size square
    (reference get_scale: min over axes of new/old == new_size / max(w, h))."""
    w, h = old_wh
    return new_size / float(max(w, h))


def resize_mask_longest(mask: np.ndarray, max_size: int) -> np.ndarray:
    """Downsample a binary [H, W] mask with the ResizeLongest geometry
    (bilinear > 0 thresholding, reference data.py:308-309,374-375)."""
    h, w = mask.shape
    scale = max_size / float(max(h, w))
    nh, nw = round(h * scale), round(w * scale)
    resized = resize_bilinear_f32(mask.astype(np.float32), (nw, nh))
    out = np.zeros((max_size, max_size), np.float32)
    out[:nh, :nw] = (resized > 0.0).astype(np.float32)
    return out


def image_size(img: np.ndarray) -> tuple[int, int]:
    """(w, h), as `PIL.Image.size` orders them."""
    return img.shape[1], img.shape[0]


class RandomResize:
    """Random rescale by a factor in [lo, hi] (reference
    `CustomRandomResize`, `custom_transforms.py:8-24`)."""

    def __init__(self, scale=(0.5, 2.0)):
        self.lo, self.hi = scale

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        s = rng.uniform(self.lo, self.hi)
        w, h = image_size(img)
        return resize_bicubic(img, (max(1, round(w * s)), max(1, round(h * s))))


class RandomCrop:
    """Random crop bounded to the image (reference `CustomRandomCrop`,
    `custom_transforms.py:27-44`): crop size = min(size, image dims)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        w, h = image_size(img)
        cw, ch = min(self.size, w), min(self.size, h)
        x0 = int(rng.integers(0, w - cw + 1))
        y0 = int(rng.integers(0, h - ch + 1))
        return crop(img, (x0, y0, x0 + cw, y0 + ch))


class RandomHFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() < self.p:
            return img[:, ::-1].copy()
        return img
