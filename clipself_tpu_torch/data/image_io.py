"""Image files to NumPy arrays without PIL: the counterpart of
`clipself_tpu/data/datasets.py::_open_image`.

The decoder is chosen by the file's first bytes, as Pillow chooses it, not by
the file's extension. A PNG is decoded here with stdlib `zlib` and NumPy,
pixel for pixel what `PIL.Image.open(p)` gives (8-bit colour types 0, 2, 3,
4 and 6, every row filter); a JPEG through the native core's `csl_decode`
(libjpeg, `data/native_loader.py`), the library Pillow decodes with. A form
this module does not read (an interlaced or non-8-bit PNG, a GIF, BMP, TIFF
or WebP file) raises `ValueError` naming the file: Pillow would read it, so
it is not an unreadable image, and a dataset must not quietly resample past
it. A JPEG when the native core cannot be built raises too.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from clipself_tpu_torch.data import native_loader

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# forms Pillow reads and this module does not: first bytes -> name
_OTHER_FORMATS = (
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
)
# PNG colour type -> channels of `np.asarray(Image.open(p))` (0 = one, no axis)
_CHANNELS = {0: 0, 2: 3, 3: 0, 4: 2, 6: 4}
MIN_SIDE = 10  # the JAX pipeline drops images under 10 px on a side


class UnreadableImage(Exception):
    """A file that Pillow could not read either (corrupt, truncated, or of
    no image format): the datasets resample past it."""


def _chunks(data: bytes):
    """(type, payload) of each PNG chunk, CRCs checked (Pillow refuses a
    chunk whose CRC is wrong)."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise UnreadableImage("truncated chunk")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack(">I", data[end : end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise UnreadableImage(f"bad CRC in {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays (left, up, up-left)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of an 8-bit image: ``raw`` [H, W, C] uint8
    filtered bytes, ``filters`` [H] the filter type of each row (0 None,
    1 Sub, 2 Up, 3 Average, 4 Paeth). Returns [H, W, C] uint8.

    An image whose rows are all unfiltered is returned as it is. Sub,
    Average and Paeth need the byte just rebuilt to their left, so
    the rows are rebuilt together along anti-diagonals: pixel (y, x) needs
    (y, x-1), (y-1, x) and (y-1, x-1), all on earlier diagonals, so
    H + W - 1 vectorised steps rebuild the image. The image is held with a
    zero row above and a zero column on the left (the format's edge
    values), in which a diagonal is one strided view."""
    h, w, c = raw.shape
    if h == 0 or w == 0 or not filters.any():  # no row filtered: the bytes are the pixels
        return raw.copy()
    padded = np.zeros((h + 1, w + 1, c), np.uint8)
    rawp = np.zeros_like(padded)
    rawp[1:, 1:] = raw
    row = (w + 1) * c

    def diagonals(a: np.ndarray) -> np.ndarray:
        # [e, y', ch] -> flat[e * c + y' * (row - c) + ch]: pixel (y, x) sits
        # at e = x + y + 2, y' = y + 1; only in-image cells are ever indexed
        return np.lib.stride_tricks.as_strided(
            a, shape=(w + h + 1, h + 1, c), strides=(c, row - c, 1), writeable=True
        )

    out_d, raw_d = diagonals(padded), diagonals(rawp)
    ft = filters.astype(np.int16)[:, None]
    zero = np.zeros((h, c), np.int16)
    for e in range(2, w + h + 1):
        lo, hi = max(1, e - w), min(h, e - 1) + 1
        a = out_d[e - 1, lo:hi].astype(np.int16)
        b = out_d[e - 1, lo - 1 : hi - 1].astype(np.int16)
        cc = out_d[e - 2, lo - 1 : hi - 1].astype(np.int16)
        f = ft[lo - 1 : hi - 1]
        pred = np.choose(f, (zero[: hi - lo], a, b, (a + b) >> 1, _paeth(a, b, cc)))
        out_d[e, lo:hi] = raw_d[e, lo:hi] + pred  # cast to uint8 wraps mod 256
    return padded[1:, 1:].copy()


def decode_png(data: bytes, name: str = "<bytes>") -> tuple[np.ndarray, Optional[np.ndarray]]:
    """A PNG file's bytes -> (the array `np.asarray(PIL.Image.open(p))`
    gives, the palette [K, 3] of a palette image or None). The array is
    uint8: [H, W] for grayscale (type 0) and palette indices (type 3),
    [H, W, 2] gray and alpha (4), [H, W, 3] RGB (2), [H, W, 4] RGBA (6).
    Raises ValueError for an interlaced or non-8-bit file and
    UnreadableImage for a corrupt one."""
    if not data.startswith(PNG_SIGNATURE):
        raise UnreadableImage("not a PNG")
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise UnreadableImage("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise UnreadableImage(f"colour type {ctype}")
    if depth != 8 or interlace != 0:
        form = f"{depth}-bit, colour type {ctype}" + (", interlaced" if interlace else "")
        raise ValueError(
            f"{name}: PNG form not supported without PIL ({form}); "
            "only non-interlaced 8-bit PNGs are read"
        )
    if ctype == 3 and palette is None:
        raise UnreadableImage("palette image without PLTE")
    c = max(_CHANNELS[ctype], 1)
    try:
        flat = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise UnreadableImage(str(e)) from e
    stride = w * c + 1
    if len(flat) < stride * h:
        raise UnreadableImage("truncated image data")
    rows = np.frombuffer(flat, np.uint8, count=stride * h).reshape(h, stride)
    filters = rows[:, 0]
    if (filters > 4).any():
        raise UnreadableImage("unknown row filter")
    img = unfilter(rows[:, 1:].reshape(h, w, c), filters)
    return (img[..., 0] if _CHANNELS[ctype] == 0 else img), (palette if ctype == 3 else None)


def encode_png(img: np.ndarray, filters: str = "none") -> bytes:
    """A PNG file's bytes for an RGB uint8 [H, W, 3] array, written with
    `zlib` and NumPy. ``filters``: "none" (filter type 0 on every row: the
    decoder's row loop, no wavefront) or "cycle" (None, Sub, Up, Average and
    Paeth in turn, every form `unfilter` rebuilds)."""
    if filters not in ("none", "cycle"):
        raise ValueError(f"filters must be 'none' or 'cycle', not {filters!r}")
    h, w, _ = img.shape
    x = img.astype(np.int16)
    if filters == "none":
        kinds = np.zeros(h, np.int64)
        rows = img.reshape(h, -1)
    else:
        left = np.zeros_like(x)
        left[:, 1:] = x[:, :-1]
        up = np.zeros_like(x)
        up[1:] = x[:-1]
        ul = np.zeros_like(x)
        ul[1:, 1:] = x[:-1, :-1]
        preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, ul)])
        kinds = np.arange(h) % 5
        rows = ((x - preds[kinds, np.arange(h)]) % 256).astype(np.uint8).reshape(h, -1)
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def png_to_rgb(img: np.ndarray, palette: Optional[np.ndarray]) -> np.ndarray:
    """`Image.convert("RGB")` of a decoded PNG: palette indices through the
    palette (an index past its end is black), gray replicated, alpha
    dropped."""
    if palette is not None:
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette[:256]
        return table[img]
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path))` of a PNG file (see `decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)[0]


def _sniff(head: bytes, path: str) -> str:
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(JPEG_SIGNATURE):
        return "jpeg"
    for sig, fmt in _OTHER_FORMATS:
        if head.startswith(sig):
            raise ValueError(f"{path}: {fmt} is not read without PIL (only PNG and JPEG)")
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        raise ValueError(f"{path}: WebP is not read without PIL (only PNG and JPEG)")
    return "unknown"


def decode_image(path: str) -> np.ndarray:
    """An image file -> RGB uint8 [H, W, 3] (`Image.open(p).convert("RGB")`).
    Raises UnreadableImage for a file Pillow could not read either,
    ValueError for a form not read here, RuntimeError for a JPEG when the
    native core is unavailable."""
    with open(path, "rb") as f:
        data = f.read()
    kind = _sniff(data[:16], path)
    if kind == "png":
        return png_to_rgb(*decode_png(data, path))
    if kind == "jpeg":
        arr = native_loader.decode(path)
        if arr is None:
            raise UnreadableImage("libjpeg could not decode it")
        return arr
    raise UnreadableImage("no image signature")


def open_image(path: str) -> Optional[np.ndarray]:
    """RGB uint8 [H, W, 3] of an image file, or None where the JAX
    pipeline's `_open_image` gives None: a missing or unreadable file, or
    one under 10 px on a side. The errors of `decode_image` other than an
    unreadable file propagate."""
    try:
        img = decode_image(path)
    except (OSError, UnreadableImage):
        return None
    if img.shape[0] < MIN_SIDE or img.shape[1] < MIN_SIDE:
        return None
    return img
