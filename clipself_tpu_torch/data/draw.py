"""Pillow's filled polygon and rectangle on a binary raster, in NumPy.

`polygon` is what ``ImageDraw.Draw(im).polygon(xy, fill=1)`` sets on a
mode-"1" image of Pillow 12.1.0 (`Draw.c::polygon_generic`), pixel for
pixel; `rectangle` is ``ImageDraw.rectangle([x0, y0, x1, y1], fill=...)``.
The JAX package rasterises gt-mask polygons with the former
(`clipself_tpu/detector/data.py:307-320`) and draws the synthetic
detection sets' boxes with the latter (`clipself_tpu/tools/synth_det_data.py:93`).

The polygon's rules, as Pillow 12.1.0 applies them (held against it by a
hypothesis search in `tests/test_torch_detector_data.py`):

- vertices are cast to int, truncated toward zero;
- consecutive horizontal edges running the same way merge into one; the
  closing edge is added when the last vertex is not the first;
- a horizontal edge is drawn as its own span; every other edge is cut by
  each scanline y from the polygon's top to its bottom (clamped to the
  raster) at x = (y - y0) * dx + x0 in float32, dx = (x1 - x0) / (y1 - y0)
  in float32 and (x0, y0) the edge's first vertex;
- an edge's crossing on its bottom row is counted twice unless that row is
  the polygon's last;
- a corner: a non-vertical edge whose end lies on this row (not counted
  twice) takes the first earlier non-vertical edge that ends at the same
  pixel and row on the same side (both tops or both bottoms). If the two
  run in opposite x directions nothing changes; otherwise the edge's
  crossing moves to one pixel short of the pair's crossings on the next
  row (the previous row on the polygon's last), each rounded half away
  from zero, so the corner pixel joins the span next to it; never past the
  corner pixel itself;
- the crossings are sorted and each pair (a, b) fills from a rounded half
  up to b rounded half down (in float32), clipped to the raster.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _round_up(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_UP on float32: half away from zero, the +0.5 in float32."""
    v = np.asarray(v, _F32)
    half = _F32(0.5)
    return np.where(v >= 0, np.floor(v + half), -np.floor(np.abs(v) + half)).astype(np.int64)


def _round_down(v: np.ndarray) -> np.ndarray:
    """Pillow's ROUND_DOWN on float32: half toward zero."""
    v = np.asarray(v, _F32)
    half = _F32(0.5)
    return np.where(v >= 0, np.ceil(v - half), -np.ceil(np.abs(v) - half)).astype(np.int64)


def _hline(raster: np.ndarray, x0: int, y: int, x1: int) -> None:
    h, w = raster.shape
    if not 0 <= y < h or x0 >= w or x1 < 0:
        return
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if x0 <= x1:
        raster[y, x0 : x1 + 1] = True


def _edges(xy: list[tuple[int, int]]) -> list[list[int]]:
    """[x0, y0, x1, y1, xmin, xmax] of each edge, Pillow's merge of
    consecutive horizontal edges applied: an edge that continues the
    horizontal edge before it in the same direction widens that edge's
    x extent instead of being added."""
    edges: list[list[int]] = []
    for i in range(len(xy) - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            px = xy[i - 1][0]
            if x1 > x0 > px:
                edges[-1][5] = x1
                continue
            if x1 < x0 < px:
                edges[-1][4] = x1
                continue
        edges.append([x0, y0, x1, y1, min(x0, x1), max(x0, x1)])
    if xy[-1] != xy[0]:
        (x0, y0), (x1, y1) = xy[-1], xy[0]
        edges.append([x0, y0, x1, y1, min(x0, x1), max(x0, x1)])
    return edges


def polygon(raster: np.ndarray, points) -> np.ndarray:
    """Fill the polygon ``points`` ([N, 2] x, y, any real dtype) into the
    boolean [H, W] ``raster`` in place, as Pillow 12.1.0 fills it on a mode
    "1" image; returns the raster."""
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    if len(pts) == 0:
        return raster
    xy = [(int(x), int(y)) for x, y in np.trunc(pts)]
    h = raster.shape[0]
    top, bottom = h - 1, 0
    x0s, y0s, dxs, ymins, ymaxs, xmins, xmaxs = [], [], [], [], [], [], []
    for x0, y0, x1, y1, xmin, xmax in _edges(xy):
        lo, hi = min(y0, y1), max(y0, y1)
        top, bottom = min(top, lo), max(bottom, hi)
        if lo == hi:
            _hline(raster, xmin, lo, xmax)
            continue
        x0s.append(x0)
        y0s.append(y0)
        dxs.append(_F32(x1 - x0) / _F32(y1 - y0))
        ymins.append(lo)
        ymaxs.append(hi)
        xmins.append(xmin)
        xmaxs.append(xmax)
    top, bottom = max(top, 0), min(bottom, h)
    if not dxs:
        return raster
    x0a = np.asarray(x0s, _F32)
    y0a = np.asarray(y0s, np.int64)
    dxa = np.asarray(dxs, _F32)
    ymina = np.asarray(ymins, np.int64)
    ymaxa = np.asarray(ymaxs, np.int64)
    # the x of each edge's end on its top row and on its bottom row
    x_top = np.where(dxa > 0, xmins, xmaxs)
    x_bot = np.where(dxa > 0, xmaxs, xmins)

    def cross(i, y):
        return _F32(y - y0a[i]) * dxa[i] + x0a[i]

    for y in range(top, bottom + 1):
        act = np.nonzero((ymina <= y) & (y <= ymaxa))[0]
        if len(act) == 0:
            continue
        xs = (y - y0a[act]).astype(_F32) * dxa[act] + x0a[act]
        twice = (ymaxa[act] == y) & (y < bottom)
        ends = ((ymina[act] == y) | (ymaxa[act] == y)) & ~twice & (dxa[act] != 0)
        for slot in np.nonzero(ends)[0]:
            i = act[slot]
            at_top = ymina[i] == y
            cx = x_top[i] if at_top else x_bot[i]
            for k in range(i):
                if dxa[k] == 0:
                    continue
                if at_top:
                    joins = ymina[k] == y and x_top[k] == cx
                else:
                    joins = ymaxa[k] == y and x_bot[k] == cx
                if not joins:
                    continue
                if (dxa[i] > 0) != (dxa[k] > 0):
                    break
                off = -1 if y == bottom else 1
                a, b = _round_up([cross(i, y + off), cross(k, y + off)])
                if at_top == (dxa[i] > 0):
                    xs[slot] = max(min(a, b) - 1, cx)
                else:
                    xs[slot] = min(max(a, b) + 1, cx)
                break
        xs = np.sort(np.concatenate([xs, xs[twice]]))
        starts, stops = _round_up(xs[0::2]), _round_down(xs[1::2])
        for x0, x1 in zip(starts, stops):
            _hline(raster, int(x0), y, int(x1))
    return raster


def rectangle(img: np.ndarray, box, fill) -> np.ndarray:
    """``ImageDraw.Draw(im).rectangle(box, fill=fill)``: the inclusive box
    [x0, y0, x1, y1] (coordinates truncated to int) filled with ``fill``,
    clipped to ``img`` ([H, W] or [H, W, C]), in place. A box whose x1 < x0
    or y1 < y0 raises, as Pillow's does."""
    x0, y0, x1, y1 = (int(v) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"rectangle {tuple(box)}: x1 must be >= x0 and y1 >= y0")
    h, w = img.shape[:2]
    if y0 >= h or y1 < 0 or x0 >= w or x1 < 0:
        return img
    img[max(y0, 0) : min(y1, h - 1) + 1, max(x0, 0) : min(x1, w - 1) + 1] = fill
    return img
