"""ctypes binding to the native C++ loader core, `native/loader.cc` (a copy
of `clipself_tpu/data/native_loader.py`).

The core does the host-side hot path of the distill data: JPEG/PNG decode
(libjpeg, libpng), antialiased resize, crop, normalize and pad, run by a C++
thread pool that writes into caller-owned float32 buffers. The library is
built from the checkout's sources with `make -C native` at first use (it
needs g++ and the libjpeg and libpng headers). Where it cannot be built,
`load()` raises with the build's error: callers that need the core (a JPEG
to decode, `--native-loader`) fail rather than fall back.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libclipself_loader.so"
_lib = None


def build_native() -> None:
    """Compile the shared library in-tree (`make -C native`) under an
    exclusive lock on the Makefile, so that data loader workers starting
    together build it once; raises RuntimeError with the build's output
    when it fails."""
    try:
        with open(_NATIVE_DIR / "Makefile") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            proc = subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)], capture_output=True, text=True
            )
    except OSError as e:
        raise RuntimeError(f"native loader core unavailable: make -C {_NATIVE_DIR}: {e}") from e
    if proc.returncode != 0 or not _LIB_PATH.exists():
        raise RuntimeError(
            f"native loader core unavailable: make -C {_NATIVE_DIR} failed:\n"
            f"{proc.stdout}{proc.stderr}"
        )


def load() -> ctypes.CDLL:
    """The bound library, built first if needed; raises RuntimeError with
    the build's output when it cannot be built, and with the loader's
    message when it cannot be loaded (say, built where libjpeg was and
    loaded where it is not)."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        build_native()
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        raise RuntimeError(f"native loader core unavailable: cannot load {_LIB_PATH}: {e}") from e
    lib.csl_pool_create.restype = ctypes.c_void_p
    lib.csl_pool_create.argtypes = [ctypes.c_int]
    lib.csl_pool_destroy.restype = None
    lib.csl_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.csl_pool_wait.restype = ctypes.c_int
    lib.csl_pool_wait.argtypes = [ctypes.c_void_p]
    lib.csl_pool_wait_status.restype = ctypes.c_int
    lib.csl_pool_wait_status.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ]
    lib.csl_decode.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.csl_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.csl_free.restype = None
    lib.csl_free.argtypes = [ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.csl_submit_distill_item.restype = ctypes.c_int
    lib.csl_submit_distill_item.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p, f32p, f32p,
    ]
    lib.csl_submit_resize_pad.restype = ctypes.c_int
    lib.csl_submit_resize_pad.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, f32p, f32p, f32p, f32p,
    ]
    _lib = lib
    return lib


def decode(path: str) -> Optional[np.ndarray]:
    """Decode an image file to an RGB uint8 [H, W, 3] array; None when the
    core cannot decode it. Raises when the core is unavailable."""
    lib = load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = lib.csl_decode(os.fsencode(path), ctypes.byref(w), ctypes.byref(h))
    if not buf:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.csl_free(buf)
    return arr


class NativePool:
    """Thread-pool wrapper: submit decode/transform jobs, then wait.

    Buffers passed to submit_* must stay alive until the wait returns; the
    pool holds a reference to each until then.
    """

    def __init__(self, num_threads: Optional[int] = None):
        self._lib = load()
        n = num_threads or max(os.cpu_count() or 1, 1)
        self._pool = self._lib.csl_pool_create(n)
        self._refs = []

    def submit_distill_item(
        self,
        path: str,
        det_out: np.ndarray,
        crops_out: np.ndarray,
        crop_boxes: np.ndarray,
        mean: np.ndarray,
        std: np.ndarray,
    ):
        """det_out: [S, S, 3] f32; crops_out: [M, s, s, 3] f32; crop_boxes:
        [K, 4] xyxy in original pixel coords, K <= M (rows of crops_out
        beyond K are left untouched: callers pre-zero them)."""
        m = int(crop_boxes.shape[0])
        if m > crops_out.shape[0]:
            raise ValueError(f"{m} crop boxes but only {crops_out.shape[0]} output rows")
        if not crops_out.flags["C_CONTIGUOUS"]:
            # reshape(-1) of a strided view would hand the C++ job a
            # temporary copy: results lost and freed memory written
            raise ValueError("crops_out must be C-contiguous")
        crops_flat = crops_out.reshape(-1)
        self._lib.csl_submit_distill_item(
            self._pool, os.fsencode(path), det_out.shape[0], crops_out.shape[1], m,
            np.ascontiguousarray(crop_boxes, np.float32),
            np.ascontiguousarray(mean, np.float32),
            np.ascontiguousarray(std, np.float32),
            det_out, crops_flat,
        )
        self._refs.append((det_out, crops_flat))

    def submit_resize_pad(
        self, path: str, out: np.ndarray, scale_out: np.ndarray,
        mean: np.ndarray, std: np.ndarray,
    ):
        self._lib.csl_submit_resize_pad(
            self._pool, os.fsencode(path), out.shape[0],
            np.ascontiguousarray(mean, np.float32),
            np.ascontiguousarray(std, np.float32),
            out, scale_out,
        )
        self._refs.append((out, scale_out))

    def wait_status(self, num_jobs: int) -> np.ndarray:
        """Block until all jobs finish; returns a [num_jobs] uint8 array of
        per-job success flags (1 ok, 0 failed) in submission order. If the
        pool's job count disagrees with ``num_jobs`` (stale jobs of an
        abandoned iterator on a reused pool), every flag reports failure:
        misaligned flags force the per-row fallback, never mark a bad row ok."""
        out = np.zeros(max(num_jobs, 1), np.uint8)
        n = self._lib.csl_pool_wait_status(self._pool, out, out.shape[0])
        self._refs.clear()
        if n != num_jobs:
            return np.zeros(num_jobs, np.uint8)
        return out[:num_jobs]

    def close(self):
        if getattr(self, "_pool", None):
            # destroy joins the workers (in-flight jobs finish, queued jobs
            # are discarded); only then may the buffer refs be released
            self._lib.csl_pool_destroy(self._pool)
            self._pool = None
            self._refs.clear()

    def __del__(self):  # pragma: no cover
        self.close()
