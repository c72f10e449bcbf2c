"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (`sm_90a`),
all of them at once (`csrc/*.cuh` are headers they include: hashed, not
compiled), and the objects are linked into one shared library
with a plain C interface, which is loaded with `ctypes`. The build happens
at first use, into `build/kernels/<hash>/` at the root of the checkout
(listed in `.gitignore`), and is reused while the sources and flags hash
the same. Nothing here runs at import time: the CPU tests import every
module of the port on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libclipself_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: (argtypes, restype)
    "clipself_rope_roll": ((_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "clipself_flash_fwd": (
        (_I,) + (_P,) * 5 + (_I,) * 4 + (_L,) * 9 + (ctypes.c_float, _P),
        _I,
    ),
    "clipself_flash_bwd": (
        (_I,) + (_P,) * 10 + (_I,) * 4 + (_L,) * 9 + (ctypes.c_float, _P),
        _I,
    ),
    "clipself_flash_fwd_design": ((_I, _I), _I),
    "clipself_flash_bwd_design": ((_I, _I), _I),
    "clipself_wgmma_probe": ((_I, _I, _I, _P, _P, _P, _P), _I),
    "clipself_tf32_probe": ((_I, _I, _I, _I, _P, _P, _P, _P), _I),
    "clipself_layer_norm_fwd": (
        (_I,) + (_P,) * 6 + (_L, _I, _L, _L, _I, ctypes.c_float, _P),
        _I,
    ),
    "clipself_layer_norm_bwd": (
        (_I,) + (_P,) * 9 + (_L, _I, _L, _L) + (_I,) * 7 + (_P,),
        _I,
    ),
    "clipself_layer_norm_setup_calls": ((), _I),
    "clipself_nms": ((_P, _P, ctypes.c_float, _P, _P, _I, _I, _P), _I),
    "clipself_cuda_error_string": ((_I,), ctypes.c_char_p),
}


class LaunchCounter:
    """Number of kernel launches a wrapper has made since the last reset."""

    def __init__(self):
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


class _Library:
    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds = None  # wall time of the nvcc run, None if cached

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        sources = sorted(CSRC.glob("*.cu"))
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(CSRC.glob("*.cu*")):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
        lib_path = out_dir / _LIB_NAME
        if not lib_path.exists():
            self.build_seconds = _compile(sources, out_dir, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        return lib


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")


def _compile(sources, out_dir: Path, lib_path: Path) -> float:
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [str(Path(tmp_dir) / f"{src.stem}.o") for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)] for src, o in zip(sources, objs)])
        # link under a temporary name and rename, so that a cut-off build
        # never leaves a library that a later run would load
        tmp = str(Path(tmp_dir) / _LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, lib_path)
    return time.perf_counter() - t0


LIBRARY = _Library()


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = LIBRARY.get().clipself_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def refuse_dtensor(what: str, *tensors) -> None:
    """A kernel takes one rank's local tensors. A `DTensor` (a sharded
    parameter of FSDP2 or a tensor-parallel layout) raises: the wrappers
    never gather it quietly and never take the plain version for it."""
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{what}: got a DTensor ({tuple(t.placements)} over {t.device_mesh}); "
                "the kernels take local tensors"
            )


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
