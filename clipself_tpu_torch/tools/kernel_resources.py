"""Registers, spill bytes and stack of every kernel the port builds, as
`ptxas -v` reports them: each `csrc/*.cu` compiled by its own `nvcc` with
the build's flags (`ops/_build.py::NVCC_FLAGS`), all at once, nothing linked
or loaded. Needs `nvcc` (the card's machine), not a card.

    python -m clipself_tpu_torch.tools.kernel_resources [--match x3]

One line a kernel: file, demangled name (`cu++filt` beside `nvcc`), the
registers a thread, spill stores / loads in bytes, and the stack frame.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import tempfile
from pathlib import Path

from clipself_tpu_torch.ops import _build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def parse(text: str) -> list[dict]:
    """The kernels of one `ptxas -v` output, in its order: mangled name,
    registers, stack frame and spill bytes."""
    rows, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "stack": 0, "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (int(g) for g in m.groups())
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def demangle(names: list[str], nvcc: str) -> list[str]:
    filt = Path(nvcc).with_name("cu++filt")
    if not filt.exists() or not names:
        return names
    out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True, check=True)
    return out.stdout.splitlines()


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--match", default="", help="keep the kernels whose demangled name holds this")
    args = parser.parse_args(argv)
    nvcc = _build._nvcc()
    sources = sorted(_build.CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [
            subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(Path(tmp) / f"{src.stem}.o"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src in sources
        ]
        outs = [p.communicate()[0] for p in procs]
    rows = []
    for src, proc, out in zip(sources, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        found = parse(out)
        for row, name in zip(found, demangle([r["kernel"] for r in found], nvcc)):
            row.update(file=src.name, name=name)
            if args.match in name:
                rows.append(row)
                print(
                    f"{src.name}: {name}: {row['registers']} registers, spill {row['spill_stores']} / "
                    f"{row['spill_loads']} bytes, stack {row['stack']} bytes",
                    flush=True,
                )
    return rows


if __name__ == "__main__":
    main()
