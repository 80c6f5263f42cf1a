"""Build and load the port's CUDA sources: ``nvcc`` by hand into a shared
library with a plain C interface, loaded with ``ctypes``.

Each source under ``tclb_tpu_torch/csrc/`` builds once per content into
``build/tclb_tpu_torch/libtclb_<name>_<digest>.so``; a template built per
model (``generic2d``, ``generic3d``) pre-includes the model's device header
(``nvcc -include csrc/models/<model>.cuh``) into
``libtclb_<name>_<model>_<digest>.so``; a source built per model with
compiler flags of its own (``d2q9`` for its family: ``-DD2Q9_MODEL=<id>``)
goes to ``libtclb_<name>_<variant>_<digest>.so``.  The digest covers the
source, the
pre-included header, every header either includes from ``csrc/``
(``#include "..."``, followed recursively) and the compiler flags, and the
compiler's report
(``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
beside the library.  Nothing here runs at import: the kernel modules build
at first use.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "tclb_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source besides NVCC_FLAGS: the generic kernels keep every
# multiply and add apart, as the plain PyTorch versions compute them
SOURCE_FLAGS = {"generic2d": ("--fmad=false",),
                "generic3d": ("--fmad=false",)}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included(src: pathlib.Path) -> list[pathlib.Path]:
    """``src`` and the headers it includes with ``#include "..."``,
    recursively, resolved against the including file's directory (the
    headers of the CUDA toolkit, included with ``<...>``, are not
    followed)."""
    seen: list[pathlib.Path] = []
    todo = [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            todo.append((path.parent / name).resolve())
    return seen


def _flags(name: str, header: Optional[str], extra: tuple = ()) -> tuple:
    pre = () if header is None else ("-include", header)
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ()) + tuple(extra) + pre


def digest(name: str, header: Optional[str] = None,
           extra: tuple = ()) -> str:
    """Content digest of ``csrc/<name>.cu`` built with the pre-included
    ``csrc/<header>`` (if any) and the flags ``extra``, the headers both
    include and the compiler flags."""
    h = hashlib.sha1()
    paths = [] if header is None else included(CSRC / header)
    for path in paths + included(CSRC / f"{name}.cu"):
        h.update(path.read_bytes())
    h.update(" ".join(_flags(name, header, extra)).encode())
    return h.hexdigest()[:12]


def nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build(name: str, header: Optional[str] = None,
          variant: Optional[tuple[str, tuple]] = None
          ) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a (once per source content),
    with ``csrc/<header>`` pre-included where given (a model's device
    header), or as ``variant = (label, flags)`` with compiler flags of its
    own.  Returns the library path and the compiler's report."""
    src = CSRC / f"{name}.cu"
    extra = () if variant is None else tuple(variant[1])
    tag = digest(name, header, extra)
    stem = name if header is None else \
        f"{name}_{pathlib.Path(header).stem}"
    if variant is not None:
        stem = f"{stem}_{variant[0]}"
    lib = BUILD_DIR / f"libtclb_{stem}_{tag}.so"
    report = BUILD_DIR / f"libtclb_{stem}_{tag}.log"
    if lib.exists():
        return lib, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    flags = [str(CSRC / f) if f == header else f
             for f in _flags(name, header, extra)]
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr
