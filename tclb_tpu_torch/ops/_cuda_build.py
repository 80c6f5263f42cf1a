"""Build and load the port's CUDA sources: ``nvcc`` by hand into a shared
library with a plain C interface, loaded with ``ctypes``.

Each source under ``tclb_tpu_torch/csrc/`` builds once per content into
``build/tclb_tpu_torch/lib<name>_<digest>.so``; the digest covers the
source and the compiler flags, and the compiler's report (``-Xptxas -v``:
registers, shared memory and spills per kernel) is kept beside the
library.  Nothing here runs at import: the kernel modules build at first
use.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "tclb_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a (once per source content).
    Returns the library path and the compiler's report."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libtclb_{name}_{digest}.so"
    report = BUILD_DIR / f"libtclb_{name}_{digest}.log"
    if lib.exists():
        return lib, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr
