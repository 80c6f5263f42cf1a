#!/usr/bin/env python3
"""Hold this checkout's d3q27_cumulant build of
``tclb_tpu_torch/csrc/d3q27.cu`` against another copy of that source (a
parent commit's, say) on one CUDA card.

    python3 d3q27_build_parity.py OTHER/d3q27.cu

Both sources are built alike (``nvcc`` for sm_90a with the port's flags
and ``-Xptxas -v``, no model define: d3q27_cumulant).  The script prints
both compiler reports (registers, shared memory, spills per kernel), runs
``d3q27_step`` and ``d3q27_step2`` of both libraries on the same inputs
(a 12x8x64 state that paints every node type, the initial state of
``example/3d_channel.xml`` warmed 4 steps, and that of
``example/3dcum_turbulence.xml`` with its SynthT planes drawn) and exits
nonzero unless every output is bit for bit the same.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent


def build(src: pathlib.Path, out: pathlib.Path) -> tuple[ctypes.CDLL, str]:
    from tclb_tpu_torch.ops import _cuda_build
    proc = subprocess.run([_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS,
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("d3q27_step", "d3q27_step2"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i, p]
        getattr(lib, name).restype = i
    ip = ctypes.POINTER(i)
    lib.d3q27_step2_config.argtypes = [i, ip, ip, ip, ip]
    lib.d3q27_step2_config.restype = i
    return lib, proc.stdout + proc.stderr


def registers(report: str) -> dict:
    """Registers per kernel from a ``-Xptxas -v`` report."""
    out, kernel = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel] = int(m.group(1))
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("d3q27_build_parity: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke
    from tclb_tpu_torch.ops import d3q27_kernels as dk3
    other = pathlib.Path(sys.argv[1]).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for tag, src in (("this", ROOT / "tclb_tpu_torch" / "csrc"
                          / "d3q27.cu"), ("other", other)):
            lib, report = build(src, pathlib.Path(tmp) / f"lib_{tag}.so")
            libs[tag] = lib
            print(f"{tag} ({src}): registers {registers(report)}")
            for line in report.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")
        lats = {"rich 12x8x64": chip_smoke.rich3d_lattice("cuda"),
                "3d_channel": chip_smoke.case_lattice(
                    chip_smoke.CHANNEL3D_XML, torch.float32, "cuda"),
                "3dcum_turbulence": chip_smoke.turbulence_lattice("cuda")}
        chip_smoke.eager_warm(lats["3d_channel"], 4)
        same = True
        for what, lat in lats.items():
            f, flags, ztab, a = dk3.kernel_inputs(lat.model, lat.state,
                                                  lat.params)
            dev = f.device.index or 0
            stream = torch.cuda.current_stream(dev).cuda_stream
            cfg = dk3.step2_config(dev)
            zc = dk3.step2_planes(tuple(f.shape[1:]),
                                  cfg["sms"] * cfg["blocks_per_sm"])
            for name in ("d3q27_step", "d3q27_step2"):
                outs = []
                for lib in libs.values():
                    out = torch.empty_like(f)
                    rc = getattr(lib, name)(
                        f.data_ptr(), out.data_ptr(), flags.data_ptr(),
                        ztab.data_ptr(),
                        ctypes.byref(a.c_struct(zc if name == "d3q27_step2"
                                                else 1)), dev, stream)
                    if rc:
                        raise SystemExit(f"{name} failed: CUDA error {rc}")
                    outs.append(out)
                torch.cuda.synchronize()
                equal = torch.equal(outs[0], outs[1])
                diff = float((outs[0] - outs[1]).abs().max())
                print(f"{name} on {what} {tuple(f.shape)}: "
                      f"{'bit-identical' if equal else 'DIFFERS'} "
                      f"(max abs diff {diff:.3e})")
                same &= equal
    print(chip_smoke.card_line())
    print("d3q27_build_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
