#!/usr/bin/env python3
"""Hold this checkout's builds of ``tclb_tpu_torch/csrc/d3q27.cu`` against
another copy of that source (a parent commit's, say) on one CUDA card.

    python3 d3q27_build_parity.py OTHER/d3q27.cu

Both sources are built alike (``nvcc`` for sm_90a with the port's flags
and ``-Xptxas -v``): without a model define (d3q27_cumulant), and, as
the port builds them, once for each of d3q27_BGK, d3q27_BGK_galcor,
d3q19 and d3q19_les (``-DD3Q_MODEL=<id> --fmad=false``).  An other
source that includes headers of its own (``#include "models/..."``) finds
them beside it.  The script prints both compiler reports (registers,
shared memory, spills per kernel), runs ``d3q27_step`` and
``d3q27_step2`` of both libraries on the same inputs (for the cumulant a
12x8x64 state that paints every node type, the initial state of
``example/3d_channel.xml`` warmed 4 steps, and that of
``example/3dcum_turbulence.xml`` with its SynthT planes drawn; for each
other model a 12x8x64 state that paints every node type it reads and
bench.py's 48x48x256 channel warmed 4 steps), times both kernels of both
cumulant libraries on the 3d_channel state (CUDA events, the median of
``REPS`` launches each, the libraries alternating in rounds) and exits
nonzero unless every output is bit for bit the same.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent
REPS, ROUNDS = 100, 4      # launches a round, rounds a library (timing)


def build(src: pathlib.Path, out: pathlib.Path,
          flags: tuple = ()) -> tuple[ctypes.CDLL, str]:
    from tclb_tpu_torch.ops import _cuda_build
    proc = subprocess.run([_cuda_build.nvcc(), *_cuda_build.NVCC_FLAGS,
                           *flags, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("d3q27_step", "d3q27_step2"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i, p]
        getattr(lib, name).restype = i
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


def median_ms(launches: dict) -> dict:
    """Each library's median launch time in ms: ``launches`` maps a tag
    to a function that launches its kernel once; the libraries alternate
    in ``ROUNDS`` rounds of ``REPS`` launches after a warm-up."""
    times = {tag: [] for tag in launches}
    for fn in launches.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(ROUNDS):
        for tag, fn in launches.items():
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times[tag].append(start.elapsed_time(end))
    return {tag: statistics.median(t) for tag, t in times.items()}


def compare(libs: dict, lats: dict, label: str) -> bool:
    """Both kernels of both libraries on each lattice's state: whether
    every output is bit for bit the same (and, on the 3d_channel state, the
    kernels' times)."""
    from tclb_tpu_torch.ops import d3q27_kernels as dk3
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
            args = ctypes.byref(a.c_struct(zc if name == "d3q27_step2"
                                           else 1))
            outs = [torch.empty_like(f) for _ in libs]

            def launch(lib, out, name=name, args=args):
                rc = getattr(lib, name)(
                    f.data_ptr(), out.data_ptr(), flags.data_ptr(),
                    ztab.data_ptr(), args, dev, stream)
                if rc:
                    raise SystemExit(f"{name} failed: CUDA error {rc}")
            for lib, out in zip(libs.values(), outs):
                launch(lib, out)
            torch.cuda.synchronize()
            if what == "3d_channel":
                ms = median_ms({tag: (lambda lib=lib, out=out:
                                      launch(lib, out))
                                for (tag, lib), out in zip(libs.items(),
                                                           outs)})
                print(f"{name} on {what}: " + ", ".join(
                    f"{tag} {v:.5f} ms" for tag, v in ms.items())
                    + f" (medians of {ROUNDS}x{REPS} launches)")
            equal = torch.equal(outs[0], outs[1])
            diff = float((outs[0] - outs[1]).abs().max())
            print(f"{label} {name} on {what} {tuple(f.shape)}: "
                  f"{'bit-identical' if equal else 'DIFFERS'} "
                  f"(max abs diff {diff:.3e})")
            same &= equal
    return same


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
    # (label, compiler flags, lattices) of each build: the cumulant's, then
    # each z-slab family model's with its define
    builds = [("d3q27_cumulant", (), lambda: {
        "rich 12x8x64": chip_smoke.rich3d_lattice("cuda"),
        "3d_channel": chip_smoke.case_lattice(
            chip_smoke.CHANNEL3D_XML, torch.float32, "cuda"),
        "3dcum_turbulence": chip_smoke.turbulence_lattice("cuda")})]
    builds += [(m, (f"-DD3Q_MODEL={dk3.MODEL_ID[m]}",) + dk3.FAMILY_FLAGS,
                lambda m=m: {
                    "rich 12x8x64": chip_smoke.rich_d3q_lattice(m, "cuda"),
                    "channel48": chip_smoke.channel48_lattice(m, "cuda")})
               for m in chip_smoke.D3Q_FAMILY]
    srcs = {"this": ROOT / "tclb_tpu_torch" / "csrc" / "d3q27.cu",
            "other": other}
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        # every library at once, one nvcc each
        jobs = [(label, flags, tag) for label, flags, _ in builds
                for tag in srcs]
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            built = dict(zip(
                [(label, tag) for label, _, tag in jobs],
                pool.map(lambda j: build(srcs[j[2]], pathlib.Path(tmp)
                                         / f"lib_{j[0]}_{j[2]}.so", j[1]),
                         jobs)))
        for label, flags, lattices in builds:
            libs = {}
            for tag, src in srcs.items():
                lib, report = built[(label, tag)]
                libs[tag] = lib
                print(f"{label} {tag} ({src}): registers "
                      f"{registers(report)}")
                for line in report.splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas: {line.strip()}")
            lats = lattices()
            for what in ("3d_channel", "channel48"):
                if what in lats:
                    chip_smoke.eager_warm(lats[what], 4)
            same &= compare(libs, lats, label)
    print(chip_smoke.card_line())
    print("d3q27_build_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
