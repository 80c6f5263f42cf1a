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
``d3q27_step2`` of both libraries, in f32 and on the shifted bf16 stack
(``d3q27_step_bf16``, ``d3q27_step2_bf16``), on the same inputs (for the
cumulant a 12x8x64 state that paints every node type, the initial state
of ``example/3d_channel.xml`` warmed 4 steps, and that of
``example/3dcum_turbulence.xml`` with its SynthT planes drawn; for each
other model a 12x8x64 state that paints every node type it reads and
bench.py's 48x48x256 channel warmed 4 steps), times ``d3q27_step2`` and
``d3q27_step2_bf16`` of both libraries of every build on the 3d_channel
state (the cumulant) or the 48x48x256 channel (CUDA events, the median of
``ROUNDS`` x ``REPS`` launches each, the libraries alternating in rounds)
and exits nonzero unless every output is bit for bit the same.  Each
library's ``d3q27_step2`` takes the z run its own configuration query
plans (``step2_zc``).

    python3 d3q27_build_parity.py --cut SRC/d3q27.cu

builds ``SRC``'s cumulant, BGK and d3q19 builds in the cut-down variants
``CUTS`` and times their ``d3q27_step2`` on those states: the instrument
that shows what holds the kernel back.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
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
    for name in ("d3q27_step_bf16", "d3q27_step2_bf16"):
        getattr(lib, name).argtypes = [p, p, p, p, p,
                                       ctypes.POINTER(ctypes.c_float), i, p]
        getattr(lib, name).restype = i
    lib.d3q27_step2_config.argtypes = [i, i] + [ctypes.POINTER(i)] * 4
    lib.d3q27_step2_config.restype = i
    return lib, proc.stdout + proc.stderr


def step2_zc(lib, shape, bf16: bool, dev: int) -> int:
    """The z planes a block of a library's ``d3q27_step2`` (``bf16``: its
    bf16 flavour) takes at ``shape``, planned from its own configuration
    query and column (``d3q27_step2_tile``; a library built from an
    earlier source without that export has 32x8 columns)."""
    from tclb_tpu_torch.ops import d3q27_kernels as dk3
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = lib.d3q27_step2_config(dev, int(bf16),
                                *[ctypes.byref(v) for v in vals])
    if rc:
        raise SystemExit(f"d3q27_step2_config failed: CUDA error {rc}")
    _, _, per_sm, sms = (v.value for v in vals)
    rows = 8
    if hasattr(lib, "d3q27_step2_tile"):
        tile = [ctypes.c_int(0), ctypes.c_int(0)]
        lib.d3q27_step2_tile(*[ctypes.byref(v) for v in tile])
        rows = tile[0].value
    return dk3.step2_planes(shape, sms * per_sm, rows)


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


def compare(libs: dict, lats: dict, label: str, timed: str) -> bool:
    """Every kernel of both libraries on each lattice's state, f32 and
    bf16 shifted: whether every output is bit for bit the same (and, on
    the state ``timed``, both libraries' ``d3q27_step2`` times)."""
    from tclb_tpu_torch.core import shift as ddf
    from tclb_tpu_torch.ops import d3q27_kernels as dk3
    same = True
    for what, lat in lats.items():
        f, flags, ztab, a = dk3.kernel_inputs(lat.model, lat.state,
                                              lat.params)
        fb = ddf.narrow_stack(f, torch.bfloat16,
                              ddf.stack_shift(lat.model, "shifted"))
        ab = dataclasses.replace(
            a, shift=ddf.kernel_shift(lat.model, "shifted"))
        shape = tuple(f.shape[1:])
        dev = f.device.index or 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name in ("d3q27_step", "d3q27_step2", "d3q27_step_bf16",
                     "d3q27_step2_bf16"):
            bf16 = name.endswith("bf16")
            x, xa = (fb, ab) if bf16 else (f, a)
            outs = [torch.empty_like(x) for _ in libs]
            launches = {}
            for (tag, lib), out in zip(libs.items(), outs):
                zc = (step2_zc(lib, shape, bf16, dev)
                      if name.startswith("d3q27_step2") else 1)
                head = (x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                        ztab.data_ptr(), ctypes.byref(xa.c_struct(zc)))
                tail = ((xa.c_shift,) if bf16 else ()) + (dev, stream)

                def launch(fn=getattr(lib, name), head=head, tail=tail):
                    rc = fn(*head, *tail)
                    if rc:
                        raise SystemExit(f"{name} failed: CUDA error {rc}")
                launch()
                launches[tag] = launch
            torch.cuda.synchronize()
            if what == timed and name.startswith("d3q27_step2"):
                ms = median_ms(launches)
                print(f"{label} {name} on {what}: " + ", ".join(
                    f"{tag} {v:.5f} ms" for tag, v in ms.items())
                    + f" (medians of {ROUNDS}x{REPS} launches)")
            equal = torch.equal(outs[0], outs[1])
            diff = float((outs[0].float() - outs[1].float()).abs().max())
            print(f"{label} {name} on {what} {tuple(x.shape)}: "
                  f"{'bit-identical' if equal else 'DIFFERS'} "
                  f"(max abs diff {diff:.3e})")
            same &= equal
    return same


# the cut-down variants of d3q27_step2 that --cut times: each drops one
# part of the kernel (a step's node update, where the pulled populations
# then pass through unchanged, or the whole of step 2)
CUTS = {"full": (), "step 1 bare": (0,), "step 2 bare": (1,),
        "both bare": (0, 1), "step 1 only": ("step 2",)}
CUT_MODELS = ("d3q27_cumulant", "d3q27_BGK", "d3q19")


def cut_source(text: str, cuts: tuple) -> str:
    """``text`` (a d3q27.cu) with the parts ``cuts`` names removed from
    ``d3q27_step2_kernel``: an int i drops the i-th ``node_update`` call
    there (0 is step 1's, 1 step 2's; the averages' increments become 0),
    ``"step 2"`` skips step 2 (``if (active2)`` never holds)."""
    start = text.index("d3q27_step2_kernel(")
    end = text.index("\n}\n", start)
    body = text[start:end]
    calls = [m.start() for m in re.finditer(r"node_update\(a, f, ", body)]
    if len(calls) != 2 or body.count("if (active2) {") != 1:
        raise SystemExit("--cut: d3q27_step2_kernel has not the two "
                         "node_update calls and the `if (active2)` it cuts")
    for i in sorted((c for c in cuts if isinstance(c, int)), reverse=True):
        stop = body.index(";", calls[i]) + 1
        body = (body[:calls[i]]
                + "for (int c_ = 0; c_ < 4; ++c_) inc[c_] = 0.f;"
                + body[stop:])
    if "step 2" in cuts:
        body = body.replace("if (active2) {", "if (false) {")
    return text[:start] + body + text[end:]


def cut_main(src: pathlib.Path) -> int:
    """Time ``d3q27_step2`` of ``src``'s cumulant, BGK and d3q19 builds
    in the variants ``CUTS`` (the 3d_channel state for the cumulant,
    bench.py's 48x48x256 channel for the others), the variants of a build
    alternating in rounds."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke
    from tclb_tpu_torch.ops import d3q27_kernels as dk3
    text = src.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for m in CUT_MODELS:
            flags = ("-I", str(src.parent)) + (
                () if m == dk3.MODEL else
                (f"-DD3Q_MODEL={dk3.MODEL_ID[m]}",) + dk3.FAMILY_FLAGS)
            for i, (tag, cuts) in enumerate(CUTS.items()):
                path = pathlib.Path(tmp) / f"cut_{m}_{i}.cu"
                path.write_text(cut_source(text, cuts))
                jobs.append((m, tag, path, flags))
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(
                lambda j: build(j[2], j[2].with_suffix(".so"), j[3]), jobs))
        libs = {}
        for (m, tag, _, _), (lib, report) in zip(jobs, built):
            libs.setdefault(m, {})[tag] = lib
            if tag == "full":
                print(f"{m} ({src}): registers {registers(report)}")
                for line in report.splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas: {line.strip()}")
        for m in CUT_MODELS:
            lat = (chip_smoke.case_lattice(chip_smoke.CHANNEL3D_XML,
                                           torch.float32, "cuda")
                   if m == dk3.MODEL else chip_smoke.channel48_lattice(
                       m, "cuda"))
            chip_smoke.eager_warm(lat, 4)
            f, flags, ztab, a = dk3.kernel_inputs(lat.model, lat.state,
                                                  lat.params)
            dev = f.device.index or 0
            stream = torch.cuda.current_stream(dev).cuda_stream
            zc = step2_zc(libs[m]["full"], tuple(f.shape[1:]), False, dev)
            args = ctypes.byref(a.c_struct(zc))
            out = torch.empty_like(f)
            ms = median_ms({tag: (lambda lib=lib: lib.d3q27_step2(
                f.data_ptr(), out.data_ptr(), flags.data_ptr(),
                ztab.data_ptr(), args, dev, stream))
                for tag, lib in libs[m].items()})
            print(f"{m} d3q27_step2 at {tuple(f.shape[1:])} (zc {zc}): "
                  + ", ".join(f"{tag} {v:.5f} ms" for tag, v in ms.items())
                  + f" (medians of {ROUNDS}x{REPS} launches)")
    print(chip_smoke.card_line())
    return 0


def main() -> int:
    cut = len(sys.argv) == 3 and sys.argv[1] == "--cut"
    if len(sys.argv) != 2 and not cut:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("d3q27_build_parity: needs a CUDA card", file=sys.stderr)
        return 2
    if cut:
        return cut_main(pathlib.Path(sys.argv[2]).resolve())
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
            timed = "3d_channel" if "3d_channel" in lats else "channel48"
            chip_smoke.eager_warm(lats[timed], 4)
            same &= compare(libs, lats, label, timed)
    print(chip_smoke.card_line())
    print("d3q27_build_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
