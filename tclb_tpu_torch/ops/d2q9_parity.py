"""Hold this checkout's builds of ``csrc/d2q9.cu`` against another copy of
``csrc/`` (a parent commit's, say) on one CUDA card.

    python -m tclb_tpu_torch.ops.d2q9_parity OTHER/tclb_tpu_torch/csrc \
        [MODEL ...]

For d2q9 and each of the five family models (``MODELS``, or each
``MODEL`` named), both copies of ``d2q9.cu`` are built as the port builds
them (``ops/_cuda_build.py``'s flags for sm_90a with ``-Xptxas -v``; a
family model with ``-DD2Q9_MODEL=<id> --fmad=false``), one ``nvcc`` a
library, all started together.  The script prints both compiler reports
(registers, spills and shared memory per kernel), runs ``d2q9_step``,
``d2q9_step2`` and ``d2q9_resident8`` of both libraries on the same
inputs (a state that paints every node type the model reads, two zones
and gravity, at ``SMALL`` and at 1024x1024, and bench.py's 1024x1024
channel of the model, chip_smoke's ``d2q9_step2`` lattice) and exits
nonzero on a difference: a family build must be bit for bit the same;
d2q9's own build (multiply-add contraction on) is reported bit for bit
or else by its count of differing values, and must then agree within the
forward tolerance (``FORWARD_TOL``).  It then times ``d2q9_step2`` of
both on the channel (``generic2d_parity.median_ms``: CUDA events over
100 calls, the libraries alternating in 4 rounds), and holds and times
``d2q9_resident8`` of both on the model's resident path state
(``resident_lattice``), beside four ``d2q9_step2`` calls; last, karman.xml's
``iterate(1000)`` window split with each library (``split_karman``).

    python -m tclb_tpu_torch.ops.d2q9_parity --cut SRC/csrc [MODEL ...]

builds ``SRC``'s ``d2q9.cu`` for each model in the cut-down variants of
``d2q9_step2`` that ``CUTS`` names and times each on the channel, the
variants of a model alternating in rounds: the instrument that shows
what holds the kernel back.

    python -m tclb_tpu_torch.ops.d2q9_parity --cut --resident SRC/csrc \
        [MODEL ...]

does the same for ``d2q9_resident8`` in the variants ``RESIDENT_CUTS``
(whole; the grid barriers alone; no barrier, its output wrong; loads and
stores alone), each timed at the model's resident path lattice
(``RESIDENT_PATHS``) beside four ``d2q9_step2`` calls of the whole build
on the same state (the eight steps a band engine would take).  A variant
whose code a source lacks (a design without grid barriers) is skipped
with a note.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

from tclb_tpu_torch.ops import _cuda_build as cb
from tclb_tpu_torch.ops import d2q9_kernels as dk
from tclb_tpu_torch.ops import generic2d_parity as gp

MODELS = ("d2q9",) + dk.FAMILY
SMALL = (37, 53)          # a ragged edge on every tile shape
TIMED = (1024, 1024)      # the band engine's lattice in chip_smoke
FORWARD_TOL = {"rtol": 2e-5, "atol": 2e-6}
KERNELS = ("d2q9_step", "d2q9_step2", "d2q9_resident8")

# --cut: each variant drops node updates of d2q9_step2_kernel (a call of
# node_update there is replaced by nothing, so the pulled populations pass
# through): "loads and stores" drops every one (the kernel's data movement
# alone), "step 1 alone" those of step 2.  The kernel's calls of step 1
# come before those of step 2, as many of each.
CUTS = ("full", "loads and stores", "step 1 alone")
_CALL = re.compile(r"node_update\(a, f, ")
# each model's resident path lattice (ny, nx): karman.xml, the SRT
# Poiseuille, les_channel.xml, bench.py's 128x1024 channel (d2q9_inc,
# d2q9_new) and cumulant2d.xml
RESIDENT_PATHS = {"d2q9": (100, 1024), "d2q9_SRT": (21, 40),
                  "d2q9_les": (96, 512), "d2q9_inc": (128, 1024),
                  "d2q9_cumulant": (128, 1024), "d2q9_new": (128, 1024)}
# --cut --resident: the variants of d2q9_resident8 as edits of the source
# (pattern, replacement) inside the resident kernel and step_node:
# "barriers alone" runs no node loop (the grid stride's loops end at
# once), "no barrier" drops every grid.sync(), "loads and stores" drops
# every node update (the pulled populations pass through)
RESIDENT_CUTS = {
    "whole": (),
    "barriers alone": ((re.compile(r"idx < n; idx \+= stride"),
                        "idx < 0; idx += stride"),),
    "no barrier": ((re.compile(r"grid\.sync\(\);"), "(void)0;"),),
    "loads and stores": ((_CALL, None),),
}
RESIDENT_SPANS = ("d2q9_resident8_kernel(", "step_node(")


def parse_args(argv) -> tuple:
    """``(cut, csrc, models)`` from the command line, or raise
    ``SystemExit(2)`` with the usage; ``cut`` is False, ``"step2"`` or
    ``"resident"``; ``models`` defaults to ``MODELS`` and every name must
    be one of them."""
    rest = list(argv)
    cut = False
    if rest[:2] == ["--cut", "--resident"]:
        cut, rest = "resident", rest[2:]
    elif rest[:1] == ["--cut"]:
        cut, rest = "step2", rest[1:]
    if not rest:
        print(__doc__, file=sys.stderr)
        raise SystemExit(2)
    models = rest[1:] or list(MODELS)
    unknown = [m for m in models if m not in MODELS]
    if unknown:
        print(f"d2q9_parity: not a d2q9 build: {unknown} (one of "
              f"{list(MODELS)})", file=sys.stderr)
        raise SystemExit(2)
    return cut, pathlib.Path(rest[0]).resolve(), models


def kernel_bodies(text: str) -> list:
    """The ``(start, end)`` of each definition of ``d2q9_step2_kernel`` in
    ``text`` (a d2q9.cu; a build compiles one of them)."""
    out, at = [], text.find("d2q9_step2_kernel(")
    while at >= 0:
        end = text.index("\n}\n", at)
        out.append((at, end))
        at = text.find("d2q9_step2_kernel(", end)
    return out


def cut_source(text: str, variant: str) -> str:
    """``text`` (a d2q9.cu) with ``variant`` cut into each definition of
    ``d2q9_step2_kernel``."""
    bodies = kernel_bodies(text)
    if not bodies:
        raise SystemExit("--cut: d2q9.cu defines no d2q9_step2_kernel")
    for start, end in reversed(bodies):
        body = text[start:end]
        calls = [m.start() for m in _CALL.finditer(body)]
        if not calls or len(calls) % 2:
            raise SystemExit("--cut: d2q9_step2_kernel has not the "
                             "node_update calls of its two steps it cuts")
        drop = {"full": [], "loads and stores": calls,
                "step 1 alone": calls[len(calls) // 2:]}[variant]
        for at in sorted(drop, reverse=True):
            stop = body.index(");", at) + 1
            body = body[:at] + "(void)0" + body[stop:]
        text = text[:start] + body + text[end:]
    return text


def cut_resident(text: str, variant: str):
    """``text`` (a d2q9.cu) with the resident variant ``variant`` cut into
    the resident kernel and ``step_node``, or None where the source has
    none of the code that variant removes."""
    hit = False
    for start, end in sorted(gp._spans(text, RESIDENT_SPANS), reverse=True):
        body = text[start:end]
        for pattern, repl in RESIDENT_CUTS[variant]:
            if repl is not None:
                body, n = pattern.subn(repl, body)
                hit |= n > 0
                continue
            for m in sorted(pattern.finditer(body), key=lambda m: -m.start()):
                stop = body.index(");", m.start()) + 1
                body = body[:m.start()] + "(void)0" + body[stop:]
                hit = True
        text = text[:start] + body + text[end:]
    return text if hit or not RESIDENT_CUTS[variant] else None


def flags_of(model: str) -> tuple:
    """The compiler flags the port builds ``model``'s library with."""
    extra = () if model == "d2q9" else (
        f"-DD2Q9_MODEL={dk.MODEL_ID[model]}",) + dk.FAMILY_FLAGS
    return cb._flags("d2q9", None, extra)


def build(src: pathlib.Path, out: pathlib.Path, model: str) -> tuple:
    """Compile the d2q9.cu at ``src`` for ``model`` into ``out``; bind it.
    Returns the library and the compiler's report."""
    proc = subprocess.run([cb.nvcc(), *flags_of(model), "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
    return dk.bind(ctypes.CDLL(str(out)), model), proc.stdout + proc.stderr


def build_all(jobs) -> list:
    """``build`` for each ``(src, out, model)`` of ``jobs``, all at once."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(lambda j: build(*j), jobs))


def rich_lattice(model: str, shape):
    """A state of ``model`` at ``shape`` on the card that paints every node
    type the model reads, two zones and gravity (tests/torch_cases.py)."""
    gp.import_chip_smoke()
    from torch_cases import (RICH_SETTINGS, family_settings, paint_rich,
                             paint_rich_family)
    from tclb_tpu_torch import Lattice, get_model
    m = get_model(model)
    if model == "d2q9":
        return paint_rich(Lattice(m, shape, dtype=torch.float32,
                                  device="cuda", settings=RICH_SETTINGS), 5)
    return paint_rich_family(Lattice(m, shape, dtype=torch.float32,
                                     device="cuda",
                                     settings=family_settings(m)), 5)


def resident_lattice(model: str):
    """``model``'s resident path state at its lattice (``RESIDENT_PATHS``):
    karman.xml's state after 200 eager steps for d2q9, a painted state
    (``rich_lattice``) for a family model."""
    if model != "d2q9":
        return rich_lattice(model, RESIDENT_PATHS[model])
    cs = gp.import_chip_smoke()
    lat = cs.case_lattice(cs.KARMAN_XML, torch.float32, "cuda")
    cs.eager_warm(lat, 200)
    return lat


def channel_lattice(model: str):
    """bench.py's 1024x1024 channel of ``model``, as chip_smoke times
    ``d2q9_step2`` on it."""
    cs = gp.import_chip_smoke()
    if model == "d2q9":
        return cs.channel_lattice("cuda", TIMED[0])
    return cs.family_channel_lattice(model, "cuda", TIMED)


def _use(model: str, lib) -> None:
    """Route the wrappers of ``model`` to ``lib``."""
    dk._LIB[model] = lib
    for key in [k for k in dk._LIB if isinstance(k, tuple)]:
        del dk._LIB[key]      # the resident grid is the library's


def compare(model: str, libs: dict, lat, what: str) -> bool:
    """Each kernel of both libraries on ``lat``'s state: bit for bit for a
    family build, d2q9's within ``FORWARD_TOL`` with its differing values
    counted."""
    f, flags, vel, den, a = dk.kernel_inputs(lat.model, lat.state,
                                             lat.params)
    same = True
    for name in KERNELS:
        wrapper = dk.WRAPPERS[name][0]
        outs = []
        for lib in libs.values():
            _use(model, lib)
            outs.append(wrapper(f, flags, vel, den, a))
        torch.cuda.synchronize()
        this, other = outs
        differ = int((this.view(torch.int32) != other.view(torch.int32))
                     .sum())
        diff = float((this - other).abs().max())
        if differ == 0:
            verdict = "bit-identical"
        elif model == "d2q9" and torch.allclose(this, other, **FORWARD_TOL):
            verdict = (f"{differ} of {this.numel()} values differ, within "
                       "rtol 2e-5 / atol 2e-6")
        else:
            verdict = f"DIFFERS in {differ} of {this.numel()} values"
            same = False
        print(f"{model} {name} on {what} {tuple(lat.shape)}: {verdict} "
              f"(max abs diff {diff:.3e})")
    return same


def time_step2(model: str, libs: dict, lat) -> dict:
    """``d2q9_step2`` of each library (``libs``: tag -> library) on
    ``lat``'s state: the median ms a call, the libraries alternating."""
    f, flags, vel, den, a = dk.kernel_inputs(lat.model, lat.state,
                                             lat.params)

    def launch(lib):
        _use(model, lib)
        return dk.step2(f, flags, vel, den, a)
    ms = gp.median_ms({tag: (lambda lib=lib: launch(lib))
                       for tag, lib in libs.items()})
    print(f"{model} d2q9_step2 at {tuple(lat.shape)}: " + ", ".join(
        f"{tag} {v:.5f} ms" for tag, v in ms.items())
        + f" (medians of {gp.ROUNDS}x{gp.REPS} calls)")
    return ms


def time_resident(model: str, libs: dict, lat) -> dict:
    """``d2q9_resident8`` of each library (``libs``: tag -> library) on
    ``lat``'s state beside four ``d2q9_step2`` calls of the first: the
    median ms a call (eight steps), the libraries alternating."""
    f, flags, vel, den, a = dk.kernel_inputs(lat.model, lat.state,
                                             lat.params)

    def launch(lib, fn):
        _use(model, lib)
        return fn(f, flags, vel, den, a)
    calls = {tag: (lambda lib=lib: launch(lib, dk.resident8))
             for tag, lib in libs.items()}
    first = next(iter(libs.values()))

    def four():
        _use(model, first)
        g = f
        for _ in range(dk.RESIDENT_FUSE // 2):
            g = dk.step2(g, flags, vel, den, a)
        return g
    calls["d2q9_step2 x4"] = four
    ms = gp.median_ms(calls)
    print(f"{model} d2q9_resident8 at {tuple(lat.shape)}: " + ", ".join(
        f"{tag} {v:.5f} ms ({v / dk.RESIDENT_FUSE * 1e3:.2f} us a step)"
        for tag, v in ms.items())
        + f" (medians of {gp.ROUNDS}x{gp.REPS} calls)")
    return ms


def split_karman(libs: dict) -> dict:
    """karman.xml's window split (chip_smoke's ``window_split``: an
    ``iterate(1000)`` on its state, K2's device time and its wrapper's host
    time a launch, the eager globals step, the idle share) with each
    library (``libs``: tag -> d2q9's library) in turn."""
    cs = gp.import_chip_smoke()
    lat = resident_lattice("d2q9")
    out = {}
    for tag, lib in libs.items():
        _use("d2q9", lib)
        inputs = dk.kernel_inputs(lat.model, lat.state, lat.params)
        out[tag] = cs.window_split(
            lat, 1000, f"a karman iterate(1000), {tag}", "d2q9_resident8",
            lambda: dk.LAUNCHES["d2q9_resident8"],
            lambda: dk.resident8(*inputs))
    return out


def cut_resident_main(src: pathlib.Path, models) -> int:
    """Time ``d2q9_resident8`` of ``src``'s builds of ``models`` in the
    variants ``RESIDENT_CUTS`` at each model's resident path lattice."""
    text = (src / "d2q9.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        jobs, names = [], []
        for m in models:
            for i, variant in enumerate(RESIDENT_CUTS):
                cut = cut_resident(text, variant)
                if cut is None:
                    print(f"{m} {variant}: not in {src}'s d2q9_resident8, "
                          "skipped")
                    continue
                path = pathlib.Path(tmp) / f"res_{m}_{i}.cu"
                path.write_text(cut)
                jobs.append((path, path.with_suffix(".so"), m))
                names.append(variant)
        libs = {}
        for (_, _, m), variant, (lib, report) in zip(jobs, names,
                                                      build_all(jobs)):
            libs.setdefault(m, {})[variant] = lib
            print(f"{m} {variant} ({src}):")
            for line in gp.ptxas_lines(report):
                print(f"  ptxas: {line}")
        try:
            for m in models:
                time_resident(m, libs[m], rich_lattice(m, RESIDENT_PATHS[m]))
        finally:
            dk._LIB.clear()
    print(gp.import_chip_smoke().card_line())
    return 0


def cut_main(src: pathlib.Path, models) -> int:
    """Time ``d2q9_step2`` of ``src``'s builds of ``models`` in the
    variants ``CUTS``."""
    text = (src / "d2q9.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for m in models:
            for i, variant in enumerate(CUTS):
                path = pathlib.Path(tmp) / f"cut_{m}_{i}.cu"
                path.write_text(cut_source(text, variant))
                jobs.append((path, path.with_suffix(".so"), m))
        built = build_all(jobs)
        libs = {}
        for (_, _, m), variant, (lib, report) in zip(
                jobs, [v for _ in models for v in CUTS], built):
            libs.setdefault(m, {})[variant] = lib
            print(f"{m} {variant} ({src}):")
            for line in gp.ptxas_lines(report):
                print(f"  ptxas: {line}")
        try:
            for m in models:
                time_step2(m, libs[m], channel_lattice(m))
        finally:
            dk._LIB.clear()
    print(gp.import_chip_smoke().card_line())
    return 0


def main(argv=None) -> int:
    cut, csrc, models = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("d2q9_parity: needs a CUDA card", file=sys.stderr)
        return 2
    if cut == "resident":
        return cut_resident_main(csrc, models)
    if cut:
        return cut_main(csrc, models)
    srcs = {"this": cb.CSRC / "d2q9.cu", "other": csrc / "d2q9.cu"}
    same = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            jobs = [(src, pathlib.Path(tmp) / f"lib_{m}_{tag}.so", m)
                    for m in models for tag, src in srcs.items()]
            built = iter(build_all(jobs))
            libs = {}
            for m in models:
                for tag, src in srcs.items():
                    lib, report = next(built)
                    libs.setdefault(m, {})[tag] = lib
                    print(f"{m} {tag} ({src}):")
                    for line in gp.ptxas_lines(report):
                        print(f"  ptxas: {line}")
            for m in models:
                for what, lat in (
                        ("a painted state", rich_lattice(m, SMALL)),
                        ("a painted state", rich_lattice(m, TIMED)),
                        ("the channel", channel_lattice(m))):
                    same &= compare(m, libs[m], lat, what)
                time_step2(m, libs[m], lat)
                lat = resident_lattice(m)
                same &= compare(m, libs[m], lat, "its resident path")
                time_resident(m, libs[m], lat)
            if "d2q9" in models:
                split_karman(libs["d2q9"])
    finally:
        dk._LIB.clear()
    print(gp.import_chip_smoke().card_line())
    print("d2q9_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
