"""Hold this checkout's builds of ``csrc/generic3d.cu`` against another copy
of ``csrc/`` (a parent commit's, say) on one CUDA card, bit for bit, and
time both.

    python -m tclb_tpu_torch.ops.generic3d_parity OTHER/tclb_tpu_torch/csrc \
        [MODEL ...]

The 3D counterpart of ``ops/generic2d_parity.py``.  For each 3D model with
a device header in both copies (or each ``MODEL`` named), both copies are
built alike (``ops/_cuda_build.py``: nvcc for sm_90a, ``--fmad=false``,
the model's header pre-included, ``-Xptxas -v``; the other copy into a
scratch directory, one ``nvcc`` a library, started together).  The script
prints both compiler reports (registers, stack, spills and shared memory
per kernel), runs each kernel of both libraries on the same inputs (every
node type of the model's header painted, zone 1 on the upper half in z
with its own zonal values, 1% noise on the initial planes, at 9x13x37 and
32x64x128): ``generic3d_step`` in all four flavours (plain, globals, and
under a series of the first zonal setting on zone 1 the series and series
+ globals flavours) and, where the header defines ``TCLB_MODEL_ADJOINT``,
``generic3d_step_b`` on seeded cotangents, and requires every output bit
for bit the same, but the settings cotangent: within rtol 1e-4 / atol
1e-6 and the same from run to run (a kernel that sums its nodes in
another order rounds the sums differently).  It then holds each flavour
of ``generic3d_step`` of both libraries alike on the model's path lattice
(chip_smoke's: 48x48x256, d3q19_adj's bench.py case at 32x64x256) and
times it there, and ``generic3d_step_b`` at 32x64x256 and 64x128x256
(``time_steps3``, ``time_step_b3``: CUDA events over ``REPS`` calls, the
libraries alternating in ``ROUNDS`` rounds).  It exits nonzero unless
all agree.

    python -m tclb_tpu_torch.ops.generic3d_parity --cut SRC/csrc [MODEL ...]

builds ``SRC``'s ``generic3d.cu`` for each ``MODEL`` (by default
``CUT_MODELS``) in the cut-down variants ``cut_variants`` names and times
each: ``generic3d_step`` in ``CUT_FLAVOURS`` on the path lattice
(``CUTS``: every stage's loads and stores with no physics, a two-stage
plan's stage 0 or stage 1 alone, each replacing the template's call of
the header's stage), and for an adjoint header ``generic3d_step_b`` at
32x64x256 whole and in ``REVERSE_CUTS`` (its data movement alone, its
reverse stage without the settings sums, and, for a source that runs it
as a q kernel and a gather, the q kernel alone): the instrument that
shows what holds a kernel back.

A copy of ``csrc/`` whose step entries take the scratch stack ``mid`` and
whose ``generic3d_step_b`` takes the scratch ``q`` (the copies that ran a
multi-stage plan one launch a stage through ``mid`` and the reverse as a
q kernel and a gather) is bound through :class:`ScratchAbi3`.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from tclb_tpu_torch.ops import _cuda_build as cb
from tclb_tpu_torch.ops import generic3d_kernels as g3
from tclb_tpu_torch.ops import generic_kernels as gk
from tclb_tpu_torch.ops.generic2d_parity import (GLOBALS_TOL, ROUNDS,
                                                 import_chip_smoke,
                                                 median_ms)

THIS_CSRC = cb.CSRC          # this checkout's csrc/
SHAPES = ((9, 13, 37), (32, 64, 128))
STEP_B_SHAPES = ((32, 64, 256), (64, 128, 256))
REPS = 100                   # calls a round (timing)


def paint(model, shape, seed: int = 5, device: str = "cuda",
          settings=None):
    """A lattice with every node type ``model``'s header reads: the
    collision type inside, each boundary type in an x column of its own,
    each other type in a patch (set within its group's bits), walls at
    y = 0 and y = ny - 1, zone 1 on the upper half in z with each zonal
    setting at 1.5 times zone 0's (0.01 where that is 0); Init with
    ``settings``, then 1% noise on every plane."""
    from tclb_tpu_torch import Lattice
    nz, ny, nx = shape
    nt = model.node_types
    coll = "MRT" if "MRT" in nt else "BGK"
    flags = np.full(shape, model.flag_for(coll), dtype=np.uint16)
    names = [n for n in gk.DEVICE_MODELS[model.name].node_types
             if n in nt and n != coll]
    step = max(nx // (len(names) + 2), 1)
    for i, name in enumerate(names):
        x = 1 + i * step
        if nt[name].group == "BOUNDARY":
            flags[:, 1:-1, x] = model.flag_for(name, coll)
        else:
            patch = flags[1:-1, ny // 4:3 * ny // 4, x:x + 2]
            patch &= np.uint16(~nt[name].mask & 0xffff)
            patch |= np.uint16(nt[name].value)
    flags[:, 0, :] = flags[:, -1, :] = model.flag_for("Wall")
    flags[nz // 2:] |= np.uint16(1 << model.zone_shift)
    lat = Lattice(model, shape, dtype=torch.float32, device=device,
                  settings=settings or {})
    lat.set_flags(flags)
    for name in model.zonal_settings:
        v = float(lat.params.zone_table[model.setting_index[name], 0])
        lat.set_setting(name, 1.5 * v if v else 0.01, zone=1)
    lat.init()
    rng = np.random.default_rng(seed)
    f = lat.state.fields.cpu().numpy()
    lat.state.fields.copy_(torch.as_tensor(
        f * (1 + 0.01 * rng.standard_normal(f.shape)), dtype=torch.float32))
    return lat


def series_of(lat, zone: int = 1):
    """The lattice's inputs under a series (horizon 5) of its first zonal
    setting on ``zone`` (the same series on every call)."""
    m = lat.model
    name = m.zonal_settings[0]
    v = float(lat.params.zone_table[m.setting_index[name], zone])
    lat.set_setting_series(name, [v * (1 + 0.1 * k) + 0.001 * k
                                  for k in range(5)], zone=zone)
    return gk.series_inputs(m, lat.params)


def cotangents(f, n_globals: int, seed: int):
    """Seeded cotangents of a step's output planes and globals."""
    gen = torch.Generator(device=f.device).manual_seed(seed)
    lam = torch.randn(f.shape, generator=gen, device=f.device)
    lam_g = torch.randn((n_globals,), generator=gen, device=f.device)
    return lam, lam_g


def run(lat) -> tuple:
    """Every kernel of the model's library on the lattice's state:
    ``(outputs as integer bits, sums)``; the sums are
    ``generic3d_step_b``'s settings cotangent (a sum over the blocks'
    partials, whose order a change of grid changes)."""
    m = lat.model
    f, flags, ztab, a = g3.kernel_inputs(m, lat.state, lat.params)
    g = g3.step_globals(f, flags, ztab, a)
    out = {"step": g3.step(f, flags, ztab, a),
           "step_globals": torch.cat([g[0].flatten(), g[1]])}
    series = series_of(lat)
    for it in (1, 7):
        out[f"step_series it {it}"] = g3.step_series(f, flags, ztab, a,
                                                     series, it)
        gs = g3.step_series_globals(f, flags, ztab, a, series, it)
        out[f"step_series_globals it {it}"] = torch.cat([gs[0].flatten(),
                                                         gs[1]])
    sums = {}
    if gk.DEVICE_MODELS[m.name].adjoint:
        from tclb_tpu_torch.ops import adjoint_kernels as ak
        lam, lam_g = cotangents(f, m.n_globals, 11)
        out["step_b"], sums["step_b settings"] = ak.step_b(
            f, flags, ztab, a, lam, lam_g)
    if f.is_cuda:
        torch.cuda.synchronize()
    bits = {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in out.items()}
    return bits, sums


# --------------------------------------------------------------------------- #
# Binding another copy's library
# --------------------------------------------------------------------------- #


def scratch_abi(csrc: pathlib.Path) -> bool:
    """Whether the copy ``csrc`` takes the scratch stacks: ``mid`` in its
    step entries, ``q`` in its ``generic3d_step_b``."""
    return re.search(r"int generic3d_step\(const float\* fin, "
                     r"float\* fout, float\* mid",
                     (csrc / "generic3d.cu").read_text()) is not None


class ScratchAbi3:
    """A library whose step entries take an f32 scratch stack ``mid``
    after ``fout`` and whose ``generic3d_step_b`` takes a scratch ``q``
    after ``lam_in`` and sums over a 32x8 block a z-plane (its partials one
    per block).  The wrapper's calls are passed on with those scratch
    stacks and partials of that library's size; every other entry is the
    library's own."""

    def __init__(self, lib: ctypes.CDLL, model: str):
        self._lib = lib
        dm = gk.DEVICE_MODELS[model]
        self._planes = len(dm.storage)
        self._n_g, self._n_s = max(len(dm.globals_), 1), len(dm.settings)
        p, i = ctypes.c_void_p, ctypes.c_int
        argp = ctypes.POINTER(gk.c_args_type(model))
        lib.generic3d_step.argtypes = [p, p, p, p, p, argp, p, p, i, p]
        lib.generic3d_step_series.argtypes = [p, p, p, p, p, argp, p, p, i,
                                              i, p, p, i, p]
        if dm.adjoint:
            lib.generic3d_step_b.argtypes = [p, p, p, p, argp, p, p, p, p,
                                             p, i, p]
            lib.generic3d_step_b.restype = i
        self._scratch = {}

    def _buffers(self, a, device: int) -> tuple:
        """The scratch stack and the forward's and reverse's partials for
        the lattice of the arguments ``a`` on ``device``."""
        key = (a.nz, a.ny, a.nx, device)
        if key not in self._scratch:
            blocks = a.nz * -(-a.ny // 8) * -(-a.nx // 32)
            dev = torch.device("cuda", device)
            self._scratch[key] = (
                torch.empty((self._planes, a.nz, a.ny, a.nx),
                            dtype=torch.float32, device=dev),
                torch.empty((blocks + 1, self._n_g), dtype=torch.float64,
                            device=dev),
                torch.empty((blocks, self._n_s), dtype=torch.float64,
                            device=dev))
        return self._scratch[key]

    def __getattr__(self, name):
        if name == "generic3d_step_b_tile":
            def tile(tile_z, tile_y, tile_x):
                # a 32x8 block a z-plane
                tile_z._obj.value, tile_y._obj.value = 1, 8
                tile_x._obj.value = 32
            return tile
        fn = getattr(self._lib, name)
        if name in ("generic3d_step", "generic3d_step_series"):
            def step(fin, fout, flags, ztab, args, *rest):
                # rest: [series,] partials, gout, device, stream
                mid, partials, _ = self._buffers(args._obj, rest[-2])
                rest = list(rest)
                if rest[-4] is not None:
                    rest[-4] = partials.data_ptr()
                return fn(fin, fout, mid.data_ptr(), flags, ztab, args,
                          *rest)
            return step
        if name == "generic3d_step_b":
            def step_b(fin, lam_out, flags, ztab, args, lam_g, lam_in,
                       partials, sett, device, stream):
                q, _, part = self._buffers(args._obj, device)
                return fn(fin, lam_out, flags, ztab, args, lam_g, lam_in,
                          q.data_ptr(), part.data_ptr(), sett, device,
                          stream)
            return step_b
        return fn


def _entry(model: str, path: pathlib.Path, scratch: bool) -> dict:
    """``g3._LIB[model]`` for the library at ``path``, bound as ``g3.lib``
    binds it (through :class:`ScratchAbi3` where ``scratch``)."""
    raw = ctypes.CDLL(str(path))
    return g3.bind(ScratchAbi3(raw, model) if scratch else raw, model,
                   path.name)


def load(csrc: pathlib.Path, build_dir: pathlib.Path, models) -> dict:
    """Each model's library entry (``g3._LIB[model]``) built from ``csrc``
    (one ``nvcc`` a model, started together), and print its compiler
    report."""
    cb.CSRC, cb.BUILD_DIR = csrc, build_dir
    scratch = scratch_abi(csrc) != scratch_abi(THIS_CSRC)
    with concurrent.futures.ThreadPoolExecutor(len(models)) as pool:
        built = list(pool.map(gk.build, models))
    out = {}
    for m, (path, report) in zip(models, built):
        out[m] = _entry(m, path, scratch)
        print(f"{m} ({path.name} from {csrc}):")
        for line in ptxas_lines3(report):
            print(f"  ptxas: {line}")
    return out


_ENTRY = re.compile(r"Compiling entry function '_Z\d+(\w+?)(I.*|P\w*)?' "
                    r"for")
_ARGS = re.compile(r"^ILi(\d+)ELb([01])ELb([01])E")


def ptxas_lines3(report: str) -> list:
    """The compiler report's registers, stack, spills and shared memory,
    one line a kernel, named by its template and its instance
    (``generic3d_pass_kernel stage 1 globals``) or its name."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        hit = _ENTRY.search(line)
        if hit:
            name, args = hit.group(1), hit.group(2) or ""
            inst = _ARGS.match(args)
            if inst:
                name += f" stage {inst.group(1)}" + (
                    " globals" if inst.group(2) == "1" else "") + (
                    " series" if inst.group(3) == "1" else "")
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


# --------------------------------------------------------------------------- #
# Timing at the paths' shapes
# --------------------------------------------------------------------------- #


def path_lattice(model: str):
    """The lattice a model's ``generic3d_step`` runs on in chip_smoke's
    phase 7: bench.py's 3D adjoint case at 32x64x256 for d3q19_adj, the
    48x48x256 lattice of phase 45 for the others (initialised)."""
    cs = import_chip_smoke()
    if model == "d3q19_adj":
        return cs.bench3d_lattice("cuda")
    return cs.generic3d_lattice(model)


def time_steps3(lat, libs: dict, flavours=None, compare: bool = False
                ) -> tuple:
    """``generic3d_step`` of each library (``libs``: tag -> its
    ``g3._LIB`` entry) in each flavour (or those named in ``flavours``)
    on ``lat``'s state, the series flavours under a series of the first
    zonal setting on zone 0: the median ms a call, the libraries
    alternating.  With ``compare``, each flavour's output of every
    library is first held against the first library's bit for bit.
    Returns the times and whether all agreed."""
    m = lat.model.name
    f, flags, ztab, a = g3.kernel_inputs(lat.model, lat.state, lat.params)
    series = series_of(lat, zone=0)
    calls = {"plain": lambda: g3.step(f, flags, ztab, a),
             "globals": lambda: g3.step_globals(f, flags, ztab, a),
             "series": lambda: g3.step_series(f, flags, ztab, a, series, 3),
             "series globals": lambda: g3.step_series_globals(
                 f, flags, ztab, a, series, 3)}
    if flavours is not None:
        calls = {k: v for k, v in calls.items() if k in flavours}
    out, same = {}, True
    for flavour, call in calls.items():

        def launch(entry, call=call):
            g3._LIB[m] = entry
            return call()
        if compare:
            # fields and globals as one stack of bits (a flavour's
            # outputs, concatenated outside the timed calls)
            got = {tag: torch.cat([t.flatten() for t in (
                (r,) if torch.is_tensor(r) else r)])
                for tag, r in ((tag, launch(e)) for tag, e in libs.items())}
            (tag0, ref), *rest = got.items()
            for tag, res in rest:
                equal = torch.equal(res.view(torch.int32),
                                    ref.view(torch.int32))
                print(f"{m} generic3d_step {flavour} at {lat.shape}: {tag} "
                      f"{'bit-identical' if equal else 'DIFFERS'} to {tag0}")
                same &= equal
        ms = median_ms({tag: (lambda e=e: launch(e))
                        for tag, e in libs.items()}, REPS, ROUNDS)
        out[flavour] = ms
        print(f"{m} generic3d_step {flavour} at {lat.shape}: " + ", ".join(
            f"{tag} {v:.5f} ms" for tag, v in ms.items())
            + " (a call: " + " / ".join(str(e["passes"])
                                        for e in libs.values())
            + f" launches; medians of {ROUNDS}x{REPS} calls)")
    return out, same


def time_step_b3(lat, libs: dict, compare: bool = False) -> tuple:
    """``generic3d_step_b`` of each library (``libs``: tag -> its
    ``g3._LIB`` entry) on ``lat``'s state with seeded cotangents: the
    median ms a call, the libraries alternating.  With ``compare``, each
    library's ``lam_in`` is first held against the first library's bit
    for bit and its settings cotangent within ``GLOBALS_TOL`` and the
    same from run to run.  Returns the times and whether all agreed."""
    from tclb_tpu_torch.ops import adjoint_kernels as ak
    m = lat.model.name
    f, flags, ztab, a = g3.kernel_inputs(lat.model, lat.state, lat.params)
    lam, lam_g = cotangents(f, lat.model.n_globals, 12)

    def launch(entry):
        g3._LIB[m] = entry
        return ak.step_b(f, flags, ztab, a, lam, lam_g)
    same = True
    if compare:
        got = {tag: launch(e) for tag, e in libs.items()}
        (tag0, (lam0, sett0)), *rest = got.items()
        for tag, (lam_in, sett) in rest:
            equal = torch.equal(lam_in.view(torch.int32),
                                lam0.view(torch.int32))
            close = torch.allclose(sett, sett0, equal_nan=True,
                                   **GLOBALS_TOL)
            again = launch(libs[tag])[1]
            rerun = torch.equal(sett.view(torch.int64),
                                again.view(torch.int64))
            diff = float((sett - sett0).abs().max())
            print(f"{m} generic3d_step_b at {lat.shape}: {tag} lam_in "
                  f"{'bit-identical' if equal else 'DIFFERS'} to {tag0}, "
                  f"settings {'within' if close else 'OUTSIDE'} rtol 1e-4"
                  f" / atol 1e-6 (max abs diff {diff:.3e} of "
                  f"{float(sett0.abs().max()):.3e}), "
                  f"{'the same' if rerun else 'NOT the same'} run to run")
            same &= equal and close and rerun
    ms = median_ms({tag: (lambda e=e: launch(e)) for tag, e in libs.items()},
                   REPS, ROUNDS)
    print(f"{m} generic3d_step_b at {lat.shape}: " + ", ".join(
        f"{tag} {v:.5f} ms" for tag, v in ms.items())
        + f" (medians of {ROUNDS}x{REPS} calls)")
    return ms, same


def step_b_lattice(shape):
    """bench.py's 3D adjoint case at ``shape`` (chip_smoke's
    ``bench3d_lattice``: the gradient paths' lattice)."""
    return import_chip_smoke().bench3d_lattice("cuda", shape)


# --------------------------------------------------------------------------- #
# --cut: the cut-down variants
# --------------------------------------------------------------------------- #

# Each forward variant replaces the template's one call of the header's
# stage (CUT_HOOK, whose template argument it keeps): "loads and stores"
# stores what each stage writes from its pulled neighbour (the form's data
# movement with no physics), "stage 0 alone" replaces stage 1 by a copy of
# the node's own planes, "stage 1 alone" stage 0.
CUT_HOOK = re.compile(r"model::stage<(\w+)>\(c\);")
_COPY = ("{{\n#pragma unroll\n"
         "  for (int k_ = 0; k_ < model::N_STORAGE; ++k_)\n"
         "    if (writes({S}, k_)) c.store(k_, c.{get});\n}}\n")
CUTS = {
    "loads and stores": _COPY.format(S="{S}", get="pulled(k_)"),
    "stage 0 alone": ("if constexpr ({S} == 0) model::stage<{S}>(c);\n"
                      "else " + _COPY.format(S="{S}",
                                             get="load(k_, 0, 0, 0)")),
    "stage 1 alone": ("if constexpr ({S} == 0) "
                      + _COPY.format(S="{S}", get="load(k_, 0, 0, 0)")
                      + "else model::stage<{S}>(c);\n"),
}
# The reverse variants (generic3d_adjoint.cuh): "reverse loads and stores"
# replaces the call of stage_b<0> (B_STAGE_HOOK) by q = the pulled primal
# plus the node's lam_out, each plane (the data movement with no reverse
# physics), "reverse without settings sums" keeps stage_b<0>; both drop the
# settings sums (add_setting's accumulation, B_SUM_HOOK, and the block
# reduction, B_FINISH).  "q kernel alone" drops the gather's launch
# (B_GATHER) of a source that runs the reverse as a q kernel and a gather,
# and keeps the sums.
B_STAGE_HOOK = "model::stage_b<0>(c);"
B_SUM_HOOK = re.compile(r"sacc\[i[^\]]*\] \+= \(double\)v;")
B_FINISH = re.compile(r"finish_sums<.*?\}\);", re.DOTALL)
B_GATHER = re.compile(r"generic3d_step_b_gather_kernel<<<.*?\);", re.DOTALL)
B_COPY = ("for (int k_ = 0; k_ < model::N_STORAGE; ++k_) "
          "c.set_q(k_, c.pulled(k_) + c.lam(k_));")
REVERSE_CUTS = ("reverse loads and stores", "reverse without settings sums",
                "q kernel alone")
CUT_MODELS = ("d3q19_kuper", "d3q19_adj")
CUT_FLAVOURS = ("plain", "globals")


def cut_variants(model: str, csrc: pathlib.Path = None) -> list:
    """The variants ``--cut`` builds for ``model`` from the copy ``csrc``
    (by default this checkout's): ``"full"``, those of ``CUTS`` that apply
    to its plan and, for an adjoint header, ``REVERSE_CUTS`` (the q
    kernel alone only where the source has a gather kernel)."""
    csrc = THIS_CSRC if csrc is None else csrc
    dm = gk.DEVICE_MODELS[model]
    out = ["full", "loads and stores"]
    if len(dm.plan) == 2:
        out += ["stage 0 alone", "stage 1 alone"]
    if dm.adjoint:
        text = (csrc / "generic3d_adjoint.cuh").read_text()
        out += [v for v in REVERSE_CUTS
                if v != "q kernel alone" or B_GATHER.search(text)]
    return out


def _cut_reverse(path: pathlib.Path, variant: str) -> None:
    """Cut the reverse variant ``variant`` into the reverse kernel's
    source at ``path``."""
    text = path.read_text()
    if variant == "q kernel alone":
        if len(B_GATHER.findall(text)) != 1:
            raise SystemExit("--cut: generic3d_adjoint.cuh has no launch of "
                             "a gather kernel to drop")
        path.write_text(B_GATHER.sub("", text))
        return
    if (text.count(B_STAGE_HOOK) != 1 or len(B_SUM_HOOK.findall(text)) != 1
            or len(B_FINISH.findall(text)) != 1):
        raise SystemExit("--cut: generic3d_adjoint.cuh has not the one "
                         "call of stage_b<0>, settings sum and finish_sums "
                         "it cuts")
    text = B_FINISH.sub("", B_SUM_HOOK.sub("", text))
    if variant == "reverse loads and stores":
        text = text.replace(B_STAGE_HOOK, B_COPY)
    path.write_text(text)


def cut_csrc(src: pathlib.Path, dst: pathlib.Path, model: str,
             variant: str) -> None:
    """A copy of the ``csrc/`` directory ``src`` at ``dst`` with
    ``variant`` cut into it."""
    shutil.copytree(src, dst)
    if variant == "full":
        return
    if variant in REVERSE_CUTS:
        _cut_reverse(dst / "generic3d_adjoint.cuh", variant)
        return
    path = dst / "generic3d.cu"
    text = path.read_text()
    hits = CUT_HOOK.findall(text)
    if len(hits) != 1:
        raise SystemExit("--cut: generic3d.cu has not the one call of the "
                         "header's stage it cuts")
    path.write_text(CUT_HOOK.sub(
        lambda h: CUTS[variant].replace("{S}", h.group(1)), text))


def build_cut(csrc: pathlib.Path, model: str) -> tuple:
    """Compile ``csrc/generic3d.cu`` with ``model``'s header as the port
    builds it, into ``csrc``: the library's path and the report."""
    out = csrc / f"libcut_{model}.so"
    flags = cb._flags("generic3d", str(csrc / gk.DEVICE_MODELS[model].header))
    proc = subprocess.run([cb.nvcc(), *flags, "-o", str(out),
                           str(csrc / "generic3d.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {csrc}:\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def cut_main(src: pathlib.Path, models) -> int:
    """Time ``generic3d_step`` of ``src``'s builds of ``models`` in the
    forward variants (flavours ``CUT_FLAVOURS``, on the path lattice) and,
    for an adjoint header, ``generic3d_step_b`` in ``"full"`` and the
    reverse variants at 32x64x256."""
    scratch = scratch_abi(src) != scratch_abi(THIS_CSRC)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(m, v, pathlib.Path(tmp) / f"{m}_{i}")
                for m in models for i, v in enumerate(cut_variants(m, src))]
        for m, v, dst in jobs:
            cut_csrc(src, dst, m, v)
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda j: build_cut(j[2], j[0]), jobs))
        libs = {}
        try:
            for (m, v, _), (path, report) in zip(jobs, built):
                libs.setdefault(m, {})[v] = _entry(m, path, scratch)
                print(f"{m} {v} ({src}):")
                for line in ptxas_lines3(report):
                    print(f"  ptxas: {line}")
            for m in models:
                forward = {v: e for v, e in libs[m].items()
                           if v not in REVERSE_CUTS}
                time_steps3(path_lattice(m), forward, CUT_FLAVOURS)
                if gk.DEVICE_MODELS[m].adjoint:
                    time_step_b3(step_b_lattice(STEP_B_SHAPES[0]), {
                        v: e for v, e in libs[m].items()
                        if v == "full" or v in REVERSE_CUTS})
        finally:
            g3._LIB.clear()
    print(import_chip_smoke().card_line())
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] == "--cut" and len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("generic3d_parity: needs a CUDA card", file=sys.stderr)
        return 2
    if argv[0] == "--cut":
        return cut_main(pathlib.Path(argv[1]).resolve(),
                        list(argv[2:]) or list(CUT_MODELS))
    from tclb_tpu_torch.models import get_model
    other = pathlib.Path(argv[0]).resolve()
    models = [m for m, dm in gk.DEVICE_MODELS.items()
              if dm.ndim == 3 and (other / dm.header).is_file()
              and (m in argv[1:] or len(argv) == 1)]
    this_build = cb.BUILD_DIR
    same = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            libs = {"this": load(THIS_CSRC, this_build, models),
                    "other": load(other, pathlib.Path(tmp), models)}
            cb.CSRC = THIS_CSRC
            for m in models:
                for shape in SHAPES:
                    lat = paint(get_model(m), shape)
                    outs = {}
                    for tag, entries in libs.items():
                        g3._LIB[m] = entries[m]
                        outs[tag] = run(lat)
                    for name, got in outs["this"][0].items():
                        equal = torch.equal(got, outs["other"][0][name])
                        print(f"{m} {name} {shape}: "
                              f"{'bit-identical' if equal else 'DIFFERS'}")
                        same &= equal
                    g3._LIB[m] = libs["this"][m]
                    again = run(lat)[1]
                    for name, got in outs["this"][1].items():
                        want = outs["other"][1][name]
                        close = torch.allclose(got, want, equal_nan=True,
                                               **GLOBALS_TOL)
                        rerun = torch.equal(got.view(torch.int64),
                                            again[name].view(torch.int64))
                        print(f"{m} {name} {shape}: max abs diff "
                              f"{float((got - want).abs().max()):.3e} of "
                              f"{float(want.abs().max()):.3e}, "
                              f"{'within' if close else 'OUTSIDE'} rtol "
                              f"1e-4 / atol 1e-6, "
                              f"{'the same' if rerun else 'NOT the same'}"
                              " run to run")
                        same &= close and rerun
                pair = {tag: entries[m] for tag, entries in libs.items()}
                same &= time_steps3(path_lattice(m), pair, compare=True)[1]
                if gk.DEVICE_MODELS[m].adjoint:
                    for shape in STEP_B_SHAPES:
                        same &= time_step_b3(step_b_lattice(shape), pair,
                                             compare=True)[1]
    finally:
        g3._LIB.clear()
        cb.BUILD_DIR = this_build
    print(import_chip_smoke().card_line())
    print("generic3d_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
