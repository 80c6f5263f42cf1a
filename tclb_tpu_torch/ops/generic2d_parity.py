"""Hold this checkout's builds of ``csrc/generic2d.cu`` against another
copy of ``csrc/`` (a parent commit's, say) on one CUDA card, bit for bit.

    python -m tclb_tpu_torch.ops.generic2d_parity OTHER/tclb_tpu_torch/csrc \
        [MODEL ...]

For each 2D model with a device header in both copies (or each ``MODEL``
named), both copies are
built alike (``ops/_cuda_build.py``: nvcc for sm_90a, ``--fmad=false``,
the model's header pre-included, ``-Xptxas -v``; the other copy into a
scratch directory).  The script prints both compiler reports (registers
and spills per kernel), runs each kernel of both libraries on the same
inputs (every node type of the model's header painted, two zones, 1%
noise on the initial populations, at 37x53, 256x256 and 40x203, an odd
width several tiles wide): ``generic2d_step`` in both flavours, an
8-step ``generic2d_resident``, ``generic2d_step_bf16`` in both flavours
on the shifted and the raw bf16 stack, the series flavours (a series on
the model's first zonal setting) and, where the header defines
``TCLB_MODEL_ADJOINT``, ``generic2d_step_b`` on seeded cotangents, and
exits nonzero unless every output is bit for bit the same, the globals
within ``GLOBALS_TOL`` (rtol 1e-6 / atol 1e-6: a step that sums in
another order rounds its double sums differently; each is also the same
from run to run).  It also holds ``generic2d_resident`` and
``generic2d_resident_bf16`` of both bit for bit at 8, 98 and 498 steps
on the first two painted lattices and on the model's resident path
(``RESIDENT_PATHS``), the bf16 launch against as many chained
``generic2d_step_bf16`` launches, and times both flavours of both there
(``time_resident``); for d2q9_kuper, drop.xml's window split with each
library (``split_drop``); for d2q9, bench.py's bf16 flagship windows
with each library (``flagship_windows``).  It then holds each flavour of
``generic2d_step`` of both libraries alike at 1024x1024 (many tiles a
side, where the small lattices have one or two; the globals also the
same from run to run) and times it there (``time_steps``: CUDA events
over ``REPS`` calls, the libraries alternating in ``ROUNDS`` rounds, on
chip_smoke's 1024x1024 lattice of a multi-stage model, else the painted
one).  A change to the
model-independent templates (``generic2d.cu``, ``generic_common.cuh``,
``storage.cuh``, ``generic2d_adjoint.cuh``) is held this way against the
parent's builds.

A copy whose resident kernel runs a grid barrier a stage (exports
``generic2d_resident_capacity``) is bound through :class:`GridBarrierAbi`.
A copy of ``csrc/`` from before the backward read zonal settings (no
``generic2d_step_b_zonal`` export: its ``generic2d_step_b`` takes no zone
table) is bound through :class:`NoZoneTableStepB`, which drops the zone
table the wrapper passes; a copy whose step entries take the scratch
stack ``mid`` (the copies that ran a plan of three stages one launch a
stage) through :class:`PassesAbi`; a copy without
``generic2d_step_blocks`` (its globals flavours a block a tile) through
:class:`TileBlocksAbi`.

    python -m tclb_tpu_torch.ops.generic2d_parity --cut SRC/csrc [MODEL ...]

builds ``SRC``'s ``generic2d.cu`` for each ``MODEL`` (by default
``CUT_MODELS``: the one-stage, ring-form and pass-form headers that lose
the most time) in the cut-down variants ``CUTS`` and, for a header with
globals, ``GLOBALS_CUTS``, and times ``generic2d_step`` of each in the
flavours ``CUT_FLAVOURS`` (f32, bf16 shifted and raw, both globals
flavours) at 1024x1024, the variants of a model alternating in rounds:
the instrument that shows what holds a form back.  A variant replaces
the call of the header's stage in the template's ``run_stage`` (so it
cuts any form that runs its stages through it), for ``d2q9_npe_guo``
the header's second pass, or a part of the globals flavours' sums and
reduction (a variant a source has no code for is skipped).  For an
adjoint header (``d2q9_heat_adj``, ``d2q9_adj``, ``d2q9_optimalMixing``,
``d2q9_plate``, named as ``MODEL``) it also times ``generic2d_step_b``
whole and in the reverse variants ``REVERSE_CUTS`` (its data movement
alone; its reverse stage without the settings sums) on the lattice of
the model's gradient path.

    python -m tclb_tpu_torch.ops.generic2d_parity --cut --resident \
        SRC/csrc [MODEL ...]

builds ``SRC``'s ``generic2d.cu`` for each ``MODEL`` (by default
``RESIDENT_CUT_MODELS``) in the variants ``RESIDENT_CUTS`` of
``generic2d_resident`` (whole; the grid barriers alone; no barrier, its
output wrong; loads and stores alone) and times each at the model's
resident path lattice and step count (``RESIDENT_PATHS``) beside one
``generic2d_step`` of the whole build on the same state (a band engine's
step); a variant whose code the source lacks is skipped with a note.

Where the header defines ``TCLB_MODEL_ADJOINT``, the first form also
holds ``generic2d_step_b`` of both libraries on that lattice (512x1024
for ``d2q9_heat_adj`` and ``d2q9_adj``, 1024x1024 for the other two:
``lam_in`` bit for bit, the settings cotangent within rtol 1e-4 / atol
1e-6 and the same from run to run) and times both (``time_step_b``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from tclb_tpu_torch.core import shift as ddf
from tclb_tpu_torch.ops import _cuda_build as cb
from tclb_tpu_torch.ops import generic_kernels as gk

# the painted lattices: 37x53 (under a tile wide, odd nx), 256x256, and
# 40x203 (several 64-wide pair tiles, odd nx: every other row's pairs
# unaligned); the resident kernel is held on the first two
SHAPES = ((37, 53), (256, 256), (40, 203))
RESIDENT_SHAPES = SHAPES[:2]
# each model's resident path: its lattice (ny, nx) and the steps one
# generic2d_resident launch takes there (the even part of a Log
# interval's niter - 1: 498 of 500, 198 of 200, heat_adj.xml's Solve
# 3998, adj_drag.xml's 98); d2q9 at karman.xml's lattice (no path: d2q9
# without a series takes its own kernels)
RESIDENT_PATHS = {
    "d2q9": ((100, 1024), 498), "d2q9_kuper": ((128, 128), 498),
    "d2q9_heat_adj": ((32, 64), 3998), "d2q9_heat": ((64, 512), 498),
    "d2q9_heat_conjugate": ((128, 128), 498), "d2q9_hb": ((128, 128), 498),
    "sw": ((64, 256), 498), "d2q9_solid": ((128, 128), 198),
    "d2q9_npe_guo": ((32, 64), 498),
    "d2q9_pf_pressureEvolution": ((128, 64), 498),
    "d2q9_pp_MCMP": ((64, 128), 498), "d2q9_lee": ((128, 128), 498),
    "d2q9_poison_boltzmann": ((128, 128), 498),
    "d2q9_adj": ((32, 64), 98), "d2q9_optimalMixing": ((128, 128), 198),
    "d2q9_plate": ((128, 128), 198)}
RESIDENT_STEPS = (8, 98, 498)   # the step counts held on the painted states
RESIDENT_REPS = 10              # resident calls a round (timing)
TIMED = (1024, 1024)      # the shape the step kernels are timed at
REPS, ROUNDS = 100, 4     # calls a round, rounds a library (timing)
GLOBALS_TOL = {"rtol": 1e-6, "atol": 1e-6}
TOL_TEXT = f"rtol {GLOBALS_TOL['rtol']:g} / atol {GLOBALS_TOL['atol']:g}"


def paint(model, shape, seed: int = 5, device: str = "cuda",
          settings=None, zone1=None):
    """A lattice (on the card) with every node type ``model``'s header reads:
    the collision type inside, each boundary type in a column of its own,
    each other type in a patch (set within its group's bits, so a second
    collision type replaces the first), zone 1 on the lower half with the
    zonal values ``zone1`` (setting name -> value); Init with ``settings``,
    then 1% noise on every plane."""
    from tclb_tpu_torch import Lattice
    ny, nx = shape
    nt = model.node_types
    coll = "MRT" if "MRT" in nt else "BGK"
    flags = np.full(shape, model.flag_for(coll), dtype=np.uint16)
    names = [n for n in gk.DEVICE_MODELS[model.name].node_types
             if n in nt and n != coll]
    for i, name in enumerate(names):
        x = 2 + i * max(nx // (len(names) + 2), 1)
        if nt[name].group == "BOUNDARY":
            flags[1:-1, x] = model.flag_for(name, coll)
        else:
            patch = flags[ny // 4:ny // 2, x:x + 2]
            patch &= np.uint16(~nt[name].mask & 0xffff)
            patch |= np.uint16(nt[name].value)
    flags[0, :] = flags[-1, :] = model.flag_for("Wall")
    flags[ny // 2:, :] |= np.uint16(1 << model.zone_shift)
    lat = Lattice(model, shape, dtype=torch.float32, device=device,
                  settings=settings or {})
    lat.set_flags(flags)
    for name, value in (zone1 or {}).items():
        lat.set_setting(name, value, zone=1)
    lat.init()
    rng = np.random.default_rng(seed)
    f = lat.state.fields.cpu().numpy()
    lat.state.fields.copy_(torch.as_tensor(
        f * (1 + 0.01 * rng.standard_normal(f.shape)), dtype=torch.float32))
    return lat


def with_series(lat, T: int = 16):
    """``lat`` with a <Control> series on its model's first zonal setting
    in zone 0 (a ramp of 1% over ``T`` iterations)."""
    if not lat.model.zonal_settings:
        return lat
    name = lat.model.zonal_settings[0]
    v = float(lat.params.settings[lat.model.setting_index[name]])
    lat.set_setting_series(name, np.linspace(v, 1.01 * v + 1e-4, T), zone=0)
    return lat


def run(lat) -> tuple:
    """Every kernel of the model's library on the lattice's state:
    ``(outputs as integer bits, sums)``: the sums are the globals
    flavours' globals and ``generic2d_step_b``'s settings cotangent (each
    a sum over the blocks' partials, whose order a change of tile
    changes)."""
    m = lat.model
    f, flags, ztab, a = gk.kernel_inputs(m, lat.state, lat.params)
    out, sums = {}, {}
    out["step"] = gk.step(f, flags, ztab, a)
    out["step_globals"], sums["step_globals"] = gk.step_globals(
        f, flags, ztab, a)
    out["resident"] = gk.resident(f, flags, ztab, a, 8)
    for rep_ in ("shifted", "raw"):
        fb, ab = bf16_inputs(lat, f, a, rep_)
        tag = "step_bf16" + ("_raw" if rep_ == "raw" else "")
        out[tag] = gk.step(fb, flags, ztab, ab)
        out[f"{tag}_globals"], sums[f"{tag}_globals"] = gk.step_globals(
            fb, flags, ztab, ab)
    series = gk.series_inputs(m, lat.params)
    if series is not None:
        out["step_series"] = gk.step_series(f, flags, ztab, a, series, 7)
        out["step_series_globals"], sums["step_series_globals"] = \
            gk.step_series_globals(f, flags, ztab, a, series, 7)
    if gk.DEVICE_MODELS[m.name].adjoint:
        from tclb_tpu_torch.ops import adjoint_kernels as ak
        gen = torch.Generator(device=f.device).manual_seed(11)
        lam = torch.randn(f.shape, generator=gen, device=f.device)
        lam_g = torch.randn((m.n_globals,), generator=gen, device=f.device)
        lam_in, sums["step_b settings"] = ak.step_b(f, flags, ztab, a,
                                                    lam, lam_g)
        out["step_b"] = lam_in
    if f.is_cuda:
        torch.cuda.synchronize()
    bits = {k: v.view(torch.int32) if v.dtype == torch.float32 else
            v.view(torch.int16) if v.dtype == torch.bfloat16 else v
            for k, v in out.items()}
    return bits, sums


def bf16_inputs(lat, f, a, storage_repr: str = "shifted") -> tuple:
    """The lattice's state narrowed to the bf16 stack in ``storage_repr``
    (shifted, or raw: no shift), and the step arguments with its
    shifts."""
    fb = ddf.narrow_stack(f, torch.bfloat16,
                          ddf.stack_shift(lat.model, storage_repr))
    return fb, dataclasses.replace(
        a, shift=ddf.kernel_shift(lat.model, storage_repr))


def median_ms(launches: dict, reps: int = REPS,
              rounds: int = ROUNDS) -> dict:
    """Each tag's device ms a call: ``launches`` maps a tag to a function
    that makes one call; in each of ``rounds`` rounds every tag in turn
    runs ``reps`` calls between two CUDA events, queued behind a spin
    kernel so that the calls run back to back (the host's time a call is
    not timed); the median over the rounds."""
    times = {tag: [] for tag in launches}
    for fn in launches.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for tag, fn in launches.items():
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(reps * 50_000)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
            times[tag].append(t0.elapsed_time(t1) / reps)
    return {tag: statistics.median(t) for tag, t in times.items()}


def timed_lattice(model: str):
    """The lattice a model's step kernels are timed on: chip_smoke's
    1024x1024 lattice of a multi-stage model (painted as the reference's
    tests paint it, initialised), the parity lattice for any other."""
    chip_smoke = import_chip_smoke()
    if model in chip_smoke.MULTISTAGE_MODELS:
        return chip_smoke.multistage_lattice(model, TIMED)
    from tclb_tpu_torch.models import get_model
    return paint(get_model(model), TIMED)


def time_steps(lat, libs: dict, flavours=None, compare: bool = False
               ) -> tuple:
    """``generic2d_step`` of each library (``libs``: tag -> its
    ``gk._LIB`` entry) in each flavour (or those named in ``flavours``)
    on ``lat``'s state: the median ms a call, the libraries alternating.
    With ``compare``, each flavour's output of every library is first held
    against the first library's: fields bit for bit, globals within
    ``GLOBALS_TOL``.  Returns the times and whether all agreed."""
    m = lat.model.name
    f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
    fb, ab = bf16_inputs(lat, f, a)
    fr, ar = bf16_inputs(lat, f, a, "raw")
    series = gk.series_inputs(lat.model, with_series(lat).params)
    calls = {"plain": lambda: gk.step(f, flags, ztab, a),
             "globals": lambda: gk.step_globals(f, flags, ztab, a),
             "bf16": lambda: gk.step(fb, flags, ztab, ab),
             "bf16 globals": lambda: gk.step_globals(fb, flags, ztab, ab),
             "bf16 raw": lambda: gk.step(fr, flags, ztab, ar),
             "bf16 raw globals": lambda: gk.step_globals(fr, flags, ztab, ar),
             "series": lambda: gk.step_series(f, flags, ztab, a, series, 7),
             "series globals": lambda: gk.step_series_globals(
                 f, flags, ztab, a, series, 7)}
    if series is None:
        del calls["series"], calls["series globals"]
    if flavours is not None:
        calls = {k: v for k, v in calls.items() if k in flavours}
    out, same = {}, True
    for flavour, call in calls.items():

        def launch(entry, call=call):
            gk._LIB[m] = entry
            return call()
        if compare:
            got = {tag: launch(e) for tag, e in libs.items()}
            (tag0, ref), *rest = got.items()
            for tag, res in rest:
                fields, sums = (res, None) if torch.is_tensor(res) else res
                want = ref if torch.is_tensor(ref) else ref[0]
                equal = torch.equal(fields.view(torch.int16),
                                    want.view(torch.int16))
                close = rerun = True
                if sums is not None:
                    close = torch.allclose(sums, ref[1], equal_nan=True,
                                           **GLOBALS_TOL)
                    rerun = torch.equal(sums.view(torch.int32),
                                        launch(libs[tag])[1].view(
                                            torch.int32))
                print(f"{m} generic2d_step {flavour} at {lat.shape}: {tag} "
                      f"{'bit-identical' if equal else 'DIFFERS'} to {tag0}"
                      + ("" if sums is None else
                         f", globals {'within' if close else 'OUTSIDE'} "
                         f"{TOL_TEXT}, "
                         f"{'the same' if rerun else 'NOT the same'} run to "
                         "run"))
                same &= equal and close and rerun
        ms = median_ms({tag: (lambda e=e: launch(e))
                        for tag, e in libs.items()})
        out[flavour] = ms
        print(f"{m} generic2d_step {flavour} at {lat.shape}: " + ", ".join(
            f"{tag} {v:.5f} ms" for tag, v in ms.items())
            + " (a call: " + " / ".join(
                str(getattr(e["lib"], "passes", 1)) for e in libs.values())
            + " launches; medians of "
            f"{ROUNDS}x{REPS} calls)")
    return out, same


def import_chip_smoke():
    """chip_smoke.py at the checkout's root (its path lattices)."""
    root = pathlib.Path(__file__).resolve().parents[2]
    for path in (root, root / "tests"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import chip_smoke
    return chip_smoke


def step_b_lattice(model: str):
    """The lattice an adjoint header's ``generic2d_step_b`` runs on in
    chip_smoke's phase 7 (the gradient paths): bench.py's heat_adj
    channel and its d2q9_adj case at 512x1024, the 1024x1024 lattice of
    the other two headers' sensitivity paths."""
    cs = import_chip_smoke()
    if model == "d2q9_heat_adj":
        return cs.heat1024_lattice("cuda")
    if model == "d2q9_adj":
        return cs.adj_bench_lattice()
    return cs.adj_lattice(model, (cs.ADJ_N, cs.ADJ_N))


def time_step_b(lat, libs: dict, compare: bool = False) -> tuple:
    """``generic2d_step_b`` of each library (``libs``: tag -> its
    ``gk._LIB`` entry) on ``lat``'s state with seeded cotangents: the
    median ms a call, the libraries alternating.  With ``compare``, each
    library's ``lam_in`` is first held against the first library's bit
    for bit and its settings cotangent within ``GLOBALS_TOL`` and the
    same from run to run.  Returns the times and whether all agreed."""
    from tclb_tpu_torch.ops import adjoint_kernels as ak
    m = lat.model.name
    f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
    gen = torch.Generator(device=f.device).manual_seed(12)
    lam = torch.randn(f.shape, generator=gen, device=f.device)
    lam_g = torch.randn((lat.model.n_globals,), generator=gen,
                        device=f.device)

    def launch(entry):
        gk._LIB[m] = entry
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
            print(f"{m} generic2d_step_b at {lat.shape}: {tag} lam_in "
                  f"{'bit-identical' if equal else 'DIFFERS'} to {tag0}, "
                  f"settings {'within' if close else 'OUTSIDE'} {TOL_TEXT}"
                  f" (max abs diff {diff:.3e} of "
                  f"{float(sett0.abs().max()):.3e}), "
                  f"{'the same' if rerun else 'NOT the same'} run to run")
            same &= equal and close and rerun
    ms = median_ms({tag: (lambda e=e: launch(e)) for tag, e in libs.items()})
    print(f"{m} generic2d_step_b at {lat.shape}: " + ", ".join(
        f"{tag} {v:.5f} ms" for tag, v in ms.items())
        + f" (medians of {ROUNDS}x{REPS} calls)")
    return ms, same


class NoZoneTableStepB:
    """A library whose ``generic2d_step_b`` predates the zone table (no
    ``generic2d_step_b_zonal`` export): that entry takes the wrapper's
    arguments without ``ztab``, which is dropped here; every other entry
    is the library's own."""

    def __init__(self, lib: ctypes.CDLL, model: str):
        self._lib = lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.generic2d_step_b.argtypes = [
            p, p, p, ctypes.POINTER(gk.c_args_type(model)), p, p, p, p, i, p]

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name == "generic2d_step_b":
            return lambda fin, lam, flags, ztab, *rest: fn(fin, lam, flags,
                                                           *rest)
        return fn


class PassesAbi:
    """A library whose ``generic2d_step`` entries take an f32 scratch
    stack ``mid`` after ``fout`` (the copies of ``csrc/`` that ran a plan
    of three stages one launch a stage, carrying a step's globals from
    pass to pass in a row of ``partials`` after the blocks', and whose
    ``generic2d_plan`` also reports those launches).  The wrapper's calls
    are passed on with a scratch stack and partials of that size;
    ``passes`` is the launches of one step.  Every other entry is the
    library's own."""

    STEPS = ("generic2d_step", "generic2d_step_bf16",
             "generic2d_step_series")

    def __init__(self, lib: ctypes.CDLL, model: str):
        self._lib = lib
        dm = gk.DEVICE_MODELS[model]
        self._planes, self._n_g = len(dm.storage), max(len(dm.globals_), 1)
        p, i = ctypes.c_void_p, ctypes.c_int
        ip, fp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_float)
        argp = ctypes.POINTER(gk.c_args_type(model))
        lib.generic2d_plan.argtypes = [ip, ip]
        lib.generic2d_layout.argtypes = [ip] * 8
        for name, args in (
                ("generic2d_step", [p, p, p, p, p, argp, p, p, i, p]),
                ("generic2d_step_bf16", [p, p, p, p, p, argp, fp, p, p, i,
                                         p]),
                ("generic2d_step_series", [p, p, p, p, p, argp, p, p, i, i,
                                           p, p, i, p])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        stages, passes = ctypes.c_int(0), ctypes.c_int(0)
        lib.generic2d_plan(ctypes.byref(stages), ctypes.byref(passes))
        self.stages, self.passes = stages.value, passes.value
        vals = [ctypes.c_int(0) for _ in range(8)]
        lib.generic2d_layout(*[ctypes.byref(v) for v in vals])
        self._tile = (vals[0].value, vals[1].value)
        self._scratch = {}

    def _buffers(self, ny: int, nx: int, device: int) -> tuple:
        """The scratch stack and partials (a row more than the blocks)
        for a ``ny`` x ``nx`` lattice on ``device``."""
        key = (ny, nx, device)
        if key not in self._scratch:
            ty, tx = self._tile
            blocks = -(-ny // ty) * -(-nx // tx)
            dev = torch.device("cuda", device)
            self._scratch[key] = (
                torch.empty((self._planes, ny, nx), dtype=torch.float32,
                            device=dev),
                torch.empty((blocks + 1, self._n_g), dtype=torch.float64,
                            device=dev))
        return self._scratch[key]

    def __getattr__(self, name):
        if name == "generic2d_plan":
            def plan(n_stages):
                n_stages._obj.value = self.stages
            return plan
        fn = getattr(self._lib, name)
        if name not in self.STEPS:
            return fn

        def call(fin, fout, flags, ztab, args, *rest):
            # rest: [shift,] [series,] partials, gout, device, stream
            mid, partials = self._buffers(args._obj.ny, args._obj.nx,
                                          rest[-2])
            rest = list(rest)
            if rest[-4] is not None:
                rest[-4] = partials.data_ptr()
            return fn(fin, fout, mid.data_ptr(), flags, ztab, args, *rest)
        return call


class GridBarrierAbi:
    """A library whose ``generic2d_resident`` is the grid-barrier kernel
    (the copies of ``csrc/`` before the neighbour waits): its entries take
    an f32 scratch stack ``mid`` where the counters go and the block count
    where the reach goes, and it exports ``generic2d_resident_capacity``
    instead of ``generic2d_resident_tile``.  The wrapper's calls are passed
    on with ``mid`` where that kernel reads it (a plan of two stages or
    more, but an f32 ring-form one) and as many blocks as the device holds
    at once, no more than a block of 256 nodes a thread each (its own
    rule).  Every other entry is the library's (or ``inner``'s) own."""

    def __init__(self, inner, model: str):
        self._inner = inner
        p, i = ctypes.c_void_p, ctypes.c_int
        ip, fp = ctypes.POINTER(i), ctypes.POINTER(ctypes.c_float)
        argp = ctypes.POINTER(gk.c_args_type(model))
        old = {"generic2d_resident": [p] * 6 + [argp, i, i, i, p],
               "generic2d_resident_bf16": [p] * 6 + [argp, fp, i, i, i, p],
               "generic2d_resident_capacity": [i, i, ip, ip]}
        for name, args in old.items():
            getattr(inner, name).argtypes = args
            getattr(inner, name).restype = i
        m = gk._get_model(model)
        stages = len(gk.DEVICE_MODELS[model].plan)
        ring = gk.step_form(m) == "ring"
        self._capacity = {}

        def launcher(name, bf16):
            fn = getattr(inner, name)

            def call(fin, fout, scratch, counters, flags, ztab, args, *rest):
                # rest: [shift,] nsteps, reach, device, stream
                a, dev = args._obj, rest[-2]
                mid = None
                if stages > 1 and (bf16 or not ring):
                    mid = torch.empty((len(gk.DEVICE_MODELS[model].storage),
                                       a.ny, a.nx), dtype=torch.float32,
                                      device=torch.device("cuda", dev))
                blocks = min(self.capacity(dev, bf16),
                             (a.ny * a.nx + 255) // 256)
                return fn(fin, fout, scratch,
                          None if mid is None else mid.data_ptr(), flags,
                          ztab, args, *rest[:-3], blocks, dev, rest[-1])
            return call
        self.generic2d_resident = launcher("generic2d_resident", False)
        self.generic2d_resident_bf16 = launcher("generic2d_resident_bf16",
                                                True)

        def tile(reach, ty, tx, fuse, threads):
            ty._obj.value, tx._obj.value = gk.BLOCK
        self.generic2d_resident_tile = tile

    def capacity(self, device: int, bf16: bool) -> int:
        """Blocks of the cooperative kernel the device holds at once."""
        key = (device, bf16)
        if key not in self._capacity:
            coop, blocks = ctypes.c_int(0), ctypes.c_int(0)
            gk.check(self._inner, self._inner.generic2d_resident_capacity(
                device, int(bf16), ctypes.byref(coop),
                ctypes.byref(blocks)), "generic2d_resident capacity query")
            if not coop.value or blocks.value < 1:
                raise RuntimeError(f"device {device} cannot run the "
                                   "cooperative generic2d_resident")
            self._capacity[key] = blocks.value
        return self._capacity[key]

    def __getattr__(self, name):
        return getattr(self._inner, name)


class TileBlocksAbi:
    """A library without ``generic2d_step_blocks`` (the copies of
    ``csrc/`` whose globals flavours launch a block a tile): that entry
    is answered from the step tile ``generic2d_layout`` reports, the
    partials' rows the tiles of the lattice.  Every other entry is the
    library's (or ``inner``'s) own."""

    def __init__(self, inner):
        self._inner = inner
        ip = ctypes.POINTER(ctypes.c_int)
        inner.generic2d_layout.argtypes = [ip] * 8
        vals = [ctypes.c_int(0) for _ in range(8)]
        inner.generic2d_layout(*[ctypes.byref(v) for v in vals])
        ty, tx = vals[0].value, vals[1].value

        def blocks(ny, nx, bf16, series, device, out):
            out._obj.value = -(-ny // ty) * -(-nx // tx)
            return 0
        self.generic2d_step_blocks = blocks

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _entry(model: str, path: pathlib.Path, passes_abi: bool) -> dict:
    """``model``'s ``gk._LIB`` entry for the library at ``path``: bound
    through :class:`PassesAbi` where ``passes_abi``, through
    :class:`GridBarrierAbi` where its resident kernel is the grid-barrier
    one, through :class:`TileBlocksAbi` where it launches a globals block
    a tile, its ``generic2d_step_b`` through :class:`NoZoneTableStepB`
    where the library has no ``generic2d_step_b_zonal``."""
    raw = ctypes.CDLL(str(path))
    lib = PassesAbi(raw, model) if passes_abi else raw
    if hasattr(raw, "generic2d_resident_capacity"):
        lib = GridBarrierAbi(lib, model)
    if not hasattr(raw, "generic2d_step_blocks"):
        lib = TileBlocksAbi(lib)
    entry = gk.bind(lib, model, path.name)
    if "tile_b" in entry and not hasattr(raw, "generic2d_step_b_zonal"):
        entry["lib"] = NoZoneTableStepB(entry["lib"], model)
    return entry


_ENTRY = re.compile(r"Compiling entry function '_Z\d+(\w+?)(I.*|P\w*)?' "
                    r"for")
_FLAVOUR = re.compile(r"^I(?:f|13__nv_bfloat16)Lb([01])ELb([01])E")


def ptxas_lines(report: str) -> list:
    """The compiler report's registers, stack, spills and shared memory,
    one line a kernel, named by its template (``generic2d_pass_kernel
    bf16 globals``; a kernel's flavour: its storage, its globals and its
    series) or its name (a kernel that is no template)."""
    out, name = [], None
    for line in report.splitlines():
        hit = _ENTRY.search(line)
        if hit:
            name, args = hit.group(1), hit.group(2) or ""
            if args.startswith("I13__nv_bfloat16"):
                name += " bf16"
            fl = _FLAVOUR.match(args)
            if fl:
                name += (" globals" if fl.group(1) == "1" else "") + (
                    " series" if fl.group(2) == "1" else "")
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def load(csrc: pathlib.Path, build_dir: pathlib.Path, models) -> dict:
    """Each model's library entry (``gk._LIB[model]``) built from ``csrc``
    (one ``nvcc`` a model, started together), and print its compiler
    report."""
    cb.CSRC, cb.BUILD_DIR = csrc, build_dir
    gk._LIB.clear()
    # a copy whose step entries still take the scratch stack `mid`
    passes_abi = re.search(r"int generic2d_step\(const float\* fin, "
                           r"float\* fout, float\* mid",
                           (csrc / "generic2d.cu").read_text()) is not None
    with concurrent.futures.ThreadPoolExecutor(len(models)) as pool:
        built = list(pool.map(gk.build, models))
    out = {}
    for m, (path, report) in zip(models, built):
        out[m] = _entry(m, path, passes_abi)
        print(f"{m} ({path.name} from {csrc}):")
        for line in ptxas_lines(report):
            print(f"  ptxas: {line}")
    return out


# --cut: the cut-down variants.  Each replaces run_stage's call of the
# header's stage (CUT_HOOK) with the body given, which sees the node
# context `c` and the stage S: "loads and stores" moves what each stage
# writes from its pulled neighbour (the form's data movement with no
# physics), "stage 0 alone" replaces stage 1 by a copy of the node's own
# planes, "stage 1 alone" stage 0.  "pass 1 alone" (d2q9_npe_guo) keeps
# the header's first pass over the five groups and stores a sum of its
# moments in place of the second.
CUT_HOOK = "  model::stage<S>(c);\n"
_COPY = ("#pragma unroll\n"
         "  for (int k = 0; k < model::N_STORAGE; ++k)\n"
         "    if (writes(S, k)) c.store(k, c.{get});\n")
CUTS = {
    "loads and stores": _COPY.format(get="pulled(k)"),
    "stage 0 alone": ("  if constexpr (S == 0) model::stage<S>(c);\n"
                      "  else {\n" + _COPY.format(get="load(k, 0, 0)")
                      + "  }\n"),
    "stage 1 alone": ("  if constexpr (S == 0) {\n"
                      + _COPY.format(get="load(k, 0, 0)")
                      + "  } else model::stage<S>(c);\n"),
}
NPE_PASS2 = "  // pass 2: collide each group and store it\n"
NPE_PASS1_ONLY = (
    "  const float m_ = pot + psi + rho + jx + jy + n0 + n1 + gphix + gphiy"
    " + gpsix + gpsiy + umx + umy + bk + ez;\n"
    "#pragma unroll\n"
    "  for (int k = 0; k < N_STORAGE; ++k) c.store(k, m_);\n"
    "}\n")
# The reverse variants of an adjoint header (generic2d_adjoint.cuh):
# "reverse loads and stores" replaces the call of its stage_b<0>
# (B_STAGE_HOOK) by q = the pulled primal plus the node's lam_out, each
# plane (the kernel's data movement with no reverse physics), "reverse
# without settings sums" keeps stage_b<0>; both drop the settings sums
# (add_setting's accumulation, B_SUM_HOOK, and the block reduction,
# B_FINISH).
B_STAGE_HOOK = "model::stage_b<0>(c);"
B_SUM_HOOK = "if (counts) sacc[i] += (double)v;"
B_FINISH = re.compile(r"finish_sums<.*?\}\);", re.DOTALL)
B_COPY = ("for (int k_ = 0; k_ < model::N_STORAGE; ++k_) "
          "c.set_q(k_, c.pulled(k_) + c.lam(k_));")
REVERSE_CUTS = ("reverse loads and stores", "reverse without settings sums")
# The globals variants, for a header with globals: "globals without sums"
# drops the node's sums in add_global (GLOBALS_SUM_HOOK in generic2d.cu)
# and keeps the reduction; the other two keep the sums and cut the
# reduction after each block's partials (no fence, no arrival count, no
# last block), the block's sums added by thread 0 alone ("block partials
# alone") or by one thread a global ("partials a thread a global").  In a
# source whose forward flavours reduce through finish_sums (a copy from
# before reduce_globals) they insert the cut form of the forward reduction before the
# reverse kernels' all-sums branch (FINISH_HOOK in generic_common.cuh),
# so the forward flavours return after it and the reverse kernels keep
# their own; in one that reduces through reduce_globals (a thread a global
# already) "block partials alone" returns after the partials
# (REDUCE_HOOK) and "partials a thread a global" has nothing to cut.
GLOBALS_SUM_HOOK = "    if (kGlobals && counts) acc[g] += (double)v;\n"
FINISH_HOOK = "  if constexpr (kAllSums) {\n    if (tid < N) {\n"
REDUCE_HOOK = ("    __threadfence();\n  }\n  __syncthreads();\n"
               "  if (tid == 0) last = atomicAdd(")
REDUCE_CUT = ("  }\n  return;\n  __syncthreads();\n"
              "  if (tid == 0) last = atomicAdd(")
_BLOCK_PARTIALS = (
    "  if constexpr (!kAllSums) {{\n"
    "    if ({who}) {{\n"
    "{loop}"
    "      double v = 0.0;\n"
    "      for (int w = 0; w < WARPS; ++w) v += warp_sum[{g}][w];\n"
    "      partials[(size_t)block * N + {g}] = v;\n"
    "{close}"
    "    }}\n"
    "    return;\n"
    "  }}\n")
GLOBALS_CUTS = {
    "globals without sums": (GLOBALS_SUM_HOOK, "    (void)g; (void)v;\n"),
    "block partials alone": (FINISH_HOOK, _BLOCK_PARTIALS.format(
        who="tid == 0", loop="      for (int g = 0; g < N; ++g) {\n",
        g="g", close="      }\n") + FINISH_HOOK),
    "partials a thread a global": (FINISH_HOOK, _BLOCK_PARTIALS.format(
        who="tid < N", loop="", g="tid", close="") + FINISH_HOOK),
}
CUT_MODELS = ("d2q9_npe_guo", "d2q9_solid", "d2q9_pf_pressureEvolution",
              "d2q9_kuper", "d2q9", "d2q9_adj", "d2q9_plate", "sw")
# --cut --resident: the variants of generic2d_resident as edits of its
# source (pattern, replacement), inside RESIDENT_SPANS: "barriers alone"
# runs no node loop (the grid stride's loops end at once), "no barrier"
# drops every grid.sync(); "loads and stores" is CUTS' variant (in
# run_stage, so in every form)
RESIDENT_CUTS = {
    "whole": (),
    "barriers alone": ((re.compile(r"idx < \(int\)n; idx \+= stride"),
                        "idx < 0; idx += stride"),),
    "no barrier": ((re.compile(r"grid\.sync\(\);"), "(void)0;"),),
    "loads and stores": (),
}
RESIDENT_SPANS = ("resident_stages(", "generic2d_resident_kernel(")
RESIDENT_CUT_MODELS = ("d2q9_kuper", "d2q9_heat_adj", "d2q9_heat",
                       "d2q9_npe_guo", "d2q9_solid", "d2q9_lee")
CUT_FLAVOURS = ("plain", "bf16", "bf16 raw", "globals", "bf16 globals")


def cut_variants(model: str) -> list:
    """The variants ``--cut`` builds for ``model``: ``"full"`` and those
    of ``CUTS``, ``"pass 1 alone"`` and ``REVERSE_CUTS`` that apply to its
    plan and header."""
    dm = gk.DEVICE_MODELS[model]
    out = ["full", "loads and stores"]
    if len(dm.plan) == 2:
        out += ["stage 0 alone", "stage 1 alone"]
    if model == "d2q9_npe_guo":
        out.append("pass 1 alone")
    if dm.globals_:
        out += list(GLOBALS_CUTS)
    if dm.adjoint:
        out += list(REVERSE_CUTS)
    return out


def _cut_reverse(path: pathlib.Path, variant: str) -> None:
    """Cut the reverse variant ``variant`` into the reverse kernel's
    source at ``path``."""
    text = path.read_text()
    if (text.count(B_STAGE_HOOK) != 1 or text.count(B_SUM_HOOK) != 1
            or len(B_FINISH.findall(text)) != 1):
        raise SystemExit("--cut: generic2d_adjoint.cuh has not the one "
                         "call of stage_b<0>, settings sum and finish_sums "
                         "it cuts")
    text = B_FINISH.sub("", text.replace(B_SUM_HOOK, ""))
    if variant == "reverse loads and stores":
        text = text.replace(B_STAGE_HOOK, B_COPY)
    path.write_text(text)


def cut_csrc(src: pathlib.Path, dst: pathlib.Path, model: str,
             variant: str) -> bool:
    """A copy of the ``csrc/`` directory ``src`` at ``dst`` with
    ``variant`` cut into it; False (and no copy) where ``src`` has none
    of the code a globals variant cuts."""
    shutil.copytree(src, dst)
    if variant == "full":
        return True
    if variant in REVERSE_CUTS:
        _cut_reverse(dst / "generic2d_adjoint.cuh", variant)
        return True
    if variant in GLOBALS_CUTS:
        hook, repl = GLOBALS_CUTS[variant]
        forward = (dst / "generic2d.cu").read_text()
        if hook != GLOBALS_SUM_HOOK and "finish_sums<NG" not in forward:
            if variant != "block partials alone" \
                    or "reduce_globals<NG" not in forward:
                shutil.rmtree(dst)
                return False
            hook, repl = REDUCE_HOOK, REDUCE_CUT
        path = dst / ("generic2d.cu" if hook == GLOBALS_SUM_HOOK
                      else "generic_common.cuh")
        text = path.read_text()
        if text.count(hook) != 1:
            raise SystemExit(f"--cut: {path.name} has not the one "
                             f"{hook.strip()!r} the {variant!r} variant cuts")
        path.write_text(text.replace(hook, repl))
        return True
    if variant == "pass 1 alone":
        path = dst / gk.DEVICE_MODELS[model].header
        text = path.read_text()
        start = text.index(NPE_PASS2)
        end = text.index("\n}\n", start) + 3
        path.write_text(text[:start] + NPE_PASS1_ONLY + text[end:])
        return True
    path = dst / "generic2d.cu"
    text = path.read_text()
    if text.count(CUT_HOOK) != 1:
        raise SystemExit("--cut: generic2d.cu has not the one call of the "
                         "header's stage in run_stage it cuts")
    path.write_text(text.replace(CUT_HOOK, CUTS[variant]))
    return True


def _spans(text: str, names) -> list:
    """The ``(start, end)`` of each definition of the functions ``names``
    in ``text``: from the name to the ``}`` that closes its body."""
    out = []
    for name in names:
        at = text.find(name)
        while at >= 0:
            end = text.index("\n}\n", at)
            if text.find("{", at, end) >= 0:
                out.append((at, end))
            at = text.find(name, end)
    return out


def cut_resident_csrc(src: pathlib.Path, dst: pathlib.Path,
                      variant: str) -> bool:
    """A copy of ``src`` at ``dst`` with the resident variant ``variant``
    cut into ``generic2d.cu``; False (and no copy) where the source has
    none of the code that variant removes."""
    if variant == "loads and stores":
        cut_csrc(src, dst, "", variant)
        return True
    text = (src / "generic2d.cu").read_text()
    hit = False
    for start, end in sorted(_spans(text, RESIDENT_SPANS), reverse=True):
        body = text[start:end]
        for pattern, repl in RESIDENT_CUTS[variant]:
            body, n = pattern.subn(repl, body)
            hit |= n > 0
        text = text[:start] + body + text[end:]
    if RESIDENT_CUTS[variant] and not hit:
        return False
    shutil.copytree(src, dst)
    (dst / "generic2d.cu").write_text(text)
    return True


def build_cut(csrc: pathlib.Path, model: str) -> tuple:
    """Compile ``csrc/generic2d.cu`` with ``model``'s header as the port
    builds it, into ``csrc``: the library's path and the report."""
    out = csrc / f"libcut_{model}.so"
    flags = cb._flags("generic2d", str(csrc / gk.DEVICE_MODELS[model].header))
    proc = subprocess.run([cb.nvcc(), *flags, "-o", str(out),
                           str(csrc / "generic2d.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {csrc}:\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def resident_lattice(model: str):
    """A painted state (``paint``) at ``model``'s resident path lattice
    and the steps one launch takes there (``RESIDENT_PATHS``)."""
    from tclb_tpu_torch.models import get_model
    shape, steps = RESIDENT_PATHS[model]
    return paint(get_model(model), shape), steps


def time_resident(lat, libs: dict, nsteps: int, compare: bool = False,
                  bf16: bool = False) -> tuple:
    """``generic2d_resident`` (``bf16``: on the shifted bf16 stack,
    ``generic2d_resident_bf16``) of each library (``libs``: tag -> its
    ``gk._LIB`` entry) for ``nsteps`` steps on ``lat``'s state, and one
    ``generic2d_step`` of the first library on the same stack: the median
    ms a call, the libraries alternating.  With ``compare``, each
    library's output is first held against the first library's bit for
    bit.  Returns the times and whether all agreed."""
    m = lat.model.name
    f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
    if bf16:
        f, a = bf16_inputs(lat, f, a)
    what = (f"{m} generic2d_resident{'_bf16' if bf16 else ''} ({nsteps} "
            f"steps) at {lat.shape}")

    def launch(entry, call):
        gk._LIB[m] = entry
        return call()
    res = (lambda: gk.resident(f, flags, ztab, a, nsteps))
    same = True
    if compare:
        got = {tag: launch(e, res) for tag, e in libs.items()}
        (tag0, ref), *rest = got.items()
        for tag, out in rest:
            equal = torch.equal(out.view(torch.int16), ref.view(torch.int16))
            print(f"{what}: {tag} {'bit-identical' if equal else 'DIFFERS'}"
                  f" to {tag0}")
            same &= equal
    first = next(iter(libs.values()))
    ms = median_ms({tag: (lambda e=e: launch(e, res))
                    for tag, e in libs.items()}, reps=RESIDENT_REPS)
    step = median_ms({"": lambda: launch(
        first, lambda: gk.step(f, flags, ztab, a))})[""]
    print(f"{what}: " + ", ".join(
        f"{tag} {v:.5f} ms ({v / nsteps * 1e3:.2f} us a step)"
        for tag, v in ms.items())
        + f"; generic2d_step{'_bf16' if bf16 else ''} {step:.5f} ms a step"
        f" (medians of {ROUNDS}x{RESIDENT_REPS} resident calls, "
        f"{ROUNDS}x{REPS} steps)")
    ms["generic2d_step"] = step
    return ms, same


def hold_resident(lat, libs: dict, nsteps: int) -> bool:
    """``generic2d_resident`` and ``generic2d_resident_bf16`` of each
    library for ``nsteps`` steps on ``lat``'s state, bit for bit against
    the first library's, and the first library's bf16 launch bit for bit
    against as many chained ``generic2d_step_bf16`` launches."""
    m = lat.model.name
    f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
    fb, ab = bf16_inputs(lat, f, a)
    same = True
    for tag, (x, args) in (("", (f, a)), ("_bf16", (fb, ab))):
        outs = {}
        for lib_tag, entry in libs.items():
            gk._LIB[m] = entry
            outs[lib_tag] = gk.resident(x, flags, ztab, args, nsteps)
        (tag0, ref), *rest = outs.items()
        for lib_tag, out in rest:
            equal = torch.equal(out.view(torch.int16), ref.view(torch.int16))
            print(f"{m} generic2d_resident{tag} ({nsteps} steps) "
                  f"{lat.shape}: {lib_tag} "
                  f"{'bit-identical' if equal else 'DIFFERS'} to {tag0}")
            same &= equal
    gk._LIB[m] = next(iter(libs.values()))
    chain = fb
    for _ in range(nsteps):
        chain = gk.step(chain, flags, ztab, ab)
    got = gk.resident(fb, flags, ztab, ab, nsteps)
    equal = torch.equal(got.view(torch.int16), chain.view(torch.int16))
    print(f"{m} generic2d_resident_bf16 ({nsteps} steps) {lat.shape}: "
          f"{'bit-identical' if equal else 'DIFFERS'} to {nsteps} chained "
          "generic2d_step_bf16 launches")
    return same and equal


def split_drop(libs: dict) -> dict:
    """drop.xml's window split (chip_smoke's ``window_split``: an
    ``iterate`` of one Log interval on its state after 100 eager steps,
    K5's device time and its wrapper's host time a launch, the idle
    share) with each library (``libs``: tag -> d2q9_kuper's entry) in
    turn."""
    import xml.etree.ElementTree as ET
    cs = import_chip_smoke()
    lat = cs.case_lattice(cs.DROP_XML, torch.float32, "cuda")
    cs.eager_warm(lat, 100)
    every = int(ET.parse(cs.DROP_XML).getroot().find("Log")
                .get("Iterations"))
    out = {}
    for tag, entry in libs.items():
        gk._LIB["d2q9_kuper"] = entry
        f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state,
                                             lat.params)
        out[tag] = cs.window_split(
            lat, every, f"a drop iterate({every}), {tag}",
            "generic2d_resident", lambda: gk.LAUNCHES["generic2d_resident"],
            lambda: gk.resident(f, flags, ztab, a, (every - 1) // 2 * 2))
    return out


def flagship_windows(libs: dict, rounds: int = 2) -> dict:
    """bench.py's flagship in bf16 (chip_smoke's phase 28: d2q9 at
    1024x1024 on ``generic2d_step_bf16``), shifted and raw: the MLUPS of
    an ``iterate`` window of ``FLAGSHIP_WINDOW`` steps fenced by
    synchronize, with each library (``libs``: tag -> d2q9's entry) in
    turn, ``rounds`` rounds; the median a library."""
    import time
    cs = import_chip_smoke()
    out = {}
    for storage_repr in ("shifted", "raw"):
        lat = cs.flagship_lattice(cs.BF16, storage_repr)
        lat.iterate(10)
        lat.synchronize()
        for _ in range(rounds):
            for tag, entry in libs.items():
                gk._LIB["d2q9"] = entry
                t0 = time.perf_counter()
                lat.iterate(cs.FLAGSHIP_WINDOW)
                lat.synchronize()
                dt = time.perf_counter() - t0
                out.setdefault(f"bf16_{storage_repr} {tag}", []).append(
                    cs.FLAGSHIP_N ** 2 * cs.FLAGSHIP_WINDOW / dt / 1e6)
        mlups = {tag: statistics.median(out[f"bf16_{storage_repr} {tag}"])
                 for tag in libs}
        print(f"flagship bf16 {storage_repr} ({lat.engine_name}), "
              f"iterate({cs.FLAGSHIP_WINDOW}): " + ", ".join(
                  f"{tag} {v:.1f} MLUPS" for tag, v in mlups.items())
              + f" (medians of {rounds} windows)")
    return {k: statistics.median(v) for k, v in out.items()}


def cut_resident_main(src: pathlib.Path, models) -> int:
    """Time ``generic2d_resident`` of ``src``'s builds of ``models`` in the
    variants ``RESIDENT_CUTS`` at each model's resident path."""
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for m in models:
            for i, v in enumerate(RESIDENT_CUTS):
                dst = pathlib.Path(tmp) / f"{m}_{i}"
                if cut_resident_csrc(src, dst, v):
                    jobs.append((m, v, dst))
                else:
                    print(f"{m} {v}: not in {src}'s generic2d_resident, "
                          "skipped")
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda j: build_cut(j[2], j[0]), jobs))
        libs = {}
        try:
            for (m, v, _), (path, report) in zip(jobs, built):
                libs.setdefault(m, {})[v] = _entry(m, path, False)
                print(f"{m} {v} ({src}):")
                for line in ptxas_lines(report):
                    if "resident" in line:
                        print(f"  ptxas: {line}")
            for m in models:
                lat, steps = resident_lattice(m)
                time_resident(lat, libs[m], steps)
        finally:
            gk._LIB.clear()
    print(import_chip_smoke().card_line())
    return 0


def cut_main(src: pathlib.Path, models) -> int:
    """Time ``generic2d_step`` of ``src``'s builds of ``models`` in the
    forward variants ``cut_variants`` names (flavours ``CUT_FLAVOURS``, at
    1024x1024) and, for an adjoint header, ``generic2d_step_b`` in
    ``"full"`` and the reverse variants on its path's lattice
    (``step_b_lattice``)."""
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for m in models:
            for i, v in enumerate(cut_variants(m)):
                dst = pathlib.Path(tmp) / f"{m}_{i}"
                if cut_csrc(src, dst, m, v):
                    jobs.append((m, v, dst))
                else:
                    print(f"{m} {v}: nothing in {src} to cut, skipped")
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda j: build_cut(j[2], j[0]), jobs))
        libs = {}
        try:
            for (m, v, _), (path, report) in zip(jobs, built):
                libs.setdefault(m, {})[v] = _entry(m, path, False)
                print(f"{m} {v} ({src}):")
                for line in ptxas_lines(report):
                    print(f"  ptxas: {line}")
            for m in models:
                forward = {v: e for v, e in libs[m].items()
                           if v not in REVERSE_CUTS}
                flavours = [f for f in CUT_FLAVOURS if "globals" not in f
                            or gk.DEVICE_MODELS[m].globals_]
                time_steps(timed_lattice(m), forward, flavours)
                if gk.DEVICE_MODELS[m].adjoint:
                    time_step_b(step_b_lattice(m), {
                        v: libs[m][v] for v in ("full",) + REVERSE_CUTS})
        finally:
            gk._LIB.clear()
    print(import_chip_smoke().card_line())
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv == ["--cut"]:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("generic2d_parity: needs a CUDA card", file=sys.stderr)
        return 2
    if argv[:2] == ["--cut", "--resident"] and len(argv) > 2:
        return cut_resident_main(pathlib.Path(argv[2]).resolve(),
                                 list(argv[3:]) or list(RESIDENT_CUT_MODELS))
    if argv[0] == "--cut":
        return cut_main(pathlib.Path(argv[1]).resolve(),
                        list(argv[2:]) or list(CUT_MODELS))
    from tclb_tpu_torch.models import get_model
    other = pathlib.Path(argv[0]).resolve()
    models = [m for m, dm in gk.DEVICE_MODELS.items()
              if dm.ndim == 2 and (other / dm.header).is_file()
              and (m in argv[1:] or len(argv) == 1)]
    this_csrc, this_build = cb.CSRC, cb.BUILD_DIR
    same = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            libs = {"this": load(this_csrc, this_build, models),
                    "other": load(other, pathlib.Path(tmp), models)}
            for m in models:
                for shape in SHAPES:
                    lat = with_series(paint(get_model(m), shape))
                    outs = {}
                    for tag, entries in libs.items():
                        gk._LIB[m] = entries[m]
                        outs[tag] = run(lat)
                    for name, got in outs["this"][0].items():
                        equal = torch.equal(got, outs["other"][0][name])
                        print(f"{m} {name} {shape}: "
                              f"{'bit-identical' if equal else 'DIFFERS'}")
                        same &= equal
                    gk._LIB[m] = libs["this"][m]
                    again = run(lat)[1]
                    for name, got in outs["this"][1].items():
                        want = outs["other"][1][name]
                        close = torch.allclose(got, want, equal_nan=True,
                                               **GLOBALS_TOL)
                        rerun = torch.equal(got.view(torch.int32),
                                            again[name].view(torch.int32))
                        print(f"{m} {name} {shape} globals: "
                              f"{got.tolist()} against {want.tolist()}: "
                              f"{'within' if close else 'OUTSIDE'} "
                              f"{TOL_TEXT}, "
                              f"{'the same' if rerun else 'NOT the same'}"
                              " run to run")
                        same &= close and rerun
                pair = {tag: entries[m] for tag, entries in libs.items()}
                for shape in RESIDENT_SHAPES:
                    lat = paint(get_model(m), shape)
                    for nsteps in RESIDENT_STEPS:
                        same &= hold_resident(lat, pair, nsteps)
                lat, nsteps = resident_lattice(m)
                same &= hold_resident(lat, pair, nsteps)
                for bf16 in (False, True):
                    same &= time_resident(lat, pair, nsteps, compare=True,
                                          bf16=bf16)[1]
                same &= time_steps(timed_lattice(m), pair, compare=True)[1]
                if m == "d2q9_kuper":
                    split_drop(pair)
                if m == "d2q9":
                    flagship_windows(pair)
                if gk.DEVICE_MODELS[m].adjoint:
                    same &= time_step_b(step_b_lattice(m), pair,
                                        compare=True)[1]
    finally:
        gk._LIB.clear()
        cb.CSRC, cb.BUILD_DIR = this_csrc, this_build
    print("generic2d_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
