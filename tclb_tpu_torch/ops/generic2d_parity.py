"""Hold this checkout's builds of ``csrc/generic2d.cu`` against another
copy of ``csrc/`` (a parent commit's, say) on one CUDA card, bit for bit.

    python -m tclb_tpu_torch.ops.generic2d_parity OTHER/tclb_tpu_torch/csrc

For each 2D model with a device header in both copies, both copies are
built alike (``ops/_cuda_build.py``: nvcc for sm_90a, ``--fmad=false``,
the model's header pre-included, ``-Xptxas -v``; the other copy into a
scratch directory).  The script prints both compiler reports (registers
and spills per kernel), runs each kernel of both libraries on the same
inputs (every node type of the model's header painted, two zones, 1%
noise on the initial populations, at 37x53 and 256x256):
``generic2d_step`` in both flavours, an 8-step ``generic2d_resident``,
``generic2d_step_bf16`` on the shifted bf16 stack and, where the header
defines ``TCLB_MODEL_ADJOINT``, ``generic2d_step_b`` on seeded
cotangents, and exits nonzero unless every output is bit for bit the
same.  A change to the model-independent templates (``generic2d.cu``,
``generic_common.cuh``, ``storage.cuh``, ``generic2d_adjoint.cuh``) is
held this way against the parent's builds.

A copy of ``csrc/`` from before the backward read zonal settings (no
``generic2d_step_b_zonal`` export: its ``generic2d_step_b`` takes no zone
table) is bound through :class:`NoZoneTableStepB`, which drops the zone
table the wrapper passes.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import pathlib
import sys
import tempfile

import numpy as np
import torch

from tclb_tpu_torch.core import shift as ddf
from tclb_tpu_torch.ops import _cuda_build as cb
from tclb_tpu_torch.ops import generic_kernels as gk

SHAPES = ((37, 53), (256, 256))


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


def run(lat) -> dict:
    """Every kernel of the model's library on the lattice's state, as
    int32 bits."""
    m = lat.model
    f, flags, ztab, a = gk.kernel_inputs(m, lat.state, lat.params)
    g = gk.step_globals(f, flags, ztab, a)
    out = {"step": gk.step(f, flags, ztab, a),
           "step_globals": torch.cat([g[0].flatten(), g[1]]),
           "resident": gk.resident(f, flags, ztab, a, 8)}
    shift = ddf.kernel_shift(m, "shifted")
    fb = ddf.narrow_stack(f, torch.bfloat16, ddf.stack_shift(m, "shifted"))
    ab = dataclasses.replace(a, shift=shift)
    out["step_bf16"] = gk.step(fb, flags, ztab, ab).view(torch.int16)
    if gk.DEVICE_MODELS[m.name].adjoint:
        from tclb_tpu_torch.ops import adjoint_kernels as ak
        gen = torch.Generator(device=f.device).manual_seed(11)
        lam = torch.randn(f.shape, generator=gen, device=f.device)
        lam_g = torch.randn((m.n_globals,), generator=gen, device=f.device)
        lam_in, sett = ak.step_b(f, flags, ztab, a, lam, lam_g)
        out["step_b"] = lam_in
        out["step_b_settings"] = sett.view(torch.int64)
    if f.is_cuda:
        torch.cuda.synchronize()
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in out.items()}


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


def _entry(model: str) -> dict:
    """``gk._LIB[model]`` for the library ``gk.lib`` builds, its
    ``generic2d_step_b`` bound through :class:`NoZoneTableStepB` where the
    library has no ``generic2d_step_b_zonal``."""
    gk.lib(model)
    entry = dict(gk._LIB[model])
    if "tile_b" in entry and not hasattr(entry["lib"],
                                         "generic2d_step_b_zonal"):
        entry["lib"] = NoZoneTableStepB(entry["lib"], model)
    return entry


def load(csrc: pathlib.Path, build_dir: pathlib.Path, models) -> dict:
    """Each model's library entry (``gk._LIB[model]``) built from ``csrc``
    (one ``nvcc`` a model, started together), and print its compiler
    report."""
    cb.CSRC, cb.BUILD_DIR = csrc, build_dir
    gk._LIB.clear()
    with concurrent.futures.ThreadPoolExecutor(len(models)) as pool:
        built = list(pool.map(gk.build, models))
    out = {}
    for m, (path, report) in zip(models, built):
        out[m] = _entry(m)
        print(f"{m} ({path.name} from {csrc}):")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("generic2d_parity: needs a CUDA card", file=sys.stderr)
        return 2
    from tclb_tpu_torch.models import get_model
    other = pathlib.Path(argv[0]).resolve()
    models = [m for m, dm in gk.DEVICE_MODELS.items()
              if dm.ndim == 2 and (other / dm.header).is_file()]
    this_csrc, this_build = cb.CSRC, cb.BUILD_DIR
    same = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            libs = {"this": load(this_csrc, this_build, models),
                    "other": load(other, pathlib.Path(tmp), models)}
            for m in models:
                for shape in SHAPES:
                    lat = paint(get_model(m), shape)
                    outs = {}
                    for tag, entries in libs.items():
                        gk._LIB[m] = entries[m]
                        outs[tag] = run(lat)
                    for name, got in outs["this"].items():
                        equal = torch.equal(got, outs["other"][name])
                        print(f"{m} {name} {shape}: "
                              f"{'bit-identical' if equal else 'DIFFERS'}")
                        same &= equal
    finally:
        gk._LIB.clear()
        cb.CSRC, cb.BUILD_DIR = this_csrc, this_build
    print("generic2d_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
