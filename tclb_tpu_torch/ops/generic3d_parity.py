"""Hold this checkout's builds of ``csrc/generic3d.cu`` against another copy
of ``csrc/`` (a parent commit's, say) on one CUDA card, bit for bit.

    python -m tclb_tpu_torch.ops.generic3d_parity OTHER/tclb_tpu_torch/csrc

The 3D counterpart of ``ops/generic2d_parity.py``.  For each 3D model with
a device header in both copies, both copies are built alike
(``ops/_cuda_build.py``: nvcc for sm_90a, ``--fmad=false``, the model's
header pre-included, ``-Xptxas -v``; the other copy into a scratch
directory, one ``nvcc`` a library, started together).  The script prints
both compiler reports (registers and spills per kernel), runs each kernel
of both libraries on the same inputs (every node type of the model's
header painted, zone 1 on the upper half in z with its own zonal values,
1% noise on the initial planes, at 9x13x37 and 32x64x128):
``generic3d_step`` in all four flavours (plain, globals, and under a
series of the first zonal setting on zone 1 the series and series +
globals flavours) and, where the header defines ``TCLB_MODEL_ADJOINT``,
``generic3d_step_b`` on seeded cotangents, and exits nonzero unless every
output is bit for bit the same.

A copy of ``csrc/`` from before the multi-pass template (no
``generic3d_plan`` export: its ``generic3d_step`` and
``generic3d_step_series`` take no scratch stack) is bound through
:class:`NoScratchStep3`, which drops the scratch stack the wrapper passes.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import sys
import tempfile

import numpy as np
import torch

from tclb_tpu_torch.ops import _cuda_build as cb
from tclb_tpu_torch.ops import generic3d_kernels as g3
from tclb_tpu_torch.ops import generic_kernels as gk

SHAPES = ((9, 13, 37), (32, 64, 128))


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


def series_of(lat):
    """The lattice's inputs under a series (horizon 5) of its first zonal
    setting on zone 1 (the same series on every call)."""
    m = lat.model
    name = m.zonal_settings[0]
    v = float(lat.params.zone_table[m.setting_index[name], 1])
    lat.set_setting_series(name, [v * (1 + 0.1 * k) + 0.001 * k
                                  for k in range(5)], zone=1)
    return gk.series_inputs(m, lat.params)


def run(lat) -> dict:
    """Every kernel of the model's library on the lattice's state, as
    int32 bits."""
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


class NoScratchStep3:
    """A library from before the multi-pass template (no ``generic3d_plan``
    export): its step entries take the wrapper's arguments without the
    scratch stack ``mid``, which is dropped here, and it runs one stage;
    every other entry is the library's own."""

    def __init__(self, lib: ctypes.CDLL, model: str):
        self._lib = lib
        p, i = ctypes.c_void_p, ctypes.c_int
        argp = ctypes.POINTER(gk.c_args_type(model))
        lib.generic3d_step.argtypes = [p, p, p, p, argp, p, p, i, p]
        lib.generic3d_step_series.argtypes = [p, p, p, p, argp, p, p, i, i,
                                              p, p, i, p]

    def generic3d_plan(self, n_stages) -> None:
        n_stages._obj.value = 1

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name in ("generic3d_step", "generic3d_step_series"):
            return lambda fin, fout, mid, *rest: fn(fin, fout, *rest)
        return fn


def _entry(model: str, path: pathlib.Path) -> dict:
    """``g3._LIB[model]`` for the library at ``path``, bound as ``g3.lib``
    binds it (through :class:`NoScratchStep3` where the library has no
    ``generic3d_plan``)."""
    raw = ctypes.CDLL(str(path))
    if hasattr(raw, "generic3d_plan"):
        g3._LIB.pop(model, None)
        real = g3.build
        try:
            g3.build = lambda m: (path, "")
            g3.lib(model)
        finally:
            g3.build = real
        return dict(g3._LIB[model])
    lib = NoScratchStep3(raw, model)
    p, i = ctypes.c_void_p, ctypes.c_int
    argp = ctypes.POINTER(gk.c_args_type(model))
    raw.generic_error_string.argtypes = [i]
    raw.generic_error_string.restype = ctypes.c_char_p
    raw.generic3d_step.restype = i
    raw.generic3d_step_series.restype = i
    if gk.DEVICE_MODELS[model].adjoint:
        raw.generic3d_step_b.argtypes = [p, p, p, p, argp, p, p, p, p, p, i,
                                         p]
        raw.generic3d_step_b.restype = i
    return {"lib": lib, "block": (8, 32), "passes": 1}


def load(csrc: pathlib.Path, build_dir: pathlib.Path, models) -> dict:
    """Each model's library entry (``g3._LIB[model]``) built from ``csrc``
    (one ``nvcc`` a model, started together), and print its compiler
    report."""
    cb.CSRC, cb.BUILD_DIR = csrc, build_dir
    with concurrent.futures.ThreadPoolExecutor(len(models)) as pool:
        built = list(pool.map(gk.build, models))
    out = {}
    for m, (path, report) in zip(models, built):
        out[m] = _entry(m, path)
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
        print("generic3d_parity: needs a CUDA card", file=sys.stderr)
        return 2
    from tclb_tpu_torch.models import get_model
    other = pathlib.Path(argv[0]).resolve()
    models = [m for m, dm in gk.DEVICE_MODELS.items()
              if dm.ndim == 3 and (other / dm.header).is_file()]
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
                        g3._LIB[m] = entries[m]
                        outs[tag] = run(lat)
                    for name, got in outs["this"].items():
                        equal = torch.equal(got, outs["other"][name])
                        print(f"{m} {name} {shape}: "
                              f"{'bit-identical' if equal else 'DIFFERS'}")
                        same &= equal
    finally:
        g3._LIB.clear()
        cb.CSRC, cb.BUILD_DIR = this_csrc, this_build
    print("generic3d_parity: " + ("ok" if same else "FAILED"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
