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
``generic2d_step`` in both flavours, an 8-step ``generic2d_resident``
and ``generic2d_step_bf16`` on the shifted bf16 stack, and exits nonzero
unless every output is bit for bit the same.  A change to the
model-independent templates (``generic2d.cu``, ``generic_common.cuh``,
``storage.cuh``) is held this way against the parent's builds.
"""

from __future__ import annotations

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


def paint(model, shape, seed: int = 5, device: str = "cuda"):
    """A lattice (on the card) with every node type ``model``'s header reads:
    the collision type inside, each boundary type in a column of its own,
    each other type in a patch, zone 1 on the lower half; Init, then 1%
    noise on every plane."""
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
            flags[ny // 4:ny // 2, x:x + 2] |= np.uint16(model.flag_for(name))
    flags[0, :] = flags[-1, :] = model.flag_for("Wall")
    flags[ny // 2:, :] |= np.uint16(1 << model.zone_shift)
    lat = Lattice(model, shape, dtype=torch.float32, device=device)
    lat.set_flags(flags)
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
    if f.is_cuda:
        torch.cuda.synchronize()
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in out.items()}


def load(csrc: pathlib.Path, build_dir: pathlib.Path, models) -> dict:
    """Each model's library entry (``gk._LIB[model]``) built from ``csrc``,
    and print its compiler report."""
    cb.CSRC, cb.BUILD_DIR = csrc, build_dir
    gk._LIB.clear()
    out = {}
    for m in models:
        path, report = gk.build(m)
        gk.lib(m)
        out[m] = dict(gk._LIB[m])
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
