#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA card and ``nvcc`` (it
builds ``tclb_tpu_torch/csrc/d2q9.cu`` for d2q9 and once for each of the
five d2q9-family models (``-DD2Q9_MODEL``), ``d3q27.cu`` for
d3q27_cumulant and once for each of d3q27_BGK, d3q27_BGK_galcor, d3q19 and
d3q19_les (``-DD3Q_MODEL``), ``generic2d.cu``
once for each of d2q9 (``csrc/models/d2q9.cuh``), d2q9_kuper and
d2q9_heat_adj, the latter with the
backward kernel of ``generic2d_adjoint.cuh``, and ``generic3d.cu`` for
d3q19_adj with the backward kernel of ``generic3d_adjoint.cuh``, for
sm_90a into ``build/``, one ``nvcc`` each, started together), and exits
nonzero without printing a result when either the card or the package is
missing.  Phases, each of which fails the run on its own:

1. build the d2q9 library and the five family libraries, the five d3q27
   libraries, the two generic 2D and the generic 3D libraries and print
   what ``ptxas`` reports;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the paths give it (the Karman state for ``d2q9_resident8`` and
   ``d2q9_step``, the 1024x1024 channel state for ``d2q9_step2`` and
   ``d2q9_step``, the warmed ``example/3d_channel.xml`` state and a
   12x8x64 state that paints every d3q27 node type for ``d3q27_step`` and
   ``d3q27_step2``, the warmed ``example/drop.xml`` state, bench.py's
   1024x1024 drop and a walled 16x128 kuper state that paints every
   d2q9_kuper node type and two Density zones for ``generic2d_step``, its
   globals flavour and an 8-step ``generic2d_resident``, and after phases
   6 and 9 the developed 3d_channel and drop flows), d2q9_heat_adj's
   ``generic2d_step``, its globals flavour and an 8-step
   ``generic2d_resident`` on a 64x32 state that paints every node type
   the model reads and on bench.py's 512x1024 heat_adj channel, at rtol
   2e-5 / atol 2e-6, and the globals flavour's globals at rtol 1e-4 /
   atol 1e-6; ``generic2d_step_b`` against ``step_b_plain`` on the same two
   d2q9_heat_adj states (and after phase 12 the developed channel),
   lam_in at rtol 1e-4 / atol 1e-6 and the settings cotangent at rtol
   1e-4; d3q19_adj's ``generic3d_step`` (both flavours) and
   ``generic3d_step_b`` at the same tolerances on an 8x16x32 state that
   paints every node type the model reads, two zones and ``w`` in (0, 1),
   on the 32x64x256 case state of phase 13, and after phase 13 on its
   developed state after the Solve; each d2q9-family model's branch of
   ``d2q9_step``, ``d2q9_step2`` and ``d2q9_resident8`` on a 32x64 state
   that paints every node type the model reads (two zones, gravity,
   d2q9_new's Smagorinsky and Stab nodes), on its paths' starting states
   and, after phases 15-19, on their developed states; each z-slab family
   model's branch of ``d3q27_step`` and ``d3q27_step2`` on a 12x8x64 state
   that paints every node type the model reads (two zones, gravity), on
   its 48x48x256 channel's starting state and, after phase 21, on its
   developed state, and the cumulant's two kernels on the
   3dcum_turbulence state with SynthT planes that are not zero (and after
   phase 20);
3. hold the card's f32 run of the d2q9 golden cases
   (``tests/goldens/karman.json``, ``poiseuille.json``), of the
   d3q27_cumulant channel (``channel3d.json``), of the d2q9_kuper drop
   (``drop.json``) and of d2q9_heat_adj (``heat_adj.json``, with its
   gradient columns on ``cuda_adjoint``) against the goldens at rtol 1e-4
   / atol 1e-6 (f32 against an f64 recording);
4. the d2q9 main path: ``example/karman.xml`` unchanged through
   ``run_config`` (10000 iterations, Log every 1000, VTK every 5000) on
   ``cuda_d2q9_resident[d2q9,fuse=8]``, with the launch counts set to 0
   just before and read just after;
5. the d2q9 band engine: the 1024x1024 d2q9 channel of ``bench.py``,
   ``iterate(2002)`` on ``cuda_d2q9_band[d2q9,fuse=2]``, counted the same
   way;
6. the 3D main path: ``example/3d_channel.xml`` unchanged through
   ``run_config`` (48x48x256, 20000 iterations, Log every 2000, VTK every
   10000) on ``cuda_d3q27_band[d3q27_cumulant,fuse=2]``, counted the same
   way, with its MLUPS and the eager globals step's time;
7. kernel times (CUDA events over many launches), the plain versions'
   times, each kernel's bound on this card, and the host time one call of
   each wrapper takes;
8. torch.profiler traces of a karman, a 3d_channel and a drop ``iterate``
   window: the card's busy and idle share and its time by kernel;
9. the generic main path: ``example/drop.xml`` unchanged through
   ``run_config`` (128x128, 6000 iterations, Log every 500, VTK every
   2000) on ``cuda_generic_resident[d2q9_kuper,fuse=N]``, launching both
   generic kernels and no eager step, with its mass conserved to 1e-4 and
   the vapour bubble still at the centre;
10. the generic band engine: bench.py's drop physics at 1024x1024,
   ``iterate(2000)`` on ``cuda_generic_band[d2q9_kuper,fuse=1]``, both
   flavours of ``generic2d_step`` launched;
11. the adjoint main path: ``example/heat_adj.xml`` unchanged through
   ``run_config`` (64x32, Solve 4000 on
   ``cuda_generic_resident[d2q9_heat_adj,fuse=N]``, FDTest 8/3 and a
   10-evaluation MMA Optimize of 100 iterations on
   ``cuda_adjoint[d2q9_heat_adj,k=1]``, ThresholdNow, VTK): the launch
   counts, the FDTest records (logged), each objective (finite), the
   material constraint, a binary design; then the first evaluation's f32
   kernel gradient against an f64 eager gradient on the card (relative L2
   at most 1e-3);
12. bench.py's heat_adj channel at 512x1024: ``iterate(2000)`` on
   ``cuda_generic_band[d2q9_heat_adj,fuse=1]``, an 8-step kernel gradient
   against f32 eager autograd at rtol 1e-4 / atol 1e-7, and a 1000-step
   gradient with automatic checkpoint levels (2): its wall time, rate,
   peak memory and launches;
13. the 3D adjoint path: the d3q19_adj case XML
   (``tests/torch_cases.py:adj3d_case_xml`` at 32x64x256) through
   ``run_config``: Solve 2000 on ``cuda_generic3d_band[d3q19_adj,fuse=1]``,
   FDTest 8/3 and an MMA Optimize of 5 evaluations of 200 iterations on
   ``cuda_adjoint3d[d3q19_adj,k=1]``, ThresholdNow, VTK; the launch
   counts, each objective (finite), the material constraint, a binary
   design block; then the first evaluation's f32 kernel gradient against
   an f64 eager gradient on the card (relative L2 at most 1e-3) and an
   8-step f64 central-difference check at three components inside the
   design block;
14. bench.py's 3D adjoint case (``bench_adjoint3d``, 32x64x256):
   ``iterate(2000)`` on the band engine, an 8-step kernel gradient
   against f32 eager autograd at rtol 1e-4 / atol 1e-7, the 200-step
   gradient's wall time and rate, and a 1000-step gradient at 64x128x256
   with automatic checkpoint levels (2): its wall time, rate, ratio to
   1000 primal steps, peak memory and launches.

15. ``example/cumulant2d.xml`` unchanged through ``run_config``
   (d2q9_cumulant, 1024x128, 8000 iterations, Log every 1000) on
   ``cuda_d2q9_resident[d2q9_cumulant,fuse=8]``, counted from 0, its Log
   columns finite, one eager (globals) step per iterate call;
16. bench.py's d2q9_cumulant channel (bench.py:194-207, 1024x1024):
   ``iterate(2002)`` on ``cuda_d2q9_band[d2q9_cumulant,fuse=2]``;
17. ``example/les_channel.xml`` unchanged (d2q9_les, 512x96, 8000
   iterations) on the resident engine;
18. BASELINE config 2: ``example/poiseuille.xml`` on d2q9_SRT
   (``tests/torch_cases.py:srt_poiseuille_xml``) on the resident engine,
   its final ux profile against the same case on the eager engine on the
   card, in f32 at rtol 2e-5 / atol 2e-6 and in f64 within a relative L2
   error of 1e-3;
19. bench.py's channel at 1024x1024 for d2q9_SRT, d2q9_les, d2q9_inc and
   d2q9_new (``iterate(2002)`` on the band engine), and at 128x1024 for
   d2q9_inc and d2q9_new (the resident engine), so that every family
   branch of every kernel runs on a path;
20. path A: ``example/3dcum_turbulence.xml`` unchanged through
   ``run_config`` (d3q27_cumulant, 128x32x32, a ``WVelocityTurbulent``
   inlet fed by ``<SyntheticTurbulence>``, 1000 iterations, Log every 200)
   on ``cuda_d3q27_band[d3q27_cumulant,fuse=2]``, counted from 0: finite
   fields, SynthT planes that change between the Solve's segments, an
   inlet whose ux fluctuates, the MLUPS over the whole case;
21. path B: bench.py's 3D channel (bench.py:619-662, 48x48x256, walls at
   y = 0 and y = ny - 1, a body force along x) for d3q27_BGK,
   d3q27_BGK_galcor, d3q19 and d3q19_les, ``iterate(2002)`` on
   ``cuda_d3q27_band[<model>,fuse=2]``: the launches by kernel and the
   MLUPS;
22. tests/test_models.py's 3D Poiseuille for d3q19 and d3q27_BGK on the
   kernels in f32: the ux profile against the f32 eager engine at rtol
   2e-5 / atol 2e-6, against the f64 eager engine (relative L2, see
   ``check_d3q_poiseuille``) and the analytic profile (3%);
23. path A of the <Control> slice: ``example/karman_control.xml``
   unchanged through ``run_config`` (d2q9, 512x96, a ``<Control>`` of
   4000 iterations reading ``example/inlet_ramp.csv`` into the inlet
   zone's Velocity, Log every 500, Solve 4000) on
   ``cuda_generic_band[d2q9,fuse=1]``, counted from 0: no eager step,
   ``generic2d_step_series`` on every step but the last of each iterate
   call, which is ``generic2d_step_series_globals``, no plain launch;
   every Log column and the final fields against the same XML on the
   eager f32 engine at rtol 1e-4 / atol 1e-6; the inlet's ux at each Log
   equal to the series' entry of the step before and changing as the
   ramp does; the MLUPS of the whole case and of an ``iterate(500)``
   window;
24. path B: the 3D Control channel (``tests/torch_cases.py:
   adj3d_control_xml`` at 32x64x256: the 3D adjoint case's geometry and
   settings, a forward Solve of 2000 under a ``<Control>`` ramp of the
   inlet zone's Velocity, Log every 500) on
   ``cuda_generic3d_band[d3q19_adj,fuse=1]``, held the same way;
25. path C: ``<Sample what="U,Rho">`` of three points on
   karman_control.xml's lattice (500 iterations), every step eager by
   selection (no kernel launched), its CSV against the same case stepped
   one iteration at a time on the kernel engine at rtol 1e-4 / atol 1e-6.

26. the storage ladder's bf16 kernels against their plain versions on the
   card, in both representations (raw, shifted): ``generic2d_step_bf16``
   (both flavours) for d2q9 and d2q9_kuper at 1024x1024 and 96x512,
   ``generic2d_resident_bf16`` for the two harness cases at 64x64, and
   ``d3q27_step_bf16``/``d3q27_step2_bf16`` for d3q27_cumulant (a rich
   48x48x256 state with nonzero SynthT planes, the developed 3d_channel
   and 3dcum_turbulence states) and for the four other z-slab models (the
   developed 48x48x256 channels).  A kernel that narrows once a launch is
   held to the f32 tolerance (rtol 2e-5 / atol 2e-6 on the raw values)
   carried through its narrowing (``core/shift.py:narrowed_bounds``); the
   resident kernel equals as many chained ``generic2d_step_bf16`` launches
   bit for bit, each launch of that chain held so against its plain
   version from the same input, and, for d2q9_kuper, the resident kernel
   also equals its plain version from the start at the f32 tolerance;
27. the precision harness (``tclb_tpu_torch.precision``) on the kernels:
   both cases, both representations, 64x64, 500 steps, within
   ``ERROR_BOUNDS``, the shifted cavity's u_linf at least 10x below raw's;
28. bench.py's bf16 flagship (bench.py:818-870: d2q9 1024x1024, walls top
   and bottom): f32 on K1/K2, f32 on K4, bf16 shifted and bf16 raw on K4,
   MLUPS over ``iterate(2000)`` windows and their ratios (no floor held);
29. example/3d_channel.xml's lattice in bf16 shifted on K3 against the f32
   run of the same 20000 steps (MLUPS, U's relative L2, reported), and
   (29b) bench.py's 48x48x256 channel for each other z-slab model in bf16
   shifted;
30. bf16 shifted checkpoints on the card: bit-exact at rest, through raw
   f32 and back.

Phase 2 also holds both series flavours of ``generic2d_step`` and
``generic3d_step`` on rich states with series on two zones (horizon 5, at
iterations inside, at the end of and past it) and on the paths' states,
and d2q9's plain ``generic2d_step`` (both flavours) and
``generic2d_resident``, which no path runs (d2q9 without a series takes
``d2q9_step``/``d2q9_resident8``): their times and errors go into the
summary line, not the kernels line.

Phase 7 also times d2q9_heat_adj's kernels, ``generic2d_step_b``, the
two 3D kernels, each d2q9-family branch at its path's shape and each
z-slab family branch at 48x48x256; phase 8 also profiles the two
1000-step gradients, a cumulant2d, a 1024x1024 d2q9_cumulant, a
3dcum_turbulence and a 48x48x256 window of each z-slab family model.
Phase 7 also times the series flavours (K4's at 1024x1024 and at
512x96, K6's at 32x64x256) and d2q9's plain generic kernels; phase 8 also
profiles a karman_control ``iterate(500)`` and a 3D Control channel
``iterate(200)``.  Phases run in the order 1, 2, 3, 4, 5, 6, 9, 10, 11,
12, 13, 14, 15-19, 20-22, 23-25, 26-30, 7, 8.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
RTOL, ATOL = 2e-5, 2e-6        # kernel vs plain (tests/test_fastpath.py:69)
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-6
# generic2d_step_b against its plain version (lam_in, settings cotangent)
STEP_B_RTOL, STEP_B_ATOL, STEP_B_SETT_RTOL = 1e-4, 1e-6, 1e-4
# a kernel gradient against eager autograd, both f32
# (tests/test_pallas_adjoint.py:155)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
GRAD_F64_REL_L2 = 1e-3     # the f32 kernel gradient against f64 eager
# central differences (eps 1e-4, f64) against the f64 adjoint: the
# truncation (eps^2 times the third derivative) stays below the relative
# limit, the objective's f64 rounding over eps (|J| 1e-16 / 1e-4, about
# 1e-10 for |J| ~ 100) below the absolute one
FD_REL, FD_ATOL = 1e-4, 1e-9
# the d2q9_SRT Poiseuille's f32 ux profile after 10000 steps against f64:
# its body force enters as feq(u + g) - feq(u), two values near 0.1 that
# differ by about 1e-6 at g ~ 1e-5, so f32 on any engine carries a
# systematic error of several 1e-4 of the profile; the limit is the one
# this script holds its f32 gradients to against f64
POISEUILLE_F64_REL_L2 = GRAD_F64_REL_L2
KARMAN_XML = ROOT / "example" / "karman.xml"
CHANNEL3D_XML = ROOT / "example" / "3d_channel.xml"
DROP_XML = ROOT / "example" / "drop.xml"
HEAT_ADJ_XML = ROOT / "example" / "heat_adj.xml"
CUMULANT2D_XML = ROOT / "example" / "cumulant2d.xml"
LES_XML = ROOT / "example" / "les_channel.xml"
TURB_XML = ROOT / "example" / "3dcum_turbulence.xml"
KARMAN_CONTROL_XML = ROOT / "example" / "karman_control.xml"
DEVICE = "cuda"
TPU_KERNELS = {   # the Pallas call each CUDA kernel replaces
    "d2q9_step": "tclb_tpu/ops/pallas_d2q9.py:775",
    "d2q9_step2": "tclb_tpu/ops/pallas_d2q9.py:756",
    "d2q9_resident8": "tclb_tpu/ops/pallas_d2q9.py:302",
    "d3q27_step": "tclb_tpu/ops/pallas_d3q.py:655",
    "d3q27_step2": "tclb_tpu/ops/pallas_d3q.py:843",
    "generic2d_step": "tclb_tpu/ops/pallas_generic.py:796",
    "generic2d_resident": "tclb_tpu/ops/pallas_generic.py:1105",
    "generic2d_step_b": "tclb_tpu/ops/pallas_adjoint.py:905",
    "generic3d_step": "tclb_tpu/ops/pallas_generic.py:1528",
    "generic3d_step_b": "tclb_tpu/ops/pallas_adjoint.py:634",
    # the <Control> series flavours: call_s and call_sg of the same functions
    "generic2d_step_series": "tclb_tpu/ops/pallas_generic.py:838",
    "generic2d_step_series_globals": "tclb_tpu/ops/pallas_generic.py:839",
    "generic3d_step_series": "tclb_tpu/ops/pallas_generic.py:1558",
    "generic3d_step_series_globals": "tclb_tpu/ops/pallas_generic.py:1559",
}
# the d2q9 family's branches of the three d2q9 kernels replace the family
# branches of the same Pallas calls (pallas_d2q9.py:136, :535-584)
FAMILY_2D = ("d2q9_SRT", "d2q9_les", "d2q9_inc", "d2q9_cumulant",
             "d2q9_new")
TPU_KERNELS.update({f"{name}[{m}]": TPU_KERNELS[name] for m in FAMILY_2D
                    for name in ("d2q9_step", "d2q9_step2",
                                 "d2q9_resident8")})
SOURCES = {"d2q9": "d2q9.cu", "d3q27": "d3q27.cu", "generic": "generic2d.cu",
           "adjoint": "generic2d_adjoint.cuh", "generic3d": "generic3d.cu",
           "adjoint3d": "generic3d_adjoint.cuh"}
GENERIC_MODELS = ("d2q9", "d2q9_kuper", "d2q9_heat_adj", "d3q19_adj")
# the rest of the z-slab family on the d3q27 kernels (phases 20-22)
D3Q_FAMILY = ("d3q27_BGK", "d3q27_BGK_galcor", "d3q19", "d3q19_les")
CHANNEL48 = (48, 48, 256)      # bench.py:619-662's 3D channel
# the 3D adjoint case's handlers (phase 13)
ADJ3D_HANDLERS = ("Solve", "FDTest", "Optimize", "ThresholdNow", "VTK")
GOLDEN_MODELS = {"karman": "d2q9", "poiseuille": "d2q9",
                 "channel3d": "d3q27_cumulant", "drop": "d2q9_kuper",
                 "heat_adj": "d2q9_heat_adj"}


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# states at the path's shapes
# --------------------------------------------------------------------------- #


def case_lattice(xml, dtype, device, drop=("Solve", "Log", "VTK")):
    """An example case's lattice after running it without the elements
    ``drop`` names (by default: painted and initialised)."""
    from tclb_tpu_torch.control.solver import _run_root
    from tclb_tpu_torch.models import get_model
    root = ET.parse(xml).getroot()
    for tag in drop:
        for el in root.findall(tag):
            root.remove(el)
    cwd = os.getcwd()
    with case_dir() as out:
        os.chdir(out)    # the XML's own output= prefix is relative
        try:
            solver = _run_root(root, get_model(root.get("model")), None,
                               dtype, out + "/", "case_state", device=device)
        finally:
            os.chdir(cwd)
    return solver.lattice


def case_dir() -> tempfile.TemporaryDirectory:
    """A temporary working directory for a case: an XML's output= prefix
    is relative, and so is karman_control.xml's CSV
    (example/inlet_ramp.csv), so ``example`` there links to the
    checkout's."""
    tmp = tempfile.TemporaryDirectory()
    os.symlink(ROOT / "example", os.path.join(tmp.name, "example"))
    return tmp


def rich3d_lattice(device):
    """A 12x8x64 d3q27_cumulant state that paints every node type, with
    nonzero SynthT planes and a Buffer layer (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import RICH3D_SETTINGS, SHAPE3D, paint_rich_3d
    lat = Lattice(get_model("d3q27_cumulant"), SHAPE3D, dtype=torch.float32,
                  device=device, settings=RICH3D_SETTINGS)
    return paint_rich_3d(lat, seed=5)


def channel_lattice(device, n=1024):
    """bench.py's d2q9 channel (bench.py:154-167)."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9")
    lat = Lattice(m, (n, n), dtype=torch.float32, device=device,
                  settings={"nu": 0.02, "Velocity": 0.01})
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT")
    flags[:, -1] = m.flag_for("EPressure", "MRT")
    flags[0, :] = m.flag_for("Wall")
    flags[-1, :] = m.flag_for("Wall")
    flags[n // 3:2 * n // 3, n // 10:n // 5] = m.flag_for("Wall")
    flags[1:-1, 2] = m.flag_for("MRT", "Inlet")
    flags[1:-1, -3] = m.flag_for("MRT", "Outlet")
    lat.set_flags(flags)
    lat.init()
    return lat


def drop_lattice(device, n=1024):
    """bench.py's drop physics (bench.py:290-306): a vapour disc of radius
    n/5 (zone 1) in the liquid, periodic."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9_kuper")
    lat = Lattice(m, (n, n), dtype=torch.float32, device=device,
                  settings={"omega": 1.0, "Temperature": 0.56, "FAcc": 1.0,
                            "Magic": 0.01, "MagicA": -0.152,
                            "MagicF": -2.0 / 3.0,
                            "Density": 3.2600529440452366})
    lat.set_setting("Density", 0.014500641645077492, zone=1)
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    yy, xx = np.mgrid[0:n, 0:n]
    drop = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 < (n / 5) ** 2
    flags[drop] = m.flag_for("MRT", zone=1)
    lat.set_flags(flags)
    lat.init()
    return lat


def rich_kuper_lattice(device):
    """A 16x128 d2q9_kuper state that paints every node type the model
    dispatches and two Density zones (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import KUPER_SETTINGS, KUPER_SHAPE, paint_rich_kuper
    lat = Lattice(get_model("d2q9_kuper"), KUPER_SHAPE, dtype=torch.float32,
                  device=device, settings=KUPER_SETTINGS)
    return paint_rich_kuper(lat, seed=5)


def rich_heat_lattice(device):
    """heat_adj.xml's 64x32 with every node type d2q9_heat_adj reads (W
    velocity, E pressure, walls, a solid block, an Outlet column, a
    DesignSpace block), a non-uniform design field and a ux == 0 node
    (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import HEAT_SETTINGS, HEAT_SHAPE, paint_rich_heat
    lat = Lattice(get_model("d2q9_heat_adj"), HEAT_SHAPE,
                  dtype=torch.float32, device=device, settings=HEAT_SETTINGS)
    return paint_rich_heat(lat, seed=5)


def heat1024_lattice(device, ny=512, nx=1024):
    """bench.py's heat_adj channel (bench.py:314-331) with a W velocity
    inlet, an E pressure outlet and bench.py:357-361's DesignSpace block;
    Drag is the objective (phase 12 sets w = 0.8 on the block)."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9_heat_adj")
    lat = Lattice(m, (ny, nx), dtype=torch.float32, device=device,
                  settings={"nu": 0.05, "InletVelocity": 0.02,
                            "FluidAlfa": 0.05, "DragInObj": 1.0})
    flags = np.full((ny, nx), m.flag_for("MRT"), dtype=np.uint16)
    flags[:, 0] = m.flag_for("WVelocity", "MRT")
    flags[:, -1] = m.flag_for("EPressure", "MRT")
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    flags[128:384, 300:700] |= np.uint16(m.flag_for("DesignSpace"))
    lat.set_flags(flags)
    lat.init()
    return lat


def eager_warm(lat, steps: int) -> None:
    """Advance on the eager engine so the state carries flow, not just
    the initial equilibrium."""
    lat.state = lat._iterate(lat.state, lat.params, steps)
    lat.synchronize()


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def compare(got, want, what: str, rtol: float = RTOL,
            atol: float = ATOL) -> dict:
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    finite = bool(torch.isfinite(got).all())
    say(f"  {what}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
        f"(rtol {rtol} atol {atol}) {'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        fail(f"{what} disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


def check_kernels(cases, errs: dict, what: str) -> dict:
    """Each kernel against its plain version on the same inputs;
    ``cases`` lists (kernel module, lattice, kernel name).  ``errs`` keeps
    each kernel's largest error over every call."""
    say(f"{what}: kernels against their plain versions on the card")
    for dk, lat, name in cases:
        fn, n = dk.WRAPPERS[name]
        *inputs, a = dk.kernel_inputs(lat.model, lat.state, lat.params)
        got = fn(*inputs, a)
        want = dk.plain_steps(*inputs, a, n)
        f = inputs[0]
        torch.cuda.synchronize()
        key = kernel_key(dk, name, lat)
        e = compare(got, want, f"{key} at {tuple(f.shape)}")
        keep_worst(errs, key, e)
    return errs


def kernel_key(dk, name: str, lat) -> str:
    """A kernel's name in the record: the generic kernels, and the d2q9
    and d3q27 kernels' family branches, are built once per model, so
    theirs carries the model."""
    if hasattr(dk, "launch_key"):
        return dk.launch_key(name, lat.model.name)
    return f"{name}[{lat.model.name}]" \
        if "generic" in dk.__name__ else name


def keep_worst(errs: dict, name: str, e: dict) -> None:
    prev = errs.get(name)
    if prev is None or e["max_abs_err"] > prev["max_abs_err"]:
        errs[name] = e


def check_globals_flavour(gk, lats, errs: dict, what: str) -> dict:
    """``generic2d_step``'s (``generic3d_step``'s, with that module)
    globals flavour against its plain version: the fields at rtol 2e-5 /
    atol 2e-6 (counted with the kernel's errors) and the SUM globals at
    rtol 1e-4 / atol 1e-6."""
    name = gk.KERNELS[0]
    say(f"{what}: {name}'s globals flavour on the card")
    for lat in lats:
        *inputs, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
        got, g = gk.step_globals(*inputs, a)
        want, wg = gk.plain_steps(*inputs, a, 1, with_globals=True)
        torch.cuda.synchronize()
        shape = tuple(inputs[0].shape)
        key = kernel_key(gk, name, lat)
        keep_worst(errs, key,
                   compare(got, want, f"{key} (globals) at {shape}"))
        gerr = (g - wg).abs()
        ok = bool((gerr <= GOLDEN_ATOL + GOLDEN_RTOL * wg.abs()).all()) \
            and bool(torch.isfinite(g).all())
        say(f"  globals at {shape}: {g.tolist()} vs {wg.tolist()} (rtol "
            f"{GOLDEN_RTOL} atol {GOLDEN_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}'s globals at {shape} disagree")
        keep_worst(errs, f"{key} globals",
                   {"max_abs_err": float(gerr.max()),
                    "max_rel_err": float((gerr / wg.abs().clamp_min(1e-30))
                                         .max())})
    return errs


def check_step_b(ak, gk, lats, errs: dict, what: str) -> dict:
    """``generic2d_step_b`` (``generic3d_step_b`` for a 3D model) against
    ``step_b_plain`` (torch.func.vjp of the plain step) on the same
    inputs: lam_out and lam_g of order one from a seeded generator; lam_in
    at rtol 1e-4 / atol 1e-6, the settings cotangent at rtol 1e-4."""
    say(f"{what}: the backward kernel against its plain version on the "
        "card")
    for lat in lats:
        f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state,
                                             lat.params)
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        lam = torch.randn(f.shape, generator=gen, device=DEVICE)
        lam_g = torch.randn((lat.model.n_globals,), generator=gen,
                            device=DEVICE)
        got, gs = ak.step_b(f, flags, ztab, a, lam, lam_g)
        want, ws = ak.step_b_plain(f, flags, ztab, a, lam, lam_g)
        torch.cuda.synchronize()
        shape = tuple(f.shape)
        key = f"generic{lat.model.ndim}d_step_b[{lat.model.name}]"
        keep_worst(errs, key, compare(got, want, f"{key} lam_in at {shape}",
                                      STEP_B_RTOL, STEP_B_ATOL))
        serr = (gs - ws).abs()
        ok = bool((serr <= STEP_B_SETT_RTOL * ws.abs()).all()) \
            and bool(torch.isfinite(gs).all())
        say(f"  settings cotangent at {shape}: {gs.tolist()} vs "
            f"{ws.tolist()} (rtol {STEP_B_SETT_RTOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{key}'s settings cotangent at {shape} disagrees")
        keep_worst(errs, f"{key} settings",
                   {"max_abs_err": float(serr.max()),
                    "max_rel_err": float((serr / ws.abs().clamp_min(1e-30))
                                         .max())})
    return errs


def check_goldens() -> None:
    """The d2q9 and channel3d goldens, run on the card in f32 through the
    kernels."""
    from tclb_tpu_torch.control.solver import _run_root
    from tclb_tpu_torch.models import get_model
    say("phase 3: goldens on the card (f32 kernels vs f64 recording)")
    src = (ROOT / "tests" / "test_golden.py").read_text()
    for name, model in GOLDEN_MODELS.items():
        tag = f'{name.upper()} = """'
        start = src.index(tag) + len(tag)
        xml = src[start:src.index('"""', start)]
        golden = json.loads(
            (ROOT / "tests" / "goldens" / f"{name}.json").read_text())
        with tempfile.TemporaryDirectory() as out:
            solver = _run_root(ET.fromstring(xml.format(out=out)),
                               get_model(model), None, torch.float32,
                               out + "/", name, device=DEVICE)
            row = solver.log_row()
            fields = solver.lattice.state.fields.double().cpu().numpy()
        row["FieldsL1"] = float(np.abs(fields).sum())
        row["FieldsSum"] = float(fields.sum())
        if name == "heat_adj":
            # tests/test_golden.py's gradient columns, on the card
            from torch_cases import heat_adj_golden_columns
            cols, adj_engine = heat_adj_golden_columns(solver)
            if adj_engine != "cuda_adjoint[d2q9_heat_adj,k=1]":
                fail(f"golden heat_adj's gradient ran on {adj_engine}")
            row.update(cols)
        engine = solver.lattice.engine_name
        if not engine.startswith("cuda_"):
            fail(f"golden {name} ran on {engine}, not a kernel engine")
        worst, worst_key = 0.0, None
        for key, want in golden.items():
            if key == "Walltime":
                continue
            got = row[key]
            if not abs(got - want) <= GOLDEN_ATOL + GOLDEN_RTOL * abs(want):
                fail(f"golden {name}:{key}: {got!r} vs {want!r}")
            rel = abs(got - want) / max(abs(want), 1e-30)
            if rel >= worst:
                worst, worst_key = rel, key
        say(f"  {name}: {len(golden) - 1} columns within rtol "
            f"{GOLDEN_RTOL} (worst rel {worst:.2e}, {worst_key}) on "
            f"{engine}")


def run_case(dk, xml, phase: str, engine: str, kernels, check) -> dict:
    """A main path: an example case end to end on the card, on ``engine``,
    launching each of ``kernels``; ``check(lat)`` adds the case's own
    plausibility checks.  An engine that sums the globals itself
    (``full_globals``) must run no eager step.  The case writes into its
    own ``output/`` (the XML's ``output`` attribute), so it runs from a
    temporary working directory."""
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.models import get_model
    say(f"phase {phase}: {xml.name} end to end")
    root = ET.parse(xml).getroot()
    case = xml.stem
    niter = int(root.find("Solve").get("Iterations"))
    log_every = int(root.find("Log").get("Iterations"))
    vtk = root.find("VTK")
    vtk_every = None if vtk is None else int(vtk.get("Iterations"))
    # the Solve iterates between the Log and VTK callbacks: one iterate
    # call, hence one trailing eager step, per stop
    stops = {niter} | {i for every in (log_every, vtk_every) if every
                       for i in range(every, niter + 1, every)}
    model = get_model(root.get("model"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            dk.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), model, dtype=torch.float32,
                                device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(dk.LAUNCHES)
            flavours = getattr(dk, "flavours", dict)()
        finally:
            os.chdir(cwd)
        out = os.path.join(tmp, root.get("output"))
        files = sorted(os.listdir(out))
        with open(os.path.join(out, f"{case}_Log.csv")) as f:
            rows = f.read().strip().splitlines()[1:]
    log = np.array([[float(v) for v in r.split(",")] for r in rows])
    if not np.isfinite(log).all():
        fail(f"{case}: non-finite Log columns")
    lat = solver.lattice
    full_globals = bool(getattr(lat._fast, "full_globals", False))
    eager_steps = lat.eager_steps
    say(f"  engine {lat.engine_name}, {solver.iter} iterations, "
        f"{wall:.3f} s wall, launches "
        f"{ {k: v for k, v in launches.items() if v} }, eager steps "
        f"{eager_steps}")
    if lat.engine_name != engine:
        fail(f"{case} ran on {lat.engine_name}")
    if eager_steps != (0 if full_globals else len(stops)):
        fail(f"{case} ran {eager_steps} eager steps on {engine} in "
             f"{len(stops)} iterate calls")
    if solver.iter != niter or len(rows) != niter // log_every:
        fail(f"{case}: {solver.iter} iterations, {len(rows)} log rows")
    for it in range(vtk_every or niter + 1, niter + 1, vtk_every or 1):
        for ext in ("vti", "pvti"):
            if f"{case}_VTK_{it:08d}.{ext}" not in files:
                fail(f"{case}: no VTK output {it} .{ext} in {files}")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{case}: non-finite fields")
    g = lat.get_globals()
    if not all(math.isfinite(v) for v in g.values()):
        fail(f"{case}: non-finite globals {g}")
    check(lat)
    for name in kernels:
        if launches[name] < 1:
            fail(f"{case} did not launch {name}")
    # a pure iterate window on the run's own lattice, fenced by synchronize
    nodes = float(np.prod(lat.shape))
    window = 2000
    lat.synchronize()
    t0 = time.perf_counter()
    lat.iterate(window)
    host = time.perf_counter() - t0    # until iterate returns to the host
    lat.synchronize()
    dt = time.perf_counter() - t0
    # the window's trailing eager step (the globals) on its own, where the
    # engine has one
    eager = None
    if not full_globals:
        t0 = time.perf_counter()
        lat.state = lat._iterate(lat.state, lat.params, 1)
        lat.synchronize()
        eager = time.perf_counter() - t0
    out = {"launches": launches, "flavours": flavours, "wall_s": wall,
           "eager_steps": eager_steps,
           "mlups_end_to_end": nodes * niter / wall / 1e6,
           "mlups_iterate": nodes * window / dt / 1e6,
           "iterate_ms": dt * 1e3, "iterate_host_ms": host * 1e3,
           "eager_step_ms": None if eager is None else eager * 1e3,
           "globals": g, "lattice": lat}
    say(f"  MLUPS: {out['mlups_end_to_end']:.1f} end to end (XML, painting, "
        f"Log and VTK included), {out['mlups_iterate']:.1f} in an "
        f"iterate({window}) window ({dt * 1e3:.2f} ms, of which "
        f"{host * 1e3:.2f} ms until iterate returned; "
        + ("no eager step)" if eager is None
           else f"one eager globals step alone {eager * 1e3:.2f} ms)"))
    return out


def check_karman(lat) -> None:
    g = lat.get_globals()
    if g["InletFlux"] <= 0:
        fail(f"karman: implausible globals {g}")


def check_channel3d(lat) -> None:
    """The forced channel flows along +x: positive Flux, a mean x velocity
    of the fluid between the walls that is positive and below 0.5, and
    running averages that are finite and positive in x."""
    g = lat.get_globals()
    u = lat.get_quantity("U")
    avg_u = lat.get_quantity("avgU")
    ux = float(u[0, :, 1:-1, :].mean())
    if not (g["Flux"] > 0 and 0 < ux < 0.5):
        fail(f"3d_channel: implausible flow, Flux {g['Flux']}, mean ux {ux}")
    if not bool(torch.isfinite(avg_u).all()) \
            or float(avg_u[0, :, 1:-1, :].mean()) <= 0:
        fail("3d_channel: implausible running averages")
    say(f"  Flux {g['Flux']:.6g}, mean ux {ux:.6g}, mean avgU.x "
        f"{float(avg_u[0, :, 1:-1, :].mean()):.6g}")


def check_drop(lat) -> None:
    """The periodic drop: total mass within 1e-4 of the initial mass (the
    zonal Density summed over the nodes), and the vapour bubble still at
    the centre (Rho < 0.1 there, > 3 at a corner)."""
    m = lat.model
    zones = (lat.state.flags >> m.zone_shift).long()
    mass0 = float(lat.params.zone_table[m.setting_index["Density"]][zones]
                  .double().sum())
    rho = lat.get_quantity("Rho")
    mass = float(rho.double().sum())
    ny, nx = lat.shape
    centre, corner = float(rho[ny // 2, nx // 2]), float(rho[0, 0])
    say(f"  mass {mass:.9g} (initial {mass0:.9g}, rel change "
        f"{abs(mass - mass0) / mass0:.2e}), Rho centre {centre:.6g}, "
        f"corner {corner:.6g}")
    if abs(mass - mass0) > 1e-4 * mass0:
        fail(f"drop: mass {mass} drifted from {mass0}")
    if not (centre < 0.1 and corner > 3.0):
        fail(f"drop: no vapour bubble (Rho centre {centre}, corner "
             f"{corner})")


def run_drop_band(gk, lat) -> dict:
    """The generic band engine on bench.py's 1024x1024 drop."""
    say("phase 10: 1024x1024 drop on the generic band engine")
    niter = 2000
    lat.synchronize()
    gk.reset_launches()
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    flavours = gk.flavours()
    say(f"  engine {lat.engine_name}, launches {launches} (flavours "
        f"{flavours}), eager steps {lat.eager_steps}, "
        f"{np.prod(lat.shape) * niter / dt / 1e6:.1f} MLUPS")
    if lat.engine_name != "cuda_generic_band[d2q9_kuper,fuse=1]":
        fail(f"1024^2 drop ran on {lat.engine_name}")
    if flavours != {"plain": niter - 1, "globals": 1} or lat.eager_steps:
        fail(f"1024^2 drop: generic2d_step flavours {flavours}, eager "
             f"steps {lat.eager_steps}")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail("1024^2 drop: non-finite fields")
    return {"launches": launches, "flavours": flavours,
            "mlups_iterate": float(np.prod(lat.shape)) * niter / dt / 1e6}


def heat_adj_solve_state(xml):
    """heat_adj.xml's lattice after its <Solve>: the state the Optimize's
    first evaluation starts from (FDTest leaves the state as it was)."""
    return case_lattice(xml, torch.float32, DEVICE,
                        drop=("FDTest", "Optimize", "ThresholdNow", "VTK"))


def run_heat_adj(gk, ak) -> dict:
    """The adjoint main path: example/heat_adj.xml unchanged through
    ``run_config`` — the Solve on the resident engine, FDTest and the MMA
    Optimize on ``cuda_adjoint``, ThresholdNow, VTK — counted from 0, then
    the first Optimize evaluation's f32 kernel gradient against an f64
    eager gradient on the card."""
    from tclb_tpu_torch.adjoint import (InternalTopology,
                                        make_unsteady_gradient)
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.core.lattice import LatticeState, SimParams
    from tclb_tpu_torch.models import get_model
    say("phase 11: heat_adj.xml end to end (Solve, FDTest, MMA Optimize, "
        "ThresholdNow, VTK)")
    xml = HEAT_ADJ_XML
    root = ET.parse(xml).getroot()
    model = get_model(root.get("model"))
    opt_el = root.find("Optimize")
    niter = int(opt_el.get("Iterations"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            gk.reset_launches()
            ak.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), model, dtype=torch.float32,
                                device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = {**gk.LAUNCHES, **ak.LAUNCHES}
            flavours = gk.flavours()
        finally:
            os.chdir(cwd)
        files = sorted(os.listdir(os.path.join(tmp, root.get("output"))))
    lat = solver.lattice
    say(f"  primal engine {lat.engine_name}, adjoint engine "
        f"{solver.adjoint_engine}, {wall:.3f} s wall, launches {launches} "
        f"(generic2d_step flavours {flavours}), eager steps "
        f"{lat.eager_steps}")
    for r in solver.fd_records:
        say(f"  FDTest component {r['index']}: adjoint {r['adjoint']:.8g} "
            f"fd {r['fd']:.8g} rel_err {r['rel_err']:.3e} (f32: logged, "
            "not judged)")
    for k, obj in enumerate(solver.opt_history):
        say(f"  Optimize[MMA] evaluation {k}: objective {obj:.9g}")
    mat = solver.opt_material
    say(f"  material: start {mat['start']:.9g}, end {mat['end']:.9g} "
        f"({mat['direction']})")
    if lat.engine_name != "cuda_generic_resident[d2q9_heat_adj,fuse=N]":
        fail(f"heat_adj.xml's Solve ran on {lat.engine_name}")
    if solver.adjoint_engine != "cuda_adjoint[d2q9_heat_adj,k=1]":
        fail(f"heat_adj.xml's gradients ran on {solver.adjoint_engine}")
    if launches["generic2d_step_b"] < 1 or flavours["globals"] < 1 \
            or launches["generic2d_resident"] < 1:
        fail(f"heat_adj.xml launches {launches}, flavours {flavours}")
    if len(solver.opt_history) != int(opt_el.get("MaxEvaluations")) \
            or not all(math.isfinite(o) for o in solver.opt_history):
        fail(f"heat_adj.xml objectives {solver.opt_history}")
    if mat["end"] > mat["start"] * (1 + 1e-6):
        fail(f"heat_adj.xml broke its material constraint: {mat}")
    w = lat.get_quantity("W")
    values = sorted(set(torch.unique(w).tolist()))
    if not set(values) <= {0.0, 1.0}:
        fail(f"heat_adj.xml's design is not binary after ThresholdNow: "
             f"{values[:8]}")
    if not any(f.endswith(".vti") for f in files) \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"heat_adj.xml: output {files} or non-finite fields")
    say(f"  design values after ThresholdNow {values}, "
        f"{int((w == 0).sum())} solid nodes")

    # the first Optimize evaluation: the same state, theta and horizon
    start = heat_adj_solve_state(xml)
    design = InternalTopology(model)
    theta = design.get(start.state, start.params)
    g32_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    device=DEVICE)
    obj32, g32, _ = g32_fn(theta, start.state, start.params)
    state64 = LatticeState(fields=start.state.fields.double(),
                           flags=start.state.flags,
                           globals_=start.state.globals_.double(),
                           iteration=start.state.iteration)
    params64 = SimParams(settings=start.params.settings.double(),
                         zone_table=start.params.zone_table.double())
    g64_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    dtype=torch.float64, device=DEVICE)
    obj64, g64, _ = g64_fn(theta.double(), state64, params64)
    rel_l2 = float((g32.double() - g64).norm() / g64.norm())
    say(f"  first evaluation: {g32_fn.engine_name} objective "
        f"{float(obj32):.9g} (Optimize logged "
        f"{solver.opt_history[0]:.9g}), {g64_fn.engine_name} f64 "
        f"{float(obj64):.9g}; gradient rel L2 {rel_l2:.3e} (limit "
        f"{GRAD_F64_REL_L2})")
    if g64_fn.engine_name != "eager" or not rel_l2 <= GRAD_F64_REL_L2:
        fail(f"heat_adj.xml's f32 kernel gradient is {rel_l2} from f64")
    if abs(float(obj32) - solver.opt_history[0]) \
            > 1e-6 * abs(solver.opt_history[0]):
        fail("the re-run first evaluation differs from the Optimize's")
    return {"launches": launches, "flavours": flavours, "wall_s": wall,
            "objectives": solver.opt_history, "material": mat,
            "fd_records": solver.fd_records, "grad_rel_l2_f64": rel_l2,
            "solid_nodes": int((w == 0).sum())}


def run_heat1024(gk, ak, lat) -> dict:
    """bench.py's heat_adj channel at 512x1024: (a) ``iterate(2000)`` on
    the band engine; (b) an 8-step gradient on cuda_adjoint against eager
    autograd on the card, f32; (c) a 1000-step unsteady gradient with
    automatic checkpoint levels, counted from 0."""
    from tclb_tpu_torch.adjoint import (InternalTopology, auto_levels,
                                        make_unsteady_gradient)
    say("phase 12: 512x1024 heat_adj channel: primal band engine and "
        "gradients")
    nodes = float(np.prod(lat.shape))
    niter = 2000
    lat.synchronize()
    gk.reset_launches()
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(gk.LAUNCHES)
    flavours = gk.flavours()
    mlups = nodes * niter / dt / 1e6
    say(f"  (a) engine {lat.engine_name}, launches {launches} (flavours "
        f"{flavours}), {mlups:.1f} MLUPS")
    if lat.engine_name != "cuda_generic_band[d2q9_heat_adj,fuse=1]":
        fail(f"512x1024 heat_adj ran on {lat.engine_name}")
    if flavours != {"plain": niter - 1, "globals": 1} or lat.eager_steps \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"512x1024 heat_adj: flavours {flavours}, eager steps "
             f"{lat.eager_steps}")
    m = lat.model
    design = InternalTopology(m)
    # w = 0.8 on the design block: Drag = (1 - w)|ux| then depends on the
    # flow, so the gradient runs through every step's field cotangents
    theta = torch.full_like(design.get(lat.state, lat.params), 0.8)
    got = {}
    for engine in ("cuda", "eager"):
        fn = make_unsteady_gradient(m, design, 8, levels=1, engine=engine,
                                    shape=lat.shape, device=DEVICE)
        got[engine] = fn(theta, lat.state, lat.params)
    (oc, gc, _), (oe, ge, _) = got["cuda"], got["eager"]
    err = (gc - ge).abs()
    ok = bool((err <= GRAD_ATOL + GRAD_RTOL * ge.abs()).all()) \
        and float(ge.abs().max()) > 0
    say(f"  (b) 8-step gradient: cuda_adjoint objective {float(oc):.9g}, "
        f"eager {float(oe):.9g}; max abs err {float(err.max()):.3e}, "
        f"max |g| {float(ge.abs().max()):.3e} (rtol {GRAD_RTOL} atol "
        f"{GRAD_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the 8-step 512x1024 kernel gradient disagrees with eager")
    horizon = 1000
    levels = auto_levels(m, lat.shape, horizon)
    if levels != 2:
        fail(f"auto_levels chose {levels} for the 1000-step gradient")
    grad_fn = make_unsteady_gradient(m, design, horizon, shape=lat.shape,
                                     device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    ak.reset_launches()
    t0 = time.perf_counter()
    obj, g, _ = grad_fn(theta, lat.state, lat.params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grad_launches = {**gk.LAUNCHES, **ak.LAUNCHES}
    grad_flavours = gk.flavours()
    peak = torch.cuda.max_memory_allocated()
    rate = nodes * horizon / wall / 1e6
    primal_s = horizon * nodes / (mlups * 1e6)
    say(f"  (c) 1000-step gradient, levels {levels}: {wall:.3f} s wall, "
        f"{rate:.1f} primal-equivalent MLUPS, {wall / primal_s:.2f}x the "
        f"wall of 1000 primal steps, peak memory {peak / 2**30:.2f} GiB, "
        f"launches {grad_launches}, objective {float(obj):.9g}")
    if not (math.isfinite(float(obj)) and bool(torch.isfinite(g).all())):
        fail("the 1000-step gradient is not finite")
    return {"launches": launches, "flavours": flavours,
            "mlups_iterate": mlups, "grad_launches": grad_launches,
            "grad_flavours": grad_flavours,
            "grad8_max_abs_err": float(err.max()),
            "grad1000": {"levels": levels, "wall_s": wall,
                         "mlups_primal_equivalent": rate,
                         "wall_over_primal": wall / primal_s,
                         "max_memory_allocated": peak},
            "grad_fn": lambda: grad_fn(theta, lat.state, lat.params)}


def adj3d_case_file(directory) -> pathlib.Path:
    """The 3D adjoint case XML (tests/torch_cases.py:adj3d_case_xml) at
    bench.py's 32x64x256, written into ``directory``."""
    from torch_cases import adj3d_case_xml
    path = pathlib.Path(directory) / "adj3d_case.xml"
    path.write_text(adj3d_case_xml("chip"))
    return path


def rich_adj3d_lattice(device):
    """An 8x16x32 d3q19_adj state that paints every node type the model
    reads, two zones and a design field in (0.1, 0.9)
    (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import ADJ3D_SETTINGS, ADJ3D_SHAPE, paint_rich_adj3d
    lat = Lattice(get_model("d3q19_adj"), ADJ3D_SHAPE, dtype=torch.float32,
                  device=device, settings=ADJ3D_SETTINGS)
    return paint_rich_adj3d(lat, seed=5)


def bench3d_lattice(device, shape=(32, 64, 256)):
    """bench.py:bench_adjoint3d's d3q19_adj case (bench.py:418-428)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import bench_adjoint3d_lattice
    return bench_adjoint3d_lattice(Lattice, get_model("d3q19_adj"),
                                   torch.float32, shape, device=device)


def f64_copy(lat):
    """``(state, params)`` of a lattice in f64."""
    from tclb_tpu_torch.core.lattice import LatticeState, SimParams
    st, pa = lat.state, lat.params
    return (LatticeState(fields=st.fields.double(), flags=st.flags,
                         globals_=st.globals_.double(),
                         iteration=st.iteration),
            SimParams(settings=pa.settings.double(),
                      zone_table=pa.zone_table.double()))


def run_adj3d_case(g3, ak, xml) -> dict:
    """The 3D adjoint path: the case XML through ``run_config`` -- the
    Solve on the band engine, FDTest and the MMA Optimize on
    ``cuda_adjoint3d``, ThresholdNow, VTK -- counted from 0; then the first
    Optimize evaluation's f32 kernel gradient against an f64 eager
    gradient on the card, and an 8-step f64 central-difference check at
    three components inside the design block."""
    from tclb_tpu_torch.adjoint import (InternalTopology, fd_test,
                                        make_objective_run,
                                        make_unsteady_gradient)
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.models import get_model
    from torch_cases import adj3d_design_block
    say("phase 13: the 3D adjoint case at 32x64x256 end to end (Solve, "
        "FDTest, MMA Optimize, ThresholdNow, VTK)")
    root = ET.parse(xml).getroot()
    model = get_model(root.get("model"))
    opt_el = root.find("Optimize")
    niter = int(opt_el.get("Iterations"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.synchronize()
            g3.reset_launches()
            ak.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), model, dtype=torch.float32,
                                device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = {**g3.LAUNCHES, **ak.LAUNCHES}
            flavours = dict(g3.FLAVOUR_LAUNCHES)
        finally:
            os.chdir(cwd)
        files = sorted(os.listdir(os.path.join(tmp, root.get("output"))))
    lat = solver.lattice
    say(f"  primal engine {lat.engine_name}, adjoint engine "
        f"{solver.adjoint_engine}, {wall:.3f} s wall, launches {launches} "
        f"(generic3d_step flavours {flavours}), eager steps "
        f"{lat.eager_steps}")
    for r in solver.fd_records:
        say(f"  FDTest component {r['index']}: adjoint {r['adjoint']:.8g} "
            f"fd {r['fd']:.8g} rel_err {r['rel_err']:.3e} (f32: logged, "
            "not judged)")
    for k, obj in enumerate(solver.opt_history):
        say(f"  Optimize[MMA] evaluation {k}: objective {obj:.9g}")
    mat = solver.opt_material
    say(f"  material: start {mat['start']:.9g}, end {mat['end']:.9g} "
        f"({mat['direction']})")
    if lat.engine_name != "cuda_generic3d_band[d3q19_adj,fuse=1]":
        fail(f"the 3D case's Solve ran on {lat.engine_name}")
    if solver.adjoint_engine != "cuda_adjoint3d[d3q19_adj,k=1]":
        fail(f"the 3D case's gradients ran on {solver.adjoint_engine}")
    if launches["generic3d_step_b"] < 1 or launches["generic2d_step_b"] \
            or flavours["globals"] < 1 or flavours["plain"] < 1 \
            or lat.eager_steps:
        fail(f"the 3D case: launches {launches}, flavours {flavours}, "
             f"eager steps {lat.eager_steps}")
    if len(solver.opt_history) != int(opt_el.get("MaxEvaluations")) \
            or not all(math.isfinite(o) for o in solver.opt_history):
        fail(f"the 3D case's objectives {solver.opt_history}")
    if mat["end"] > mat["start"] * (1 + 1e-6):
        fail(f"the 3D case broke its material constraint: {mat}")
    w = lat.get_quantity("W")
    block = adj3d_design_block(lat.shape)
    values = sorted(set(torch.unique(w[block]).tolist()))
    if not set(values) <= {0.0, 1.0}:
        fail(f"the 3D design block is not binary after ThresholdNow: "
             f"{values[:8]}")
    if not any(f.endswith(".vti") for f in files) \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"the 3D case: output {files} or non-finite fields")
    solid = int((w[block] == 0).sum())
    say(f"  design block values after ThresholdNow {values}, {solid} "
        "solid nodes")

    # the first Optimize evaluation: the same state, theta and horizon
    start = case_lattice(xml, torch.float32, DEVICE,
                         drop=("FDTest", "Optimize", "ThresholdNow", "VTK"))
    design = InternalTopology(model)
    theta = design.get(start.state, start.params)
    g32_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    device=DEVICE)
    obj32, g32, _ = g32_fn(theta, start.state, start.params)
    state64, params64 = f64_copy(start)
    g64_fn = make_unsteady_gradient(model, design, niter, shape=start.shape,
                                    dtype=torch.float64, device=DEVICE)
    obj64, g64, _ = g64_fn(theta.double(), state64, params64)
    rel_l2 = float((g32.double() - g64).norm() / g64.norm())
    say(f"  first evaluation: {g32_fn.engine_name} objective "
        f"{float(obj32):.9g} (Optimize logged "
        f"{solver.opt_history[0]:.9g}), {g64_fn.engine_name} f64 "
        f"{float(obj64):.9g}; gradient rel L2 {rel_l2:.3e} (limit "
        f"{GRAD_F64_REL_L2})")
    if g32_fn.engine_name != "cuda_adjoint3d[d3q19_adj,k=1]" \
            or g64_fn.engine_name != "eager" \
            or not rel_l2 <= GRAD_F64_REL_L2:
        fail(f"the 3D case's f32 kernel gradient is {rel_l2} from f64")
    if abs(float(obj32) - solver.opt_history[0]) \
            > 1e-6 * abs(solver.opt_history[0]):
        fail("the re-run first evaluation differs from the Optimize's")

    # central differences inside the design block, f64 eager, against the
    # f64 adjoint (judged) and the f32 kernel adjoint (logged)
    fd_el = root.find("FDTest")
    fd_iter, checks = int(fd_el.get("Iterations")), int(fd_el.get("Checks"))
    quarters = ((2, 2, 2), (1, 3, 1), (3, 1, 3))
    nodes = [tuple(sl.start + (sl.stop - sl.start) * q // 4
                   for sl, q in zip(block, f)) for f in quarters]
    idx = [int(np.ravel_multi_index((0,) + n, tuple(theta.shape)))
           for n in nodes[:checks]]
    fd64_fn = make_unsteady_gradient(model, design, fd_iter,
                                     dtype=torch.float64, device=DEVICE)
    _, gfd64, _ = fd64_fn(theta.double(), state64, params64)
    fd32_fn = make_unsteady_gradient(model, design, fd_iter,
                                     shape=start.shape, device=DEVICE)
    _, gfd32, _ = fd32_fn(theta, start.state, start.params)
    run = make_objective_run(model, fd_iter)

    def loss(th):
        return run(*design.put(th, state64, params64))[0]

    records = fd_test(loss, gfd64, theta.double(), indices=idx, eps=1e-4)
    flat32 = gfd32.reshape(-1)
    for r in records:
        r["kernel_f32"] = float(flat32[r["index"]])
        say(f"  FD component {r['index']} (in the design block): f64 "
            f"adjoint {r['adjoint']:.10g}, fd {r['fd']:.10g}, rel_err "
            f"{r['rel_err']:.3e} (rtol {FD_REL} atol {FD_ATOL}); f32 kernel "
            f"adjoint {r['kernel_f32']:.8g}")
        if not (r["adjoint"] != 0 and abs(r["fd"] - r["adjoint"])
                <= FD_ATOL + FD_REL * abs(r["adjoint"])):
            fail(f"the 3D case's FD check at {r['index']}: {r}")
    return {"launches": launches, "flavours": flavours, "wall_s": wall,
            "objectives": solver.opt_history, "material": mat,
            "fd_records": solver.fd_records, "fd_in_block": records,
            "grad_rel_l2_f64": rel_l2, "solid_nodes": solid,
            "start": start}


def run_bench_adjoint3d(g3, ak, lat) -> dict:
    """bench.py's 3D adjoint case (bench_adjoint3d) at 32x64x256: (a)
    ``iterate(2000)`` on the band engine; (b) an 8-step gradient on
    cuda_adjoint3d against eager autograd on the card, f32; (c) the
    200-step gradient (bench.py:436-446), best of two timed runs; (d) a
    1000-step gradient at 64x128x256 with automatic checkpoint levels,
    counted from 0."""
    from tclb_tpu_torch.adjoint import (InternalTopology, auto_levels,
                                        make_unsteady_gradient)
    say("phase 14: bench.py's 3D adjoint case: the band primal and "
        "gradients")
    nodes = float(np.prod(lat.shape))
    niter = 2000
    # the gradients start from the initialised state, as bench.py's do:
    # with Porocity 0.5 everywhere and no inlet the flow dies out
    state0, params0 = lat.state, lat.params
    lat.synchronize()
    g3.reset_launches()
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(g3.LAUNCHES)
    flavours = dict(g3.FLAVOUR_LAUNCHES)
    mlups = nodes * niter / dt / 1e6
    say(f"  (a) engine {lat.engine_name}, launches {launches} (flavours "
        f"{flavours}), {mlups:.1f} MLUPS")
    if lat.engine_name != "cuda_generic3d_band[d3q19_adj,fuse=1]":
        fail(f"bench_adjoint3d ran on {lat.engine_name}")
    if flavours != {"plain": niter - 1, "globals": 1} or lat.eager_steps \
            or not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"bench_adjoint3d: flavours {flavours}, eager steps "
             f"{lat.eager_steps}")
    m = lat.model
    design = InternalTopology(m)
    theta = design.get(state0, params0)
    got = {}
    for engine in ("cuda", "eager"):
        fn = make_unsteady_gradient(m, design, 8, levels=1, engine=engine,
                                    shape=lat.shape, device=DEVICE)
        got[engine] = fn(theta, state0, params0)
    (oc, gc, _), (oe, ge, _) = got["cuda"], got["eager"]
    err = (gc - ge).abs()
    ok = bool((err <= GRAD_ATOL + GRAD_RTOL * ge.abs()).all()) \
        and float(ge.abs().max()) > 0 and float(oc) != 0
    say(f"  (b) 8-step gradient: cuda_adjoint3d objective {float(oc):.9g}, "
        f"eager {float(oe):.9g}; max abs err {float(err.max()):.3e}, "
        f"max |g| {float(ge.abs().max()):.3e} (rtol {GRAD_RTOL} atol "
        f"{GRAD_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the 8-step 3D kernel gradient disagrees with eager")
    grad200 = make_unsteady_gradient(m, design, 200, shape=lat.shape,
                                     device=DEVICE)
    grad200(theta, state0, params0)
    best = math.inf
    for _ in range(2):
        torch.cuda.synchronize()
        g3.reset_launches()
        ak.reset_launches()
        t0 = time.perf_counter()
        obj, g, _ = grad200(theta, state0, params0)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        if not (math.isfinite(float(obj)) and bool(torch.isfinite(g).all())):
            fail("the 200-step 3D gradient is not finite")
    g200_launches = {**g3.LAUNCHES, **ak.LAUNCHES}
    g200_flavours = dict(g3.FLAVOUR_LAUNCHES)
    levels200 = auto_levels(m, lat.shape, 200)
    say(f"  (c) 200-step gradient, levels {levels200}: {best:.4f} s wall "
        f"(best of 2), {nodes * 200 / best / 1e6:.1f} primal-equivalent "
        f"MLUPS, launches {g200_launches}")

    big = bench3d_lattice(DEVICE, (64, 128, 256))
    big0 = big.state
    nodes_big = float(np.prod(big.shape))
    horizon = 1000
    big.iterate(2)
    big.synchronize()
    t0 = time.perf_counter()
    big.iterate(horizon)
    big.synchronize()
    primal_s = time.perf_counter() - t0
    mlups_big = nodes_big * horizon / primal_s / 1e6
    levels = auto_levels(m, big.shape, horizon)
    if levels != 2:
        fail(f"auto_levels chose {levels} for the 1000-step 3D gradient")
    theta_big = design.get(big0, big.params)
    grad_fn = make_unsteady_gradient(m, design, horizon, shape=big.shape,
                                     device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g3.reset_launches()
    ak.reset_launches()
    t0 = time.perf_counter()
    obj, g, _ = grad_fn(theta_big, big0, big.params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grad_launches = {**g3.LAUNCHES, **ak.LAUNCHES}
    grad_flavours = dict(g3.FLAVOUR_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rate = nodes_big * horizon / wall / 1e6
    say(f"  (d) 64x128x256: 1000 primal steps {primal_s:.4f} s "
        f"({mlups_big:.1f} MLUPS); 1000-step gradient, levels {levels}: "
        f"{wall:.3f} s wall, {rate:.1f} primal-equivalent MLUPS, "
        f"{wall / primal_s:.2f}x the wall of 1000 primal steps, peak memory "
        f"{peak / 2**30:.2f} GiB, launches {grad_launches}, objective "
        f"{float(obj):.9g}")
    if not (math.isfinite(float(obj)) and float(obj) != 0
            and bool(torch.isfinite(g).all())):
        fail("the 1000-step 3D gradient is zero or not finite")
    return {"launches": launches, "flavours": flavours,
            "mlups_iterate": mlups,
            "grad8_max_abs_err": float(err.max()),
            "grad200": {"levels": levels200, "wall_s": best,
                        "mlups_primal_equivalent": nodes * 200 / best / 1e6,
                        "launches": g200_launches,
                        "flavours": g200_flavours},
            "grad1000": {"shape": list(big.shape), "levels": levels,
                         "wall_s": wall, "primal_1000_s": primal_s,
                         "primal_mlups": mlups_big,
                         "mlups_primal_equivalent": rate,
                         "wall_over_primal": wall / primal_s,
                         "max_memory_allocated": peak,
                         "launches": grad_launches,
                         "flavours": grad_flavours},
            "grad_fn": lambda: grad_fn(theta_big, big0, big.params)}


def time_generic3d(g3, ak, lat) -> dict:
    """d3q19_adj's ``generic3d_step`` (both flavours) and
    ``generic3d_step_b`` at the 3D paths' launch (32x64x256)."""
    out = {}
    *inputs, a = g3.kernel_inputs(lat.model, lat.state, lat.params)
    for g in (False, True):
        key = f"generic3d_step[{lat.model.name}]" + (" globals" if g else "")
        fn = g3.step_globals if g else g3.step
        out[key] = time_one(
            key, lambda: fn(*inputs, a),
            lambda: g3.plain_steps(*inputs, a, 1, with_globals=g),
            g3.launch_bytes(lat.model, lat.shape),
            g3.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
            200 if g else 400, plain_reps=3)
    out.update(time_step_b(ak, g3, lat, plain_reps=3))
    return out


def run_iterate(dk, lat, phase: str, what: str, engine: str, kernels,
                niter: int = 2002) -> dict:
    """``lat.iterate(niter)`` on ``engine``, counted from 0: each of
    ``kernels`` launched, one trailing eager step (the globals), finite
    fields, and the window's MLUPS."""
    say(f"phase {phase}: {what}")
    lat.synchronize()
    dk.reset_launches()
    eager0 = lat.eager_steps
    t0 = time.perf_counter()
    lat.iterate(niter)
    lat.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(dk.LAUNCHES)
    mlups = float(np.prod(lat.shape)) * niter / dt / 1e6
    say(f"  engine {lat.engine_name}, launches "
        f"{ {k: v for k, v in launches.items() if v} }, {mlups:.1f} MLUPS")
    if lat.engine_name != engine:
        fail(f"{what} ran on {lat.engine_name}")
    for name in kernels:
        if launches[name] < 1:
            fail(f"{what} did not launch {name}")
    if lat.eager_steps - eager0 != 1:
        fail(f"{what}: {lat.eager_steps - eager0} eager steps")
    if not bool(torch.isfinite(lat.state.fields).all()):
        fail(f"{what}: non-finite fields")
    return {"launches": launches, "mlups_iterate": mlups, "lattice": lat}


def rich_family_lattice(model: str, device):
    """A 32x64 state of a d2q9-family model that paints every node type
    the model reads, two zones and gravity (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import FAMILY_SHAPE, family_settings, paint_rich_family
    m = get_model(model)
    lat = Lattice(m, FAMILY_SHAPE, dtype=torch.float32, device=device,
                  settings=family_settings(m))
    return paint_rich_family(lat, seed=5)


def family_channel_lattice(model: str, device, shape):
    """bench.py's channels for a family model: its d2q9_cumulant channel
    (bench.py:194-207: BGK nodes, W velocity inlet, E pressure outlet, two
    walls, nu 0.02, Velocity 0.01, omega_bulk 1) for d2q9_cumulant, and
    its d2q9 channel's flags (bench.py:154-167) with the same settings for
    the other models."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import channel_flags, cumulant_channel_flags
    m = get_model(model)
    settings = {"nu": 0.02, "Velocity": 0.01}
    if model == "d2q9_cumulant":
        settings["omega_bulk"] = 1.0
        flags = cumulant_channel_flags(m, *shape)
    else:
        flags = channel_flags(m, *shape)
    lat = Lattice(m, shape, dtype=torch.float32, device=device,
                  settings=settings)
    lat.set_flags(flags)
    lat.init()
    return lat


def run_xml(xml, dtype):
    """A case XML through ``run_config`` on the card's eager engine
    (``TCLB_FASTPATH=0``) from a temporary working directory (its output=
    prefix is relative)."""
    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.models import get_model
    model = get_model(ET.parse(xml).getroot().get("model"))
    cwd, fastpath = os.getcwd(), os.environ.get("TCLB_FASTPATH")
    with case_dir() as tmp:
        os.chdir(tmp)
        os.environ["TCLB_FASTPATH"] = "0"
        try:
            solver = run_config(str(xml), model, dtype=dtype, device=DEVICE)
            solver.lattice.synchronize()
        finally:
            os.chdir(cwd)
            if fastpath is None:
                del os.environ["TCLB_FASTPATH"]
            else:
                os.environ["TCLB_FASTPATH"] = fastpath
    return solver


def mean_ux_between_walls(lat) -> float:
    return float(lat.get_quantity("U")[0, 1:-1, :].double().mean())


def check_cumulant2d(lat) -> None:
    """The inlet-driven cumulant channel flows along +x: a mean ux between
    the walls in (0, 0.1) (the case paints no objective nodes, so its
    flux globals stay 0)."""
    ux = mean_ux_between_walls(lat)
    say(f"  mean ux {ux:.6g}, globals {lat.get_globals()}")
    if not 0 < ux < 0.1:
        fail(f"cumulant2d: implausible mean ux {ux}")


def check_les(lat) -> None:
    """The gravity-driven LES channel accelerates along +x."""
    ux = mean_ux_between_walls(lat)
    say(f"  mean ux {ux:.6g}")
    if not 0 < ux < 0.2:
        fail(f"les_channel: implausible mean ux {ux}")


def check_poiseuille(xml, out: dict):
    """BASELINE config 2 on d2q9_SRT: the f32 kernel run's final ux
    profile (the mean over x of each fluid row) against the same XML run on
    the eager engine on the card, in f32 at the kernels' own tolerance
    (rtol 2e-5, atol 2e-6) and in f64 within a relative L2 error of
    POISEUILLE_F64_REL_L2; the f32 eager run's own distance from f64 is
    reported beside it."""
    def profile(lat):
        return lat.get_quantity("U")[0, 1:-1].double().mean(dim=1)

    def check(lat) -> None:
        got = profile(lat)
        refs = {}
        for dtype in (torch.float32, torch.float64):
            ref = run_xml(xml, dtype)
            if ref.lattice.engine_name != "eager" \
                    or ref.iter != lat.state.iteration:
                fail(f"SRT Poiseuille {dtype} reference: "
                     f"{ref.lattice.engine_name}, {ref.iter} iterations")
            refs[dtype] = profile(ref.lattice)
        want = refs[torch.float64]
        out["vs_f32_eager"] = compare(got, refs[torch.float32],
                                      "SRT Poiseuille ux profile, f32 "
                                      "kernels vs f32 eager")
        for what, u in (("kernels", got), ("eager", refs[torch.float32])):
            rel = float((u - want).norm() / want.norm())
            out[f"f32_{what}_vs_f64_rel_l2"] = rel
            out[f"f32_{what}_vs_f64_max_abs"] = float((u - want).abs().max())
            say(f"  SRT Poiseuille ux profile, f32 {what} vs f64 eager: "
                f"relative L2 {rel:.3e}, max_abs "
                f"{out[f'f32_{what}_vs_f64_max_abs']:.3e} (limit "
                f"{POISEUILLE_F64_REL_L2} for the kernels)")
        out["ux_max"] = float(want.max())
        if not out["f32_kernels_vs_f64_rel_l2"] <= POISEUILLE_F64_REL_L2:
            fail("SRT Poiseuille: the f32 kernel profile is too far from "
                 "f64")
        if not float(want.max()) > 0:
            fail("SRT Poiseuille: no flow")
    return check


def run_family(dk, band_lats: dict, res_lats: dict, errs: dict) -> dict:
    """The d2q9 family's paths, each counted from 0 (phases 15-19), then
    every family kernel against its plain version on each path's developed
    state (phase 19b).  Returns the launches by kernel and path, each
    model's resident-path lattice and the paths' figures."""
    from torch_cases import srt_poiseuille_xml
    keys = ("wall_s", "mlups_end_to_end", "mlups_iterate", "iterate_ms",
            "iterate_host_ms", "eager_step_ms", "eager_steps")
    launches = {dk.launch_key(name, m): {} for m in dk.FAMILY
                for name in dk.KERNELS}
    resident, summary, developed = {}, {}, []

    def engine(kind: str, m: str) -> str:
        return (f"cuda_d2q9_resident[{m},fuse={dk.RESIDENT_FUSE}]"
                if kind == "resident" else f"cuda_d2q9_band[{m},fuse=2]")

    def kernels(kind: str, m: str) -> tuple:
        first = "d2q9_resident8" if kind == "resident" else "d2q9_step2"
        return (dk.launch_key(first, m), dk.launch_key("d2q9_step", m))

    def record(path: str, m: str, run: dict) -> None:
        for name in dk.KERNELS:
            n = run["launches"][dk.launch_key(name, m)]
            if n:
                launches[dk.launch_key(name, m)][path] = n
        developed.append(run["lattice"])

    m = "d2q9_cumulant"
    run = run_case(dk, CUMULANT2D_XML, "15", engine("resident", m),
                   kernels("resident", m), check_cumulant2d)
    record("cumulant2d", m, run)
    resident[m] = run["lattice"]
    summary["cumulant2d"] = {k: run[k] for k in keys}
    run = run_iterate(dk, band_lats[m], "16", "bench.py's 1024x1024 "
                      "d2q9_cumulant channel on the band engine",
                      engine("band", m), kernels("band", m))
    record("cumulant1024", m, run)
    summary["d2q9_cumulant1024_mlups_iterate"] = run["mlups_iterate"]
    m = "d2q9_les"
    run = run_case(dk, LES_XML, "17", engine("resident", m),
                   kernels("resident", m), check_les)
    record("les_channel", m, run)
    resident[m] = run["lattice"]
    summary["les_channel"] = {k: run[k] for k in keys}
    m = "d2q9_SRT"
    with tempfile.TemporaryDirectory() as tmp:
        xml = pathlib.Path(tmp) / "poiseuille_srt.xml"
        xml.write_text(srt_poiseuille_xml())
        profile = {}
        run = run_case(dk, xml, "18", engine("resident", m),
                       kernels("resident", m), check_poiseuille(xml, profile))
    record("srt_poiseuille", m, run)
    resident[m] = run["lattice"]
    summary["srt_poiseuille"] = {**{k: run[k] for k in keys},
                                 "ux_profile": profile}
    summary["family1024_mlups_iterate"] = {}
    for m in ("d2q9_SRT", "d2q9_les", "d2q9_inc", "d2q9_new"):
        run = run_iterate(dk, band_lats[m], "19", f"bench.py's 1024x1024 "
                          f"channel, {m}, on the band engine",
                          engine("band", m), kernels("band", m))
        record("channel1024", m, run)
        summary["family1024_mlups_iterate"][m] = run["mlups_iterate"]
    summary["family128x1024_mlups_iterate"] = {}
    for m, lat in res_lats.items():
        run = run_iterate(dk, lat, "19", f"bench.py's channel at 128x1024, "
                          f"{m}, on the resident engine",
                          engine("resident", m), kernels("resident", m))
        record("channel128x1024", m, run)
        resident[m] = lat
        summary["family128x1024_mlups_iterate"][m] = run["mlups_iterate"]
    check_kernels([(dk, lat, name) for lat in developed
                   for name in dk.KERNELS], errs,
                  "phase 19b, the family's paths after their runs")
    return {"launches": launches, "resident_lattice": resident,
            "summary": summary}


def rich_d3q_lattice(model: str, device):
    """A 12x8x64 state of a z-slab family model that paints every node
    type the model reads, two zones and gravity (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import SHAPE3D, d3q_family_settings, paint_rich_d3q
    m = get_model(model)
    lat = Lattice(m, SHAPE3D, dtype=torch.float32, device=device,
                  settings=d3q_family_settings(m))
    return paint_rich_d3q(lat, seed=5)


def channel48_lattice(model: str, device):
    """bench.py's 3D channel (bench.py:619-662) at 48x48x256: MRT nodes,
    walls at y = 0 and y = ny - 1, nu 0.01 and a body force along x."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import channel3d_flags
    m = get_model(model)
    lat = Lattice(m, CHANNEL48, dtype=torch.float32, device=device,
                  settings={"nu": 0.01, "GravitationX": 1e-5})
    lat.set_flags(channel3d_flags(m, *CHANNEL48))
    lat.init()
    return lat


def turbulence_lattice(device):
    """example/3dcum_turbulence.xml painted and initialised, its SynthT
    planes drawn once for a 200-step segment (nonzero) and the flow
    warmed 20 eager steps."""
    from tclb_tpu_torch.control.solver import _run_root
    from tclb_tpu_torch.models import get_model
    root = ET.parse(TURB_XML).getroot()
    for tag in ("Solve", "Log"):
        for el in root.findall(tag):
            root.remove(el)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as out:
        os.chdir(out)
        try:
            solver = _run_root(root, get_model(root.get("model")), None,
                               torch.float32, out + "/", "case_state",
                               device=device)
        finally:
            os.chdir(cwd)
    solver.update_synthetic_turbulence(200)
    lat = solver.lattice
    eager_warm(lat, 20)
    if not float(lat.get_density("SynthTX").abs().max()) > 0:
        fail("3dcum_turbulence: SynthT planes are zero")
    return lat


def run_turbulence(dk3) -> dict:
    """Path A: example/3dcum_turbulence.xml unchanged through
    ``run_config`` on ``cuda_d3q27_band[d3q27_cumulant,fuse=2]`` (phase
    20, counted from 0).  The Solve draws new SynthT planes before each of
    its five iterate calls: their digests are recorded and must all
    differ; the inlet's ux must fluctuate and the flow near the inlet carry
    a transverse velocity (after tests/test_turbulence.py:56-93)."""
    from tclb_tpu_torch.control.solver import Solver
    synth_sums = []
    update = Solver.update_synthetic_turbulence

    def recording(self, steps):
        update(self, steps)
        planes = [self.lattice.get_density(n)
                  for n in ("SynthTX", "SynthTY", "SynthTZ")]
        synth_sums.append(float(sum(p.double().abs().sum()
                                    for p in planes)))

    def check(lat) -> None:
        u = lat.get_quantity("U")
        ux_in = u[0, 1:-1, 1:-1, 0].double()
        uy_near = float(u[1, :, :, 1].abs().max())
        sx = float(lat.get_density("SynthTX").abs().max())
        say(f"  SynthT digests per segment {synth_sums}; inlet ux mean "
            f"{float(ux_in.mean()):.6g} std {float(ux_in.std()):.3e}, "
            f"max |uy| at x = 1 {uy_near:.3e}, max |SynthTX| {sx:.3g}")
        if len(synth_sums) != 5 or len(set(synth_sums)) != len(synth_sums):
            fail(f"3dcum_turbulence: SynthT planes did not change between "
                 f"segments: {synth_sums}")
        if not (float(ux_in.std()) > 1e-4 and uy_near > 1e-5 and sx > 1e-3
                and 0 < float(ux_in.mean()) < 0.1):
            fail("3dcum_turbulence: the inlet does not fluctuate")

    Solver.update_synthetic_turbulence = recording
    try:
        out = run_case(dk3, TURB_XML, "20",
                       "cuda_d3q27_band[d3q27_cumulant,fuse=2]",
                       ("d3q27_step2", "d3q27_step"), check)
    finally:
        Solver.update_synthetic_turbulence = update
    out["synth_digests"] = synth_sums
    return out


def run_d3q_channels(dk3, lats: dict) -> dict:
    """Path B (phase 21): bench.py's 48x48x256 channel for each z-slab
    family model, ``iterate(2002)`` on ``cuda_d3q27_band[<model>,fuse=2]``,
    counted from 0, its launches by kernel and its MLUPS."""
    out = {}
    for m, lat in lats.items():
        run = run_iterate(dk3, lat, "21", f"bench.py's 48x48x256 channel, "
                          f"{m}, on the band engine",
                          f"cuda_d3q27_band[{m},fuse=2]",
                          tuple(dk3.launch_key(k, m) for k in dk3.KERNELS))
        out[m] = run
    return out


def check_d3q_poiseuille() -> dict:
    """Phase 22: tests/test_models.py's 3D Poiseuille (14x3x4, walls on the
    first axis, BGK nodes, nu 0.1, GravitationX 1e-5, 2000 steps) for
    d3q19 and d3q27_BGK on the kernels in f32, its mean ux profile against
    the f32 eager engine on the card at rtol 2e-5 / atol 2e-6, within 3%
    of the analytic profile (tests/test_models.py's limit), and against
    the f64 eager engine within a relative L2 error of
    POISEUILLE_F64_REL_L2 or, where f32 itself is farther, within twice
    the f32 eager engine's own distance: d3q27_BGK's f32 profile is
    1.27e-3 (the CPU) to 1.35e-3 (the card) from f64 on the eager engine
    and 1.55e-3 on the kernels, because its body force is the difference
    of two ~0.07 equilibria ~1e-6 apart, which f32 resolves to about a
    percent a step; which f32 engine lands nearer f64 is chance."""
    from tclb_tpu_torch import Lattice, get_model
    say("phase 22: the 3D Poiseuille profile on the kernels")
    shape, g, nu, steps = (14, 3, 4), 1e-5, 0.1, 2000
    out = {}
    h = shape[0] - 2
    y = torch.arange(1, shape[0] - 1, dtype=torch.float64)
    ana = g / (2 * nu) * (y - 0.5) * (h + 0.5 - y)
    for name in ("d3q19", "d3q27_BGK"):
        m = get_model(name)
        flags = np.full(shape, m.flag_for("BGK"), dtype=np.uint16)
        flags[0] = flags[-1] = m.flag_for("Wall")
        prof = {}
        for tag, dtype, fast in (("kernels", torch.float32, "1"),
                                 ("eager32", torch.float32, "0"),
                                 ("eager64", torch.float64, "0")):
            before = os.environ.get("TCLB_FASTPATH")
            os.environ["TCLB_FASTPATH"] = fast
            try:
                lat = Lattice(m, shape, dtype=dtype, device=DEVICE,
                              settings={"nu": nu, "GravitationX": g})
                lat.set_flags(flags)
                lat.init()
                lat.iterate(steps)
                lat.synchronize()
            finally:
                if before is None:
                    del os.environ["TCLB_FASTPATH"]
                else:
                    os.environ["TCLB_FASTPATH"] = before
            want_engine = (f"cuda_d3q27_band[{name},fuse=2]"
                           if tag == "kernels" else "eager")
            if lat.engine_name != want_engine:
                fail(f"{name} Poiseuille {tag} ran on {lat.engine_name}")
            prof[tag] = lat.get_quantity("U")[0].double().reshape(
                shape[0], -1).mean(dim=1)[1:-1].cpu()
        e = compare(prof["kernels"], prof["eager32"],
                    f"{name} Poiseuille ux profile, f32 kernels vs f32 eager")
        rel = float((prof["kernels"] - prof["eager64"]).norm()
                    / prof["eager64"].norm())
        rel32 = float((prof["eager32"] - prof["eager64"]).norm()
                      / prof["eager64"].norm())
        ana_err = float(((prof["kernels"] - ana).abs() / ana).max())
        say(f"  {name}: f32 kernels vs f64 eager relative L2 {rel:.3e} "
            f"(f32 eager {rel32:.3e}; limit {POISEUILLE_F64_REL_L2} or twice "
            f"the f32 eager one), vs "
            f"the analytic profile max rel {ana_err:.3e} (limit 0.03)")
        limit = max(POISEUILLE_F64_REL_L2, 2 * rel32)
        if not (rel <= limit and ana_err <= 0.03):
            fail(f"{name} Poiseuille: the f32 kernel profile is off")
        out[name] = {"vs_f32_eager": e, "f32_kernels_vs_f64_rel_l2": rel,
                     "f32_eager_vs_f64_rel_l2": rel32,
                     "vs_analytic_max_rel": ana_err,
                     "ux_max": float(prof["eager64"].max())}
    return out


# --------------------------------------------------------------------------- #
# <Control> time series and <Sample> (phases 23-25)
# --------------------------------------------------------------------------- #


def series_lattice(lat, T: int = 16):
    """``lat`` with a <Control> inlet series on zone 0's Velocity (a
    ramp over ``T`` iterations, so a long run wraps)."""
    lat.set_setting_series("Velocity", np.linspace(0.008, 0.012, T), zone=0)
    return lat


def rich_series_lattice(model: str, device):
    """A rich state that paints every node type ``model`` reads, with
    series on two zones and a horizon of 5 (tests/torch_cases.py)."""
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import (ADJ3D_SETTINGS, ADJ3D_SHAPE, RICH_SETTINGS,
                             add_rich_series, paint_rich, paint_rich_adj3d)
    shape, settings, paint = {
        "d2q9": ((32, 64), RICH_SETTINGS, paint_rich),
        "d3q19_adj": (ADJ3D_SHAPE, ADJ3D_SETTINGS, paint_rich_adj3d)}[model]
    lat = Lattice(get_model(model), shape, dtype=torch.float32,
                  device=device, settings=settings)
    return add_rich_series(paint(lat, seed=5))


def adj3d_control_file(directory) -> pathlib.Path:
    """The 3D Control channel (tests/torch_cases.py:adj3d_control_xml at
    32x64x256, Solve 2000, Log every 500) and its inlet ramp CSV, written
    into ``directory``."""
    from torch_cases import adj3d_control_xml, ramp_csv
    csv = ramp_csv(pathlib.Path(directory) / "ramp.csv")
    path = pathlib.Path(directory) / "adj3d_control.xml"
    path.write_text(adj3d_control_xml(str(csv), "chip"))
    return path


def compare_globals(g, wg, what: str) -> dict:
    """A kernel's SUM globals against its plain version's at rtol 1e-4 /
    atol 1e-6."""
    gerr = (g - wg).abs()
    ok = bool((gerr <= GOLDEN_ATOL + GOLDEN_RTOL * wg.abs()).all()) \
        and bool(torch.isfinite(g).all())
    say(f"  globals {what}: {g.tolist()} vs {wg.tolist()} (rtol "
        f"{GOLDEN_RTOL} atol {GOLDEN_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"globals {what} disagree with the plain version's")
    return {"max_abs_err": float(gerr.max()),
            "max_rel_err": float((gerr / wg.abs().clamp_min(1e-30)).max())}


def check_series_flavours(mod, lats, errs: dict, what: str) -> dict:
    """Both <Control> series flavours of ``mod``'s step kernel
    (``generic2d_step_series``, ``generic3d_step_series``) against their
    plain versions on lattices with a series, at an iteration inside, at
    the end of and past the horizon: fields at rtol 2e-5 / atol 2e-6, the
    series + globals flavour's globals at rtol 1e-4 / atol 1e-6."""
    from tclb_tpu_torch.ops import generic_kernels as gk
    say(f"{what}: the series flavours against their plain versions")
    for lat in lats:
        f, flags, ztab, a = mod.kernel_inputs(lat.model, lat.state,
                                              lat.params)
        series = gk.series_inputs(lat.model, lat.params)
        T = series.horizon
        key, keyg = (f"{k}[{lat.model.name}]" for k in mod.SERIES_KERNELS)
        for it in (0, T - 1, 3 * T + 2):
            got = mod.step_series(f, flags, ztab, a, series, it)
            gotg, g = mod.step_series_globals(f, flags, ztab, a, series, it)
            want, wg = mod.plain_steps(f, flags, ztab, a, 1,
                                       with_globals=True, series=series,
                                       it=it)
            torch.cuda.synchronize()
            at = f"{tuple(f.shape)}, it {it} of T {T}"
            keep_worst(errs, key, compare(got, want, f"{key} at {at}"))
            keep_worst(errs, keyg, compare(gotg, want, f"{keyg} at {at}"))
            keep_worst(errs, f"{keyg} globals",
                       compare_globals(g, wg, f"of {keyg} at {at}"))
    return errs


def _read_log(path) -> tuple:
    lines = pathlib.Path(path).read_text().strip().splitlines()
    return (lines[0].split(","),
            np.array([[float(v) for v in r.split(",")] for r in lines[1:]]))


def run_series_xml(xml, fast: bool, probe=None, csvs=("Log",)) -> dict:
    """``xml`` through ``run_config`` at f32 from a case directory, on the
    kernel engines (``fast``, launches counted from 0) or the eager engine
    (``TCLB_FASTPATH=0``); ``probe(solver)`` is recorded at each Log, and
    the case's ``<stem>_<name>.csv`` read for each of ``csvs``."""
    from tclb_tpu_torch.control.solver import Solver, run_config
    from tclb_tpu_torch.models import get_model
    from tclb_tpu_torch.ops import generic3d_kernels as g3
    from tclb_tpu_torch.ops import generic_kernels as gk
    root = ET.parse(xml).getroot()
    probes = []
    write_log = Solver.write_log

    def recording(self):
        if probe is not None:
            probes.append((self.iter, probe(self)))
        write_log(self)

    cwd, fastpath = os.getcwd(), os.environ.get("TCLB_FASTPATH")
    with case_dir() as tmp:
        os.chdir(tmp)
        if not fast:
            os.environ["TCLB_FASTPATH"] = "0"
        Solver.write_log = recording
        try:
            torch.cuda.synchronize()
            for mod in (gk, g3):
                mod.reset_launches()
            t0 = time.perf_counter()
            solver = run_config(str(xml), get_model(root.get("model")),
                                dtype=torch.float32, device=DEVICE)
            solver.lattice.synchronize()
            wall = time.perf_counter() - t0
            launches = {**gk.LAUNCHES, **gk.SERIES_LAUNCHES, **g3.LAUNCHES,
                        **g3.SERIES_LAUNCHES}
            read = {name: _read_log(os.path.join(
                tmp, root.get("output"), f"{xml.stem}_{name}.csv"))
                for name in csvs}
        finally:
            Solver.write_log = write_log
            os.chdir(cwd)
            if fastpath is None:
                os.environ.pop("TCLB_FASTPATH", None)
            else:
                os.environ["TCLB_FASTPATH"] = fastpath
    return {"solver": solver, "wall_s": wall, "launches": launches,
            "probes": probes, **read}


def run_series_case(mod, xml, phase: str, engine: str, probe,
                    window: int) -> dict:
    """A case under a <Control> series end to end on the card (paths A
    and B): on ``engine`` with no eager step, the series flavour on every
    step but the last of each iterate call (one per Log stop), which is
    the series + globals flavour, and no plain launch; every Log column
    and the final fields against the same XML on the eager f32 engine at
    rtol 1e-4 / atol 1e-6; ``probe(solver)`` (the inlet's mean ux) at each
    Log in a fixed proportion to the series' entry of the iteration before
    it and changing between Logs as the series does.  Then the MLUPS of
    the whole case and of an ``iterate(window)`` window."""
    say(f"phase {phase}: {xml.name} end to end under its <Control> series")
    root = ET.parse(xml).getroot()
    niter = int(root.find("Solve").get("Iterations"))
    stops = niter // int(root.find("Log").get("Iterations"))
    run = run_series_xml(xml, True, probe)
    solver = run["solver"]
    lat = solver.lattice
    launches = {k: v for k, v in run["launches"].items() if v}
    say(f"  engine {lat.engine_name}, {solver.iter} iterations, "
        f"{run['wall_s']:.3f} s wall, launches {launches}, eager steps "
        f"{lat.eager_steps}")
    one, last = mod.SERIES_KERNELS
    if lat.engine_name != engine or lat.eager_steps:
        fail(f"{xml.name} ran on {lat.engine_name} with {lat.eager_steps} "
             "eager steps")
    if launches != {one: niter - stops, last: stops}:
        fail(f"{xml.name}: launches {launches}, not {niter - stops} of "
             f"{one} and {stops} of {last}")
    eager = run_series_xml(xml, False)
    if eager["solver"].lattice.engine_name != "eager":
        fail(f"{xml.name}'s eager run ran on "
             f"{eager['solver'].lattice.engine_name}")
    (head, rows), (ehead, erows) = run["Log"], eager["Log"]
    if head != ehead or rows.shape != erows.shape or len(rows) != stops:
        fail(f"{xml.name}: Log {rows.shape} {head} vs eager {erows.shape}")
    keep = [i for i, h in enumerate(head) if "Walltime" not in h]
    got, want = rows[:, keep], erows[:, keep]
    if not (np.isfinite(got).all() and np.allclose(
            got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)):
        fail(f"{xml.name}: Log columns differ from the eager run's")
    log_err = float(np.abs(got - want).max())
    field = compare(lat.state.fields, eager["solver"].lattice.state.fields,
                    f"{xml.name}'s fields against the eager run's",
                    GOLDEN_RTOL, GOLDEN_ATOL)
    ts = lat.params.time_series[0].double().cpu().numpy()
    its = np.array([it for it, _ in run["probes"]])
    seen = np.array([v for _, v in run["probes"]])
    expect = ts[(its - 1) % len(ts)]
    ratio = seen / expect
    say(f"  inlet mean ux at the Logs {seen.tolist()} against the series "
        f"{expect.tolist()} (ratio {ratio.tolist()}); Log columns within "
        f"{log_err:.3e} of the eager run's")
    if not (np.allclose(ratio, ratio[0], rtol=1e-4)
            and (np.sign(np.diff(seen)) == np.sign(np.diff(expect))).all()
            and (np.diff(expect) != 0).all()):
        fail(f"{xml.name}: the inlet does not follow the series")
    nodes = float(np.prod(lat.shape))
    lat.synchronize()
    t0 = time.perf_counter()
    lat.iterate(window)
    host = time.perf_counter() - t0
    lat.synchronize()
    dt = time.perf_counter() - t0
    out = {"launches": run["launches"], "wall_s": run["wall_s"],
           "eager_steps": lat.eager_steps, "engine": lat.engine_name,
           "mlups_end_to_end": nodes * niter / run["wall_s"] / 1e6,
           "mlups_iterate": nodes * window / dt / 1e6,
           "iterate_ms": dt * 1e3, "iterate_host_ms": host * 1e3,
           "window": window, "eager_wall_s": eager["wall_s"],
           "log_max_abs_err_vs_eager": log_err,
           "fields_vs_eager": field, "inlet_ux": seen.tolist(),
           "inlet_series": expect.tolist(), "lattice": lat}
    say(f"  MLUPS: {out['mlups_end_to_end']:.1f} end to end, "
        f"{out['mlups_iterate']:.1f} in an iterate({window}) window "
        f"({dt * 1e3:.2f} ms, of which {host * 1e3:.2f} ms until iterate "
        f"returned); the eager f32 run took {eager['wall_s']:.2f} s")
    return out


def inlet_ux_2d(solver) -> float:
    """karman_control's inlet: the mean ux of the W velocity column."""
    return float(solver.lattice.get_quantity("U")[0, 1:-1, 0].double()
                 .mean())


def inlet_ux_3d(solver) -> float:
    return float(solver.lattice.get_quantity("U")[0, 1:-1, 1:-1, 0]
                 .double().mean())


SAMPLE_POINTS = ((5, 48), (100, 30), (300, 70))    # (dx, dy)


def run_sample(gk) -> dict:
    """Path C (phase 25): karman_control.xml cut to 500 iterations (Log
    every 250) with a <Sample what="U,Rho"> of three points every 100
    iterations, through ``run_config``: every step on the eager engine by
    selection (no kernel launched, 500 eager steps); its CSV (one row per
    iteration) against the same case stepped one iteration at a time on
    the kernel engine, U and Rho read at the points after each step, at
    rtol 1e-4 / atol 1e-6 (the CSV keeps six significant digits)."""
    say("phase 25: <Sample> on karman_control.xml's lattice")
    from tclb_tpu_torch.ops import generic3d_kernels as g3
    niter = 500
    root = ET.parse(KARMAN_CONTROL_XML).getroot()
    root.find("Solve").set("Iterations", str(niter))
    root.find("Log").set("Iterations", str(niter // 2))
    sample = ET.Element("Sample", {"what": "U,Rho", "Iterations": "100"})
    for dx, dy in SAMPLE_POINTS:
        ET.SubElement(sample, "Point", {"dx": str(dx), "dy": str(dy)})
    root.insert(list(root).index(root.find("Solve")), sample)
    with tempfile.TemporaryDirectory() as tmp:
        xml = pathlib.Path(tmp) / "karman_sampled.xml"
        ET.ElementTree(root).write(xml)
        run = run_series_xml(xml, True, csvs=("Sample",))
    head, rows = run["Sample"]
    lat = run["solver"].lattice
    launched = {k: v for k, v in run["launches"].items() if v}
    say(f"  {len(rows)} sample rows, columns {head}; eager steps "
        f"{lat.eager_steps}, kernel launches {launched}")
    want_head = ["Iteration"] + [
        c for i in range(len(SAMPLE_POINTS))
        for c in (f"U_{i}_x", f"U_{i}_y", f"U_{i}_z", f"Rho_{i}")]
    if head != want_head or rows.shape != (niter, len(want_head)):
        fail(f"<Sample>: CSV {rows.shape} {head}")
    if launched or lat.eager_steps != niter or lat.sampler is not None:
        fail(f"<Sample>: launches {launched}, eager steps "
             f"{lat.eager_steps}")
    ref = case_lattice(KARMAN_CONTROL_XML, torch.float32, DEVICE)
    ys = [dy for _, dy in SAMPLE_POINTS]
    xs = [dx for dx, _ in SAMPLE_POINTS]
    gk.reset_launches()
    got = []
    for _ in range(niter):
        ref.iterate(1)
        u, rho = ref.get_quantity("U"), ref.get_quantity("Rho")
        # the CSV's order: per point U's three components, then Rho
        got.append(torch.cat([torch.cat([u[:, y, x], rho[y, x][None]])
                              for y, x in zip(ys, xs)]))
    kern = torch.stack(got).double().cpu().numpy()
    if ref.engine_name != "cuda_generic_band[d2q9,fuse=1]" \
            or gk.SERIES_LAUNCHES["generic2d_step_series_globals"] != niter:
        fail(f"<Sample>'s kernel run ran on {ref.engine_name}")
    err = np.abs(rows[:, 1:] - kern)
    ok = bool((err <= GOLDEN_ATOL + GOLDEN_RTOL * np.abs(kern)).all())
    say(f"  the CSV against the kernel run's fields: max abs "
        f"{float(err.max()):.3e} (rtol {GOLDEN_RTOL} atol {GOLDEN_ATOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or not np.array_equal(rows[:, 0], np.arange(1, niter + 1)):
        fail("<Sample>: the CSV disagrees with the kernel run")
    return {"rows": len(rows), "columns": head,
            "max_abs_err_vs_kernels": float(err.max()),
            "eager_steps": lat.eager_steps, "wall_s": run["wall_s"],
            "kernel_launches_during_sampling": launched}


def time_series_flavours(mod, lat, reps: int, it: int = 7) -> dict:
    """Both series flavours at ``lat``'s shape (CUDA events), their plain
    versions, their bound (``launch_bytes`` with the series' row map and
    entries) and their wrappers' host time."""
    from tclb_tpu_torch.ops import generic_kernels as gk
    f, flags, ztab, a = mod.kernel_inputs(lat.model, lat.state, lat.params)
    series = gk.series_inputs(lat.model, lat.params)
    n_series = int(series.ts.shape[0])
    out = {}
    for name, fn, g in ((mod.SERIES_KERNELS[0], mod.step_series, False),
                        (mod.SERIES_KERNELS[1], mod.step_series_globals,
                         True)):
        key = f"{name}[{lat.model.name}]"
        out[key] = time_one(
            key, lambda fn=fn: fn(f, flags, ztab, a, series, it),
            lambda g=g: mod.plain_steps(f, flags, ztab, a, 1,
                                        with_globals=g, series=series,
                                        it=it),
            gk.launch_bytes(lat.model, lat.shape, n_series),
            mod.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
            reps)
    return out


def event_ms(fn, reps: int, warm: int = 5) -> float:
    """Device ms per call of ``fn`` between two CUDA events.  A spin kernel
    queued first keeps the card busy while the host enqueues the window,
    so the launches run back to back and host launch cost is not timed."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(min(reps, 1000) * 50_000)   # ~25 us of cycles a call
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_one(name: str, launch, plain, nbytes: int, flops: int, shape,
             reps: int, plain_reps: int = 10) -> dict:
    """One kernel's time (CUDA events), its plain version's, its bound on
    this card from ``nbytes`` and ``flops``, and its wrapper's host time."""
    ms = event_ms(launch, reps)
    plain_ms = event_ms(plain, plain_reps, warm=min(2, plain_reps))
    host_ms = wrapper_host_ms(launch)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    out = {"ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops, "wrapper_host_ms": host_ms,
           "shape": list(shape)}
    say(f"  {name} at {tuple(shape)}: {ms:.4f} ms/launch, plain "
        f"{plain_ms:.3f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}: {nbytes} B, {flops} flop), "
        f"wrapper {host_ms:.4f} ms of host time a call")
    return out


def time_kernels(cases) -> dict:
    """``cases`` lists (kernel module, kernel name, lattice, repeats)."""
    say("phase 7: times (CUDA events) and bounds")
    out = {}
    for dk, name, lat, reps in cases:
        fn, steps = dk.WRAPPERS[name]
        *inputs, a = dk.kernel_inputs(lat.model, lat.state, lat.params)
        key = kernel_key(dk, name, lat)
        out[key] = time_one(
            key, lambda: fn(*inputs, a),
            lambda: dk.plain_steps(*inputs, a, steps),
            dk.launch_bytes(lat.model, lat.shape),
            steps * dk.node_step_flops(lat.model, lat.flags_numpy()),
            lat.shape, reps)
    return out


def time_generic(gk, band_lat, res_lat, resident_steps: int,
                 plain_reps: int = 2) -> dict:
    """One model's generic kernels at their paths' launches:
    ``generic2d_step`` in both flavours on ``band_lat`` (the band engine's
    path), ``generic2d_resident`` on ``res_lat`` at the step count its
    path gives one launch."""
    out = {}
    model = band_lat.model.name
    for name, lat, reps in (("generic2d_step", band_lat, 400),
                            ("generic2d_step globals", band_lat, 200)):
        *inputs, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
        g = name.endswith("globals")
        fn = gk.step_globals if g else gk.step
        key = name.replace("generic2d_step", f"generic2d_step[{model}]")
        out[key] = time_one(
            key, lambda: fn(*inputs, a),
            lambda: gk.plain_steps(*inputs, a, 1, with_globals=g),
            gk.launch_bytes(lat.model, lat.shape),
            gk.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
            reps)
    *inputs, a = gk.kernel_inputs(res_lat.model, res_lat.state,
                                  res_lat.params)
    key = f"generic2d_resident[{model}]"
    out[key] = time_one(
        f"{key} ({resident_steps} steps)",
        lambda: gk.resident(*inputs, a, resident_steps),
        lambda: gk.plain_steps(*inputs, a, resident_steps),
        gk.launch_bytes(res_lat.model, res_lat.shape),
        resident_steps * gk.node_step_flops(res_lat.model,
                                            res_lat.flags_numpy()),
        res_lat.shape, 50, plain_reps=plain_reps)
    out[key]["steps"] = resident_steps
    return out


def time_step_b(ak, gk, lat, plain_reps: int = 10) -> dict:
    """The backward kernel at a gradient's launch (``generic2d_step_b`` at
    512x1024, ``generic3d_step_b`` at 32x64x256), against ``step_b_plain``
    on the same inputs."""
    f, flags, ztab, a = gk.kernel_inputs(lat.model, lat.state, lat.params)
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    lam = torch.randn(f.shape, generator=gen, device=DEVICE)
    lam_g = torch.randn((lat.model.n_globals,), generator=gen, device=DEVICE)
    key = f"generic{lat.model.ndim}d_step_b[{lat.model.name}]"
    return {key: time_one(
        key, lambda: ak.step_b(f, flags, ztab, a, lam, lam_g),
        lambda: ak.step_b_plain(f, flags, ztab, a, lam, lam_g),
        ak.launch_bytes_b(lat.model, lat.shape),
        ak.node_step_b_flops(lat.model, lat.flags_numpy()), lat.shape, 200,
        plain_reps=plain_reps)}


def wrapper_host_ms(launch, calls: int = 200) -> float:
    """Host ms one call of a kernel's wrapper takes to enqueue its launch
    (checks, output allocation, the ctypes call), timed with a host clock
    and no synchronize inside the window."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        launch()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def device_busy(run, what: str) -> dict:
    """Where a window's time goes on the card: a torch.profiler trace of
    ``run()`` (an iterate or a gradient, run once before to warm), the
    union of the kernels' intervals against the host window, and device
    time by kernel name.  Where the trace shows no device activity the
    share is not measured."""
    from torch.profiler import ProfilerActivity, profile
    say(f"phase 8: device busy share over {what}")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    out = {"window": what, "wall_us": wall_us,
           "device_busy_us": busy if spans else None,
           "idle_share": 1.0 - busy / wall_us if spans else None,
           "device_us_by_kernel": dict(sorted(
               by_name.items(), key=lambda kv: -kv[1])[:8])}
    share = ("not measured (no device events in the trace)"
             if out["idle_share"] is None
             else f"{out['idle_share']:.3f}")
    say(f"  {what} under the profiler: {wall_us:.0f} us wall, "
        f"device busy {busy:.0f} us, idle share {share}")
    for k, v in out["device_us_by_kernel"].items():
        say(f"    {v:10.1f} us  {k[:90]}")
    return out


# --------------------------------------------------------------------------- #
# The storage ladder: the bf16 flavours of K4, K5 and K3 (phases 26-30)
# --------------------------------------------------------------------------- #

BF16 = torch.bfloat16
HARNESS_N, HARNESS_NITER = 64, 500     # tests/test_precision.py's size
FLAGSHIP_N, FLAGSHIP_WINDOW = 1024, 2000


def bf16_key(mod, name: str, model: str) -> str:
    """A bf16 kernel's name in the record: ``generic2d_step_bf16[d2q9]``,
    ``d3q27_step2_bf16[d3q19]`` (the cumulant's ``d3q27_step2_bf16``)."""
    if hasattr(mod, "launch_key"):
        return mod.launch_key(f"{name}_bf16", model)
    return f"{name}_bf16[{model}]"


def bf16_copy(lat, storage_repr: str = "shifted"):
    """The same case on a bf16 lattice on the card: flags, params and the
    fields narrowed into ``storage_repr``."""
    import dataclasses
    from tclb_tpu_torch import Lattice
    from tclb_tpu_torch.core import shift as ddf
    b = Lattice(lat.model, lat.shape, dtype=torch.float32, device=DEVICE,
                storage_dtype=BF16, storage_repr=storage_repr)
    b.set_flags(lat.flags_numpy())
    b.params = dataclasses.replace(lat.params)
    b.state = dataclasses.replace(
        lat.state, fields=ddf.narrow_stack(lat.state.fields, BF16,
                                           b._shift_block),
        globals_=lat.state.globals_.clone())
    b.avg_start = lat.avg_start
    return b


def bf16_inputs(mod, lat) -> tuple:
    """``mod.kernel_inputs`` of a bf16 lattice, with its shifts."""
    from tclb_tpu_torch.core import shift as ddf
    return mod.kernel_inputs(lat.model, lat.state, lat.params,
                             ddf.kernel_shift(lat.model, lat.storage_repr))


def wide_plain(mod, lat, n: int, with_globals: bool = False, fields=None):
    """The plain version's f32 values before its one narrowing: ``n``
    plain f32 steps on the widened stack (a bf16 kernel's cadence), from
    ``lat``'s stack or from ``fields``, a bf16 stack of ``lat``'s shape."""
    import dataclasses
    from tclb_tpu_torch.core import shift as ddf
    f, flags, ztab, a = bf16_inputs(mod, lat)
    wide = ddf.widen_stack(f if fields is None else fields, torch.float32,
                           lat._shift_block)
    a32 = dataclasses.replace(a, shift=None)
    if with_globals:
        return mod.plain_steps(wide, flags, ztab, a32, n, with_globals=True)
    return mod.plain_steps(wide, flags, ztab, a32, n)


def compare_narrowed(got, wide, lat, what: str, quiet: bool = False
                     ) -> dict:
    """A bf16 kernel's output against its plain version's compute values
    before their one narrowing: the f32 tolerance (rtol 2e-5 / atol 2e-6
    on the raw values) carried through the narrowing
    (``core/shift.py:narrowed_bounds``).  Where the kernel's f32 values
    equal the plain version's the stored bits are equal; where they sit
    an ulp apart a value that straddles a bf16 rounding boundary may take
    the other neighbour.  The error printed is that of the widened raw
    fields against the narrowed plain output; ``flips`` counts the values
    whose bits differ.  ``quiet``: print only a failure."""
    from tclb_tpu_torch.core import shift as ddf
    sb = lat._shift_block
    lo, hi = ddf.narrowed_bounds(wide, BF16, sb, RTOL, ATOL)
    s = got.double()
    ok = bool(((s >= lo.double()) & (s <= hi.double())).all())
    want = ddf.narrow_stack(wide, BF16, sb)
    g_raw = ddf.widen_stack(got, torch.float32, sb)
    w_raw = ddf.widen_stack(want, torch.float32, sb)
    err = (g_raw - w_raw).abs()
    flips = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    out = {"max_abs_err": float(err.max()),
           "max_rel_err": float((err / w_raw.abs().clamp_min(1e-30)).max()),
           "flips": flips, "values": int(got.numel())}
    finite = bool(torch.isfinite(g_raw).all())
    if quiet and ok and finite:
        return out
    say(f"  {what}: max_abs {out['max_abs_err']:.3e} max_rel "
        f"{out['max_rel_err']:.3e}, {flips} of {got.numel()} values a bf16 "
        f"step from the narrowed plain output, all within the f32 tolerance "
        f"(rtol {RTOL} atol {ATOL}) carried through the narrowing: "
        f"{'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        fail(f"{what} disagrees with its plain version")
    return out


def check_bf16_kernels(cases, errs: dict, what: str) -> dict:
    """Phase 26: each one-narrowing bf16 kernel against its plain version
    on the same bf16 inputs.  ``cases`` lists (module, bf16 lattice,
    kernel name); ``generic2d_step`` is checked in both flavours (the
    globals at rtol 1e-4 / atol 1e-6)."""
    say(f"{what}: bf16 kernels against their plain versions on the card")
    for mod, lat, name in cases:
        fn, n = mod.WRAPPERS[name]
        *inputs, a = bf16_inputs(mod, lat)
        key = bf16_key(mod, name, lat.model.name)
        tag = f"{key} ({lat.storage_repr}) at {tuple(inputs[0].shape)}"
        got = fn(*inputs, a)
        torch.cuda.synchronize()
        keep_worst(errs, key, compare_narrowed(
            got, wide_plain(mod, lat, n), lat, tag))
        if name == "generic2d_step":
            got, g = mod.step_globals(*inputs, a)
            wide, wg = wide_plain(mod, lat, 1, with_globals=True)
            torch.cuda.synchronize()
            keep_worst(errs, key, compare_narrowed(
                got, wide, lat, f"{tag}, globals flavour"))
            gerr = (g - wg).abs()
            ok = bool((gerr <= GOLDEN_ATOL + GOLDEN_RTOL * wg.abs()).all()) \
                and bool(torch.isfinite(g).all())
            say(f"  its globals: {g.tolist()} vs {wg.tolist()} (rtol "
                f"{GOLDEN_RTOL} atol {GOLDEN_ATOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{tag}: globals disagree")
            keep_worst(errs, f"{key} globals",
                       {"max_abs_err": float(gerr.max()),
                        "max_rel_err": float(
                            (gerr / wg.abs().clamp_min(1e-30)).max())})
    return errs


def check_bf16_resident(gk, lat, nsteps: int, errs: dict, what: str) -> dict:
    """Phase 26, K5: ``generic2d_resident_bf16`` narrows once a step, and
    its step is ``generic2d_step_bf16``'s device code.  Each of ``nsteps``
    chained ``generic2d_step_bf16`` launches is held against its plain
    version from the same input (the f32 tolerance carried through the
    narrowing, ``compare_narrowed``), and the resident launch equals that
    chain bit for bit: so each of its steps is held too.  Against
    ``nsteps`` narrowed eager steps from the start: at the f32 tolerance
    on the widened raw fields where the model's f32 kernels equal their
    plain versions bit for bit (d2q9_kuper); for d2q9, whose header sums
    rho in plane order, a value one bf16 step off moves the next steps'
    inputs, so that error is reported, not held."""
    from tclb_tpu_torch.core import shift as ddf
    f, flags, ztab, a = bf16_inputs(gk, lat)
    key = bf16_key(gk, "generic2d_resident", lat.model.name)
    tag = f"{key} ({lat.storage_repr}, {nsteps} steps) at {tuple(f.shape)}"
    got = gk.resident(f, flags, ztab, a, nsteps)
    chain = f
    e = {"max_abs_err": 0.0, "max_rel_err": 0.0, "flips": 0}
    for i in range(nsteps):
        nxt = gk.step(chain, flags, ztab, a)
        one = compare_narrowed(
            nxt, wide_plain(gk, lat, 1, fields=chain), lat,
            f"{tag}: generic2d_step_bf16 launch {i + 1} of the chain",
            quiet=True)
        e = {k: max(e[k], one[k]) for k in e}
        chain = nxt
    torch.cuda.synchronize()
    say(f"{what}: {tag}: each of {nsteps} chained generic2d_step_bf16 "
        f"launches against its plain version from the same input: max_abs "
        f"{e['max_abs_err']:.3e} max_rel {e['max_rel_err']:.3e}, at most "
        f"{e['flips']} values a bf16 step off, all within the f32 "
        f"tolerance carried through the narrowing: ok")
    same = torch.equal(got.view(torch.int16), chain.view(torch.int16))
    say(f"  {tag} against the {nsteps} chained launches: "
        f"{'bit-identical' if same else 'DIFFERS'}")
    if not same:
        fail(f"{tag} differs from {nsteps} generic2d_step_bf16 launches")
    want = gk.plain_steps(f, flags, ztab, a, nsteps)
    sb = lat._shift_block
    g_raw = ddf.widen_stack(got, torch.float32, sb)
    w_raw = ddf.widen_stack(want, torch.float32, sb)
    err = (g_raw - w_raw).abs()
    eager = {"max_abs_err": float(err.max()),
             "flips": int((got.view(torch.int16)
                           != want.view(torch.int16)).sum())}
    if lat.model.name == "d2q9":
        say(f"  {tag} against {nsteps} narrowed eager steps from the start: "
            f"max_abs {eager['max_abs_err']:.3e}, {eager['flips']} values "
            "differ (reported)")
    else:
        compare(g_raw, w_raw, f"{tag} against {nsteps} narrowed eager "
                "steps from the start (widened raw fields)")
    e["chain_bit_identical"] = same
    e["eager_max_abs_err"] = eager["max_abs_err"]
    keep_worst(errs, key, e)
    return errs


def harness_phase(gk) -> dict:
    """Phase 27: the precision harness (``tclb_tpu_torch.precision``) on
    the card: both cases, both representations, 64x64, 500 steps, each
    run on the engines ``Lattice`` selects (the bf16 runs on
    ``cuda_generic_resident[...,bfloat16/<repr>]``), within
    ``ERROR_BOUNDS``; the shifted cavity's u_linf at least 10x below raw's
    at every checkpoint.  Counted from 0."""
    from tclb_tpu_torch import precision
    say(f"phase 27: the precision harness on the kernels ({HARNESS_N}x"
        f"{HARNESS_N}, {HARNESS_NITER} steps)")
    t0 = time.perf_counter()
    reports, launches = [], {}
    for case in precision.CASE_NAMES:
        gk.reset_launches()
        reports += precision.compare_reprs(case, niter=HARNESS_NITER,
                                           n=HARNESS_N, device=DEVICE)
        launches[case] = {
            **{k: gk.LAUNCHES[k] for k in gk.BF16_KERNELS},
            "globals": gk.flavours("generic2d_step_bf16")["globals"]}
    wall = time.perf_counter() - t0
    precision._print_text(reports)
    models = {"cavity": "d2q9", "kuper_drop": "d2q9_kuper"}
    for rep in reports:
        want = (f"cuda_generic_resident[{models[rep['case']]},fuse=N,"
                f"bfloat16/{rep['storage_repr']}]")
        if rep["engine"] != want:
            fail(f"harness {rep['case']} ran on {rep['engine']}")
        v = precision.check_bounds(rep)
        if v or not all(r["l2"] > 0 for r in rep["checkpoints"]):
            fail(f"harness: {v or 'no error measured'}")
    cav = {r["storage_repr"]: r for r in reports if r["case"] == "cavity"}
    ratios = [rr["u_linf"] / rs["u_linf"] for rr, rs in zip(
        cav["raw"]["checkpoints"], cav["shifted"]["checkpoints"])]
    say(f"  within ERROR_BOUNDS; cavity u_linf raw / shifted "
        f"{[round(r, 2) for r in ratios]} (at least 10); bf16 launches "
        f"{launches}; {wall:.2f} s")
    if min(ratios) < 10:
        fail(f"shifted cavity u_linf only {min(ratios):.2f}x below raw")
    return {"reports": reports, "u_linf_raw_over_shifted": ratios,
            "launches": launches, "wall_s": wall}


def flagship_lattice(storage_dtype=None, storage_repr=None):
    """bench.py's ``bench_precision_ladder`` case (bench.py:818-870): d2q9
    at 1024x1024, MRT everywhere, walls top and bottom, nu 0.02, Velocity
    0.01."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9")
    n = FLAGSHIP_N
    lat = Lattice(m, (n, n), dtype=torch.float32, device=DEVICE,
                  settings={"nu": 0.02, "Velocity": 0.01},
                  storage_dtype=storage_dtype, storage_repr=storage_repr)
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[0, :] = flags[-1, :] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    return lat


def flagship_phase(gk) -> dict:
    """Phase 28: the flagship through the port: f32 (K1/K2 by selection),
    f32 on the generic engine (the same engine as bf16), bf16 shifted and
    bf16 raw (K4): each engine's tag and MLUPS over an
    ``iterate(FLAGSHIP_WINDOW)`` fenced by synchronize, and the ratios.
    No floor is asserted."""
    say(f"phase 28: bench.py's bf16 flagship, d2q9 {FLAGSHIP_N}x"
        f"{FLAGSHIP_N}, iterate({FLAGSHIP_WINDOW}) windows")
    runs = {}
    for label, sdt, repr_, generic in (
            ("f32", None, None, False), ("f32_generic", None, None, True),
            ("bf16_shifted", BF16, "shifted", False),
            ("bf16_raw", BF16, "raw", False)):
        lat = flagship_lattice(sdt, repr_)
        if generic:
            lat._fast, lat._fast_name = gk.select_engine(
                lat.model, lat.shape, lat.dtype)
            lat._fast_tried = True
        lat.iterate(10)
        lat.synchronize()
        gk.reset_launches()
        t0 = time.perf_counter()
        lat.iterate(FLAGSHIP_WINDOW)
        lat.synchronize()
        dt = time.perf_counter() - t0
        mlups = FLAGSHIP_N * FLAGSHIP_N * FLAGSHIP_WINDOW / dt / 1e6
        if not bool(torch.isfinite(lat.state.fields.float()).all()):
            fail(f"flagship {label}: non-finite fields")
        runs[label] = {"engine": lat.engine_name, "mlups_iterate": mlups,
                       "iterate_ms": dt * 1e3,
                       "bf16_launches": {
                           **{k: gk.LAUNCHES[k] for k in gk.BF16_KERNELS},
                           "globals": gk.flavours(
                               "generic2d_step_bf16")["globals"]},
                       "lattice": lat}
        say(f"  {label}: engine {lat.engine_name}, {mlups:.1f} MLUPS "
            f"({dt * 1e3:.2f} ms), bf16 launches "
            f"{ {k: gk.LAUNCHES[k] for k in gk.BF16_KERNELS} }")
    want = {"f32": "cuda_d2q9_band[d2q9,fuse=2]",
            "f32_generic": "cuda_generic_band[d2q9,fuse=1]",
            "bf16_shifted": "cuda_generic_band[d2q9,fuse=1,bfloat16/shifted]",
            "bf16_raw": "cuda_generic_band[d2q9,fuse=1,bfloat16/raw]"}
    for label, engine in want.items():
        if runs[label]["engine"] != engine:
            fail(f"flagship {label} ran on {runs[label]['engine']}")
    for label in ("bf16_shifted", "bf16_raw"):
        if runs[label]["bf16_launches"]["generic2d_step_bf16"] \
                != FLAGSHIP_WINDOW:
            fail(f"flagship {label}: {runs[label]['bf16_launches']}")
    m = {k: v["mlups_iterate"] for k, v in runs.items()}
    out = {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "lattice"}
                    for k, v in runs.items()},
           "bf16_over_f32": m["bf16_shifted"] / m["f32"],
           "bf16_raw_over_f32": m["bf16_raw"] / m["f32"],
           "bf16_over_f32_same_engine": m["bf16_shifted"] / m["f32_generic"],
           "bf16_raw_over_f32_same_engine": m["bf16_raw"] / m["f32_generic"],
           "lattice": runs["bf16_shifted"]["lattice"]}
    say(f"  bf16 (shifted) / f32: {out['bf16_over_f32']:.3f} across engines "
        f"(K4 over K1/K2, as the JAX package reports it), "
        f"{out['bf16_over_f32_same_engine']:.3f} on the same engine (K4); "
        f"raw {out['bf16_raw_over_f32']:.3f} / "
        f"{out['bf16_raw_over_f32_same_engine']:.3f}; card "
        f"{card_line()}")
    return out


def channel3d_bf16_phase(dk3) -> dict:
    """Phase 29: example/3d_channel.xml's lattice (48x48x256,
    d3q27_cumulant) in bf16 shifted on K3 and in f32, the Solve's 20000
    steps as its Log interval cuts them (iterate(2000) ten times), each
    fenced by synchronize: MLUPS, the launches and the relative L2 of U
    against the f32 run (reported: the JAX package pins no 3D bound)."""
    say("phase 29: 3d_channel.xml's lattice in bf16 shifted on K3")
    root = ET.parse(CHANNEL3D_XML).getroot()
    niter = int(root.find("Solve").get("Iterations"))
    chunk = int(root.find("Log").get("Iterations"))
    base = case_lattice(CHANNEL3D_XML, torch.float32, DEVICE)
    out = {}
    for label, lat in (("f32", base), ("bf16_shifted", bf16_copy(base))):
        lat.synchronize()
        dk3.reset_launches()
        t0 = time.perf_counter()
        for _ in range(niter // chunk):
            lat.iterate(chunk)
        lat.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in dk3.LAUNCHES.items() if v}
        out[label] = {"engine": lat.engine_name, "wall_s": dt,
                      "mlups": float(np.prod(lat.shape)) * niter / dt / 1e6,
                      "launches": launches, "lattice": lat}
        say(f"  {label}: engine {lat.engine_name}, {niter} steps in "
            f"{dt:.3f} s, {out[label]['mlups']:.1f} MLUPS, launches "
            f"{launches}")
    if out["bf16_shifted"]["engine"] != \
            "cuda_d3q27_band[d3q27_cumulant,fuse=2,bfloat16/shifted]":
        fail(f"3d_channel bf16 ran on {out['bf16_shifted']['engine']}")
    u32 = out["f32"]["lattice"].get_quantity("U").double()
    u16 = out["bf16_shifted"]["lattice"].get_quantity("U").double()
    if not bool(torch.isfinite(u16).all()):
        fail("3d_channel bf16: non-finite U")
    rel = float((u16 - u32).norm() / u32.norm())
    out["u_rel_l2_vs_f32"] = rel
    out["mean_ux"] = {"f32": float(u32[0].mean()),
                      "bf16_shifted": float(u16[0].mean())}
    say(f"  U of the bf16 run against the f32 run: relative L2 {rel:.3e}; "
        f"mean ux {out['mean_ux']['bf16_shifted']:.4e} against "
        f"{out['mean_ux']['f32']:.4e} (reported, not held)")
    return out


def channel48_bf16_phase(dk3, models) -> dict:
    """Phase 29b: bench.py's 48x48x256 channel for each other z-slab
    model in bf16 shifted, ``iterate(2002)`` on
    ``cuda_d3q27_band[<model>,fuse=2,bfloat16/shifted]``: the launches and
    the MLUPS."""
    out = {}
    for m in models:
        lat = bf16_copy(channel48_lattice(m, DEVICE))
        say(f"phase 29b: the 48x48x256 {m} channel in bf16 shifted")
        lat.synchronize()
        dk3.reset_launches()
        t0 = time.perf_counter()
        lat.iterate(2002)
        lat.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in dk3.LAUNCHES.items() if "bf16" in k}
        mlups = float(np.prod(lat.shape)) * 2002 / dt / 1e6
        say(f"  engine {lat.engine_name}, launches "
            f"{ {k: v for k, v in launches.items() if v} }, {mlups:.1f} "
            "MLUPS")
        if lat.engine_name != f"cuda_d3q27_band[{m},fuse=2,bfloat16/shifted]":
            fail(f"{m} bf16 ran on {lat.engine_name}")
        if not bool(torch.isfinite(lat.state.fields.float()).all()):
            fail(f"{m} bf16: non-finite fields")
        out[m] = {"launches": launches, "mlups_iterate": mlups,
                  "lattice": lat}
    return out


def walled_cavity(storage_dtype=None, n: int = 16):
    """tests/test_shift.py's cavity: d2q9, walls top and bottom, nu 0.05,
    Velocity 0.02, initialised."""
    from tclb_tpu_torch import Lattice, get_model
    m = get_model("d2q9")
    lat = Lattice(m, (n, n), dtype=torch.float32, device=DEVICE,
                  settings={"nu": 0.05, "Velocity": 0.02},
                  storage_dtype=storage_dtype)
    flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
    flags[0] = flags[-1] = m.flag_for("Wall")
    lat.set_flags(flags)
    lat.init()
    return lat


def checkpoint_phase() -> dict:
    """Phase 30: a save/load round trip of bf16 shifted lattices on the
    card: bit-exact at rest in the same representation; through a raw f32
    lattice within 1e-6; and back to shifted bf16, every value to within
    the f32 rounding of its raw value f + w (the values that differ are
    counted; on the JAX package's own test state none do).
    The states: tests/test_shift.py:177-222's (its walled 16x16 cavity
    after 12 steps) and the developed 64x64 harness cavity (500 steps)."""
    from tclb_tpu_torch import precision
    from tclb_tpu_torch.core import shift as ddf
    say("phase 30: bf16 shifted checkpoints on the card")
    out = {}
    makers = {
        "test_shift_state": (lambda sdt=None: walled_cavity(sdt), 12),
        "harness_cavity": (lambda sdt=None: precision.case_lattice(
            "cavity", HARNESS_N, sdt, None, DEVICE), HARNESS_NITER)}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (make, steps) in makers.items():
            sh = make(BF16)
            sh.iterate(steps)
            p = os.path.join(tmp, f"{label}.npz")
            sh.save(p)
            same = make(BF16)
            same.load(p)
            exact = torch.equal(same.state.fields.view(torch.int16),
                                sh.state.fields.view(torch.int16))
            wide = make()
            wide.load(p)
            to_f32 = float(abs(wide.fields_raw() - sh.fields_raw()).max())
            q = os.path.join(tmp, f"{label}_f32.npz")
            wide.save(q)
            back = make(BF16)
            back.load(q)
            differ = (back.state.fields.view(torch.int16)
                      != sh.state.fields.view(torch.int16)).cpu().numpy()
            # a value comes back to within the f32 rounding of f + w: the
            # raw f32 lattice holds f32(dev + w)
            dev = sh.state.fields.double().cpu().numpy()
            w = ddf._bshape(ddf.storage_shift(sh.model), dev.ndim)
            e = np.abs(dev + w) * 2.0 ** -24 * (1 + 2.0 ** -20)
            lo = torch.from_numpy(dev - e).to(BF16).double().numpy()
            hi = torch.from_numpy(dev + e).to(BF16).double().numpy()
            got = back.state.fields.double().cpu().numpy()
            explained = bool(np.all((got >= lo) & (got <= hi)))
            out[label] = {"same_repr_bit_exact": exact,
                          "to_f32_max_abs": to_f32,
                          "round_trip_differ": int(differ.sum()),
                          "values": int(differ.size)}
            say(f"  {label} ({tuple(sh.shape)}, {steps} steps on "
                f"{sh.engine_name}): same-repr load "
                f"{'bit-exact' if exact else 'DIFFERS'}; to raw f32 max "
                f"{to_f32:.2e}; back to shifted bf16: {int(differ.sum())} "
                f"of {differ.size} values differ, every value within the "
                f"f32 rounding of f + w")
            if not exact or to_f32 > 1e-6 or not explained:
                fail(f"checkpoint round trip {label}: {out[label]}")
    return out


HARNESS_RES_STEPS = 98     # one resident launch of the harness's iterate(100)


def run_ladder(gk, dk3, errs: dict, channel, drop1024, control, channel3d,
               turb, channel48) -> dict:
    """Phases 26-30 (the storage ladder) on the card, and the bf16
    kernels' launches by path, their lattices for phase 7 and the summary
    line's record."""
    from tclb_tpu_torch import Lattice, get_model, precision
    from torch_cases import (KUPER_SETTINGS, RICH3D_SETTINGS,
                             paint_rich_3d, paint_rich_kuper)
    kuper96 = paint_rich_kuper(Lattice(
        get_model("d2q9_kuper"), (96, 512), dtype=torch.float32,
        device=DEVICE, settings=KUPER_SETTINGS), seed=5)
    rich48 = paint_rich_3d(Lattice(
        get_model("d3q27_cumulant"), CHANNEL48, dtype=torch.float32,
        device=DEVICE, settings=RICH3D_SETTINGS), seed=5)
    k4 = [channel, control, drop1024, kuper96]
    k3 = [rich48, channel3d, turb] + list(channel48.values())
    harness = {}
    for case in precision.CASE_NAMES:
        for repr_ in ("raw", "shifted"):
            lat = precision.case_lattice(case, HARNESS_N, BF16, repr_,
                                         DEVICE)
            lat.iterate(100)
            harness[(case, repr_)] = lat
    for repr_ in ("raw", "shifted"):
        check_bf16_kernels(
            [(gk, bf16_copy(lat, repr_), "generic2d_step") for lat in k4]
            + [(dk3, bf16_copy(lat, repr_), name) for lat in k3
               for name in dk3.KERNELS], errs,
            f"phase 26 ({repr_})")
        for case in precision.CASE_NAMES:
            check_bf16_resident(gk, harness[(case, repr_)],
                                HARNESS_RES_STEPS, errs,
                                f"phase 26 ({repr_}, {case})")
    harness_out = harness_phase(gk)
    flagship = flagship_phase(gk)
    ch3d = channel3d_bf16_phase(dk3)
    ch48 = channel48_bf16_phase(dk3, channel48)
    ckpt = checkpoint_phase()
    # the developed bf16 states of the paths (after their counts were read)
    check_bf16_kernels(
        [(gk, flagship["lattice"], "generic2d_step"),
         (dk3, ch3d["bf16_shifted"]["lattice"], "d3q27_step"),
         (dk3, ch3d["bf16_shifted"]["lattice"], "d3q27_step2")]
        + [(dk3, v["lattice"], name) for v in ch48.values()
           for name in dk3.KERNELS], errs,
        "phase 26b, the paths' developed bf16 states")
    h = harness_out["launches"]
    fl = flagship["runs"]
    launches = {
        "generic2d_step_bf16[d2q9]": {
            "flagship": sum(fl[k]["bf16_launches"]["generic2d_step_bf16"]
                            for k in ("bf16_shifted", "bf16_raw")),
            "harness_cavity": h["cavity"]["generic2d_step_bf16"]},
        "generic2d_resident_bf16[d2q9]": {
            "harness_cavity": h["cavity"]["generic2d_resident_bf16"]},
        "generic2d_step_bf16[d2q9_kuper]": {
            "harness_kuper_drop": h["kuper_drop"]["generic2d_step_bf16"]},
        "generic2d_resident_bf16[d2q9_kuper]": {
            "harness_kuper_drop":
                h["kuper_drop"]["generic2d_resident_bf16"]}}
    launches.update({k: {"3d_channel_bf16": v} for k, v in
                     ch3d["bf16_shifted"]["launches"].items()
                     if "bf16" in k})
    launches.update({k: {"channel48_bf16": n} for v in ch48.values()
                     for k, n in v["launches"].items() if n})
    # the globals flavour's share of generic2d_step_bf16's launches
    globals_launches = {
        "generic2d_step_bf16[d2q9]": {
            "flagship": sum(fl[k]["bf16_launches"]["globals"]
                            for k in ("bf16_shifted", "bf16_raw")),
            "harness_cavity": h["cavity"]["globals"]},
        "generic2d_step_bf16[d2q9_kuper]": {
            "harness_kuper_drop": h["kuper_drop"]["globals"]}}
    summary = {
        "harness": {"u_linf_raw_over_shifted":
                    harness_out["u_linf_raw_over_shifted"],
                    "wall_s": harness_out["wall_s"],
                    "reports": harness_out["reports"]},
        "flagship": {k: v for k, v in flagship.items() if k != "lattice"},
        "3d_channel_bf16": {
            "u_rel_l2_vs_f32": ch3d["u_rel_l2_vs_f32"],
            "mean_ux": ch3d["mean_ux"],
            **{label: {k: v for k, v in ch3d[label].items()
                       if k != "lattice"} for label in ("f32",
                                                        "bf16_shifted")}},
        "channel48_bf16_mlups_iterate": {m: v["mlups_iterate"]
                                         for m, v in ch48.items()},
        "checkpoints": ckpt}
    return {"launches": launches, "globals_launches": globals_launches,
            "summary": summary,
            "band": {"d2q9": flagship["lattice"],
                     "d2q9_kuper": bf16_copy(drop1024)},
            "resident": {"d2q9": harness[("cavity", "shifted")],
                         "d2q9_kuper": harness[("kuper_drop", "shifted")]},
            "d3": {"d3q27_cumulant": ch3d["bf16_shifted"]["lattice"],
                   **{m: v["lattice"] for m, v in ch48.items()}}}


def time_bf16(gk, dk3, band: dict, res: dict, d3: dict,
              res_steps: int) -> dict:
    """Phase 7 for the bf16 kernels at their paths' shapes: K4 (both
    flavours) on ``band`` lattices, K5 for ``res_steps`` on ``res``
    lattices, K3 on ``d3`` lattices; the bound at 2 B a value at rest."""
    out = {}
    for lat in band.values():
        f, flags, ztab, a = bf16_inputs(gk, lat)
        key = bf16_key(gk, "generic2d_step", lat.model.name)
        for k, fn, g, reps in ((key, gk.step, False, 400),
                               (f"{key} globals", gk.step_globals, True,
                                200)):
            out[k] = time_one(
                k, lambda fn=fn: fn(f, flags, ztab, a),
                lambda g=g: gk.plain_steps(f, flags, ztab, a, 1,
                                           with_globals=g),
                gk.launch_bytes(lat.model, lat.shape, itemsize=2),
                gk.node_step_flops(lat.model, lat.flags_numpy()), lat.shape,
                reps)
    for lat in res.values():
        f, flags, ztab, a = bf16_inputs(gk, lat)
        key = bf16_key(gk, "generic2d_resident", lat.model.name)
        out[key] = time_one(
            f"{key} ({res_steps} steps)",
            lambda: gk.resident(f, flags, ztab, a, res_steps),
            lambda: gk.plain_steps(f, flags, ztab, a, res_steps),
            gk.launch_bytes(lat.model, lat.shape, itemsize=2),
            res_steps * gk.node_step_flops(lat.model, lat.flags_numpy()),
            lat.shape, 50, plain_reps=2)
        out[key]["steps"] = res_steps
    for lat in d3.values():
        *inputs, a = bf16_inputs(dk3, lat)
        for name, reps in (("d3q27_step", 400), ("d3q27_step2", 200)):
            fn, steps = dk3.WRAPPERS[name]
            key = bf16_key(dk3, name, lat.model.name)
            out[key] = time_one(
                key, lambda fn=fn: fn(*inputs, a),
                lambda steps=steps: dk3.plain_steps(*inputs, a, steps),
                dk3.launch_bytes(lat.model, lat.shape, itemsize=2),
                steps * dk3.node_step_flops(lat.model, lat.flags_numpy()),
                lat.shape, reps)
    return out


def main() -> int:
    if not all((ROOT / "tclb_tpu_torch" / "csrc" / src).is_file()
               for src in SOURCES.values()):
        print("chip_smoke: run from a checkout of the repository (no "
              "tclb_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from tclb_tpu_torch.ops import adjoint_kernels as ak
    from tclb_tpu_torch.ops import d2q9_kernels as dk
    from tclb_tpu_torch.ops import d3q27_kernels as dk3
    from tclb_tpu_torch.ops import generic3d_kernels as g3
    from tclb_tpu_torch.ops import generic_kernels as gk

    say(card_line())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    say("phase 1: build (one nvcc per library, started together)")
    t0 = time.perf_counter()
    jobs = [dk.build, dk3.build] + [
        (lambda m=m: gk.build(m)) for m in GENERIC_MODELS] + [
        (lambda m=m: dk.build(m)) for m in dk.FAMILY] + [
        (lambda m=m: dk3.build(m)) for m in D3Q_FAMILY]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(lambda job: job(), jobs))
    say(f"  built {', '.join(p.name for p, _ in builds)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for path, report in builds:
        for line in report.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling" in line:
                say(f"  ptxas ({path.name}): {line.strip()}")

    karman = case_lattice(KARMAN_XML, torch.float32, DEVICE)
    eager_warm(karman, 200)
    channel = channel_lattice(DEVICE)
    eager_warm(channel, 20)
    channel3d = case_lattice(CHANNEL3D_XML, torch.float32, DEVICE)
    eager_warm(channel3d, 4)
    rich3d = rich3d_lattice(DEVICE)
    drop = case_lattice(DROP_XML, torch.float32, DEVICE)
    eager_warm(drop, 100)
    drop1024 = drop_lattice(DEVICE)
    eager_warm(drop1024, 4)
    rich_kuper = rich_kuper_lattice(DEVICE)
    rich_heat = rich_heat_lattice(DEVICE)
    heat1024 = heat1024_lattice(DEVICE)
    eager_warm(heat1024, 20)
    case_tmp = tempfile.TemporaryDirectory()
    adj3d_xml = adj3d_case_file(case_tmp.name)
    rich_adj3d = rich_adj3d_lattice(DEVICE)
    adj3d_init = case_lattice(adj3d_xml, torch.float32, DEVICE,
                              drop=ADJ3D_HANDLERS)
    eager_warm(adj3d_init, 4)
    bench3d = bench3d_lattice(DEVICE)
    # the d2q9 family: a rich state each, the paths' starting states
    # (bench.py's channels at 1024x1024, for d2q9_inc and d2q9_new also at
    # 128x1024) warmed a few steps
    rich_family = [rich_family_lattice(m, DEVICE) for m in dk.FAMILY]
    family_band = {m: family_channel_lattice(m, DEVICE, (1024, 1024))
                   for m in dk.FAMILY}
    family_res = {m: family_channel_lattice(m, DEVICE, (128, 1024))
                  for m in ("d2q9_inc", "d2q9_new")}
    for lat in list(family_band.values()) + list(family_res.values()):
        eager_warm(lat, 20)
    # the rest of the z-slab family: a rich state each and path B's
    # starting states; path A's state with SynthT planes drawn
    rich_d3q = [rich_d3q_lattice(m, DEVICE) for m in D3Q_FAMILY]
    channel48 = {m: channel48_lattice(m, DEVICE) for m in D3Q_FAMILY}
    for lat in channel48.values():
        eager_warm(lat, 4)
    turb = turbulence_lattice(DEVICE)
    # the Control series: rich states with series on two zones (horizon 5),
    # the starting states of paths A and B (their series from their
    # <Control>), bench.py's 1024x1024 d2q9 channel under an inlet series,
    # and a rich d2q9 state without one (d2q9's plain generic kernels)
    from tclb_tpu_torch import Lattice, get_model
    from torch_cases import RICH_SETTINGS, paint_rich
    rich_series = {m: rich_series_lattice(m, DEVICE)
                   for m in ("d2q9", "d3q19_adj")}
    control_init = case_lattice(KARMAN_CONTROL_XML, torch.float32, DEVICE)
    eager_warm(control_init, 200)
    adj3d_control_xml = adj3d_control_file(case_tmp.name)
    control3d_init = case_lattice(adj3d_control_xml, torch.float32, DEVICE)
    eager_warm(control3d_init, 4)
    channel_series = series_lattice(channel_lattice(DEVICE))
    eager_warm(channel_series, 20)
    rich_d2q9 = paint_rich(Lattice(get_model("d2q9"), (32, 64),
                                   dtype=torch.float32, device=DEVICE,
                                   settings=RICH_SETTINGS), seed=5)
    errs = check_kernels([
        (dk, karman, "d2q9_resident8"), (dk, karman, "d2q9_step"),
        (dk, channel, "d2q9_step2"), (dk, channel, "d2q9_step"),
        (dk3, channel3d, "d3q27_step"), (dk3, channel3d, "d3q27_step2"),
        (dk3, rich3d, "d3q27_step"), (dk3, rich3d, "d3q27_step2"),
        (gk, drop, "generic2d_step"), (gk, drop, "generic2d_resident"),
        (gk, drop1024, "generic2d_step"),
        (gk, drop1024, "generic2d_resident"),
        (gk, rich_kuper, "generic2d_step"),
        (gk, rich_kuper, "generic2d_resident"),
        (gk, rich_heat, "generic2d_step"),
        (gk, rich_heat, "generic2d_resident"),
        (gk, heat1024, "generic2d_step"),
        (gk, heat1024, "generic2d_resident"),
        (g3, rich_adj3d, "generic3d_step"),
        (g3, adj3d_init, "generic3d_step")] + [
        (dk, lat, name) for lat in rich_family
        + list(family_band.values()) + list(family_res.values())
        for name in dk.KERNELS] + [
        (dk3, lat, name) for lat in rich_d3q + list(channel48.values())
        + [turb] for name in dk3.KERNELS], {}, "phase 2")
    check_globals_flavour(gk, (drop, drop1024, rich_kuper, rich_heat,
                               heat1024), errs, "phase 2")
    check_globals_flavour(g3, (rich_adj3d, adj3d_init), errs, "phase 2")
    # d2q9's generic kernels without a series (no path runs them: d2q9
    # takes K1/K2 there) on the rich state, bench.py's 1024x1024 channel
    # and karman.xml's state (the resident kernel where it fits the L2)
    check_kernels([(gk, rich_d2q9, "generic2d_step"),
                   (gk, rich_d2q9, "generic2d_resident"),
                   (gk, channel, "generic2d_step"),
                   (gk, karman, "generic2d_step"),
                   (gk, karman, "generic2d_resident")], errs,
                  "phase 2, d2q9 on the generic kernels")
    check_globals_flavour(gk, (rich_d2q9, channel), errs, "phase 2")
    check_series_flavours(gk, (rich_series["d2q9"], control_init,
                               channel_series), errs, "phase 2")
    check_series_flavours(g3, (rich_series["d3q19_adj"], control3d_init),
                          errs, "phase 2")
    check_step_b(ak, gk, (rich_heat, heat1024, rich_adj3d, adj3d_init), errs,
                 "phase 2")
    check_goldens()
    main_path = run_case(dk, KARMAN_XML, "4",
                         "cuda_d2q9_resident[d2q9,fuse=8]",
                         ("d2q9_resident8", "d2q9_step"), check_karman)
    band = run_iterate(dk, channel, "5", "1024x1024 channel on the band "
                       "engine", "cuda_d2q9_band[d2q9,fuse=2]",
                       ("d2q9_step2", "d2q9_step"))
    path3d = run_case(dk3, CHANNEL3D_XML, "6",
                      "cuda_d3q27_band[d3q27_cumulant,fuse=2]",
                      ("d3q27_step2", "d3q27_step"), check_channel3d)
    # the developed flow the 3D path ends with (these launches come after
    # the path's counts were read)
    check_kernels([(dk3, path3d["lattice"], "d3q27_step"),
                   (dk3, path3d["lattice"], "d3q27_step2")], errs,
                  "phase 6b, 3d_channel after 20000 iterations")
    path_drop = run_case(gk, DROP_XML, "9",
                         "cuda_generic_resident[d2q9_kuper,fuse=N]",
                         gk.KERNELS, check_drop)
    drop_dev = path_drop["lattice"]
    check_kernels([(gk, drop_dev, "generic2d_step"),
                   (gk, drop_dev, "generic2d_resident")], errs,
                  "phase 9b, drop.xml after 6000 iterations")
    check_globals_flavour(gk, (drop_dev,), errs, "phase 9b")
    band_drop = run_drop_band(gk, drop1024)
    path_heat = run_heat_adj(gk, ak)
    heat_band = run_heat1024(gk, ak, heat1024)
    # the developed 512x1024 flow (after the gradients' counts were read)
    check_kernels([(gk, heat1024, "generic2d_step")], errs,
                  "phase 12b, the 512x1024 heat_adj channel after 2000 "
                  "iterations")
    check_step_b(ak, gk, (heat1024,), errs, "phase 12b")
    path3d_adj = run_adj3d_case(g3, ak, adj3d_xml)
    # the developed state after the 3D case's Solve (its launches come after
    # the path's counts were read)
    adj3d_dev = path3d_adj.pop("start")
    check_kernels([(g3, adj3d_dev, "generic3d_step")], errs,
                  "phase 13b, the 3D case after its Solve of 2000")
    check_globals_flavour(g3, (adj3d_dev,), errs, "phase 13b")
    check_step_b(ak, g3, (adj3d_dev,), errs, "phase 13b")
    bench_adj3d = run_bench_adjoint3d(g3, ak, bench3d)
    family = run_family(dk, family_band, family_res, errs)
    path_turb = run_turbulence(dk3)
    check_kernels([(dk3, path_turb["lattice"], name)
                   for name in dk3.KERNELS], errs,
                  "phase 20b, 3dcum_turbulence.xml after 1000 iterations")
    path_b = run_d3q_channels(dk3, channel48)
    check_kernels([(dk3, lat, name) for lat in channel48.values()
                   for name in dk3.KERNELS], errs,
                  "phase 21b, the 48x48x256 channels after 2002 iterations")
    poiseuille3d = check_d3q_poiseuille()
    path_control = run_series_case(
        gk, KARMAN_CONTROL_XML, "23", "cuda_generic_band[d2q9,fuse=1]",
        inlet_ux_2d, window=500)
    control_dev = path_control.pop("lattice")
    path_control3d = run_series_case(
        g3, adj3d_control_xml, "24",
        "cuda_generic3d_band[d3q19_adj,fuse=1]", inlet_ux_3d, window=200)
    control3d_dev = path_control3d.pop("lattice")
    # the developed states (after the paths' counts were read)
    check_series_flavours(gk, (control_dev,), errs,
                          "phase 23b, karman_control.xml after 4000 "
                          "iterations")
    check_series_flavours(g3, (control3d_dev,), errs,
                          "phase 24b, the 3D Control channel after 2000 "
                          "iterations")
    path_sample = run_sample(gk)
    ladder = run_ladder(gk, dk3, errs, channel=channel, drop1024=drop1024,
                        control=control_dev, channel3d=path3d["lattice"],
                        turb=path_turb["lattice"], channel48=channel48)
    # one generic2d_resident launch of each path: the even part of
    # niter - 1 for drop.xml's Log interval of 500 iterations and for
    # heat_adj.xml's one Solve of 4000
    log_every = int(ET.parse(DROP_XML).getroot().find("Log")
                    .get("Iterations"))
    solve = int(ET.parse(HEAT_ADJ_XML).getroot().find("Solve")
                .get("Iterations"))
    times = time_kernels([
        (dk, "d2q9_resident8", karman, 400), (dk, "d2q9_step", karman, 1000),
        (dk, "d2q9_step2", channel, 200),
        (dk3, "d3q27_step", channel3d, 400),
        (dk3, "d3q27_step2", channel3d, 200)])
    times.update(time_generic(gk, drop1024, drop_dev,
                              (log_every - 1) // 2 * 2))
    times.update(time_generic(gk, heat1024, heat_adj_solve_state(
        HEAT_ADJ_XML), (solve - 1) // 2 * 2, plain_reps=1))
    times.update(time_step_b(ak, gk, heat1024))
    # the series flavours: K4's at 1024x1024 (the record) and at
    # karman_control's 512x96, K6's at the 3D Control channel's 32x64x256;
    # d2q9's plain K4 at 1024x1024 and K5 at karman.xml's 1024x100 for the
    # 498 steps one launch would take per Log interval of 500
    times.update(time_series_flavours(gk, channel_series, 400))
    times_512 = time_series_flavours(gk, control_dev, 1000)
    times.update(time_series_flavours(g3, control3d_dev, 400))
    times_d2q9 = time_generic(gk, channel, karman, 498, plain_reps=1)
    times.update(time_generic3d(g3, ak, adj3d_dev))
    times.update(time_bf16(gk, dk3, ladder["band"], ladder["resident"],
                           ladder["d3"], HARNESS_RES_STEPS))
    # the family: d2q9_resident8 on each model's resident path, the
    # single and fused steps on its 1024x1024 band path
    times.update(time_kernels(
        [(dk, "d2q9_resident8", family["resident_lattice"][m], 400)
         for m in dk.FAMILY]
        + [(dk, name, family_band[m], reps) for m in dk.FAMILY
           for name, reps in (("d2q9_step", 400), ("d2q9_step2", 200))]
        + [(dk3, name, channel48[m], reps) for m in D3Q_FAMILY
           for name, reps in (("d3q27_step", 400), ("d3q27_step2", 200))]))
    busy = device_busy(lambda: karman.iterate(400), "a karman iterate(400)")
    busy3d = device_busy(lambda: channel3d.iterate(200),
                         "a 3d_channel iterate(200)")
    busy_drop = device_busy(lambda: drop_dev.iterate(2000),
                            "a drop iterate(2000)")
    busy_grad = device_busy(heat_band.pop("grad_fn"),
                            "the 1000-step 512x1024 heat_adj gradient")
    busy_grad3d = device_busy(bench_adj3d.pop("grad_fn"),
                              "the 1000-step 64x128x256 d3q19_adj gradient")
    cum2d = family["resident_lattice"]["d2q9_cumulant"]
    busy_cum2d = device_busy(lambda: cum2d.iterate(400),
                             "a cumulant2d iterate(400)")
    cum1024 = family_band["d2q9_cumulant"]
    busy_cum1024 = device_busy(lambda: cum1024.iterate(200),
                               "a 1024x1024 d2q9_cumulant iterate(200)")
    turb_dev = path_turb["lattice"]
    busy_turb = device_busy(lambda: turb_dev.iterate(200),
                            "a 3dcum_turbulence iterate(200)")
    busy48 = {m: device_busy(lambda lat=lat: lat.iterate(200),
                             f"a 48x48x256 {m} channel iterate(200)")
              for m, lat in channel48.items()}
    busy_control = device_busy(lambda: control_dev.iterate(500),
                               "a karman_control iterate(500)")
    busy_control3d = device_busy(lambda: control3d_dev.iterate(200),
                                 "a 3D Control channel iterate(200)")

    launches = {name: {"karman": main_path["launches"][name],
                       "channel": band["launches"][name]}
                for name in dk.KERNELS}
    launches.update(family["launches"])
    launches.update({name: {"3d_channel": path3d["launches"][name],
                            "3dcum_turbulence": path_turb["launches"][name]}
                     for name in dk3.KERNELS})
    launches.update({dk3.launch_key(name, m): {
        "channel48": path_b[m]["launches"][dk3.launch_key(name, m)]}
        for m in D3Q_FAMILY for name in dk3.KERNELS})
    launches.update({f"{name}[d2q9_kuper]": {
        "drop": path_drop["launches"][name],
        "drop1024": band_drop["launches"][name]} for name in gk.KERNELS})
    launches.update({f"{name}[d2q9_heat_adj]": {
        "heat_adj": path_heat["launches"][name],
        "heat_adj1024": heat_band["launches"].get(name, 0),
        "heat_adj1024_gradient": heat_band["grad_launches"][name]}
        for name in gk.KERNELS + ("generic2d_step_b",)})
    launches.update({f"{name}[d3q19_adj]": {
        "adj3d_case": path3d_adj["launches"][name],
        "bench_adjoint3d": bench_adj3d["launches"].get(name, 0),
        "bench_adjoint3d_gradient200":
            bench_adj3d["grad200"]["launches"][name],
        "bench_adjoint3d_gradient1000":
            bench_adj3d["grad1000"]["launches"][name]}
        for name in g3.KERNELS + ("generic3d_step_b",)})
    launches.update({f"{name}[d2q9]": {
        "karman_control": path_control["launches"][name]}
        for name in gk.SERIES_KERNELS})
    launches.update({f"{name}[d3q19_adj]": {
        "adj3d_control": path_control3d["launches"][name]}
        for name in g3.SERIES_KERNELS})
    bf16_sources = {}
    for key, by_path in ladder["launches"].items():
        launches[key] = by_path
        name = key.split("[")[0]
        bf16_sources[name] = SOURCES["d3q27" if name.startswith("d3q27")
                                     else "generic"]
        TPU_KERNELS.setdefault(name, TPU_KERNELS[name[:-len("_bf16")]])
    sources = {**{n: SOURCES["d2q9"] for n in dk.KERNELS},
               **{n: SOURCES["d3q27"] for n in dk3.KERNELS},
               **{n: SOURCES["generic"] for n in gk.KERNELS
                  + gk.SERIES_KERNELS},
               **{n: SOURCES["generic3d"] for n in g3.SERIES_KERNELS},
               "generic2d_step_b": SOURCES["adjoint"],
               **{n: SOURCES["generic3d"] for n in g3.KERNELS},
               "generic3d_step_b": SOURCES["adjoint3d"], **bf16_sources}
    kernels = []
    for key, by_path in launches.items():
        name = key.split("[")[0]
        if sum(by_path.values()) < 1:
            fail(f"{key} was launched no time on the path")
        kernels.append({
            "name": key, "route": "cuda",
            "source": "tclb_tpu_torch/csrc/" + sources[name],
            "replaces": TPU_KERNELS.get(key, TPU_KERNELS[name]),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[key]["max_abs_err"],
            "max_rel_err": errs[key]["max_rel_err"],
            "ms": times[key]["ms"], "plain_ms": times[key]["plain_ms"],
            "bound_ms": times[key]["bound_ms"],
            "bound_by": times[key]["bound_by"],
            "library_ms": None,
            "wrapper_host_ms": times[key]["wrapper_host_ms"],
            "shape": times[key]["shape"],
        })
    by_name = {k["name"]: k for k in kernels}
    for key, flavour_launches in (
            ("generic2d_step[d2q9_kuper]",
             {"drop": path_drop["flavours"]["globals"],
              "drop1024": band_drop["flavours"]["globals"]}),
            ("generic2d_step[d2q9_heat_adj]",
             {"heat_adj": path_heat["flavours"]["globals"],
              "heat_adj1024": heat_band["flavours"]["globals"],
              "heat_adj1024_gradient":
                  heat_band["grad_flavours"]["globals"]}),
            ("generic3d_step[d3q19_adj]",
             {"adj3d_case": path3d_adj["flavours"]["globals"],
              "bench_adjoint3d": bench_adj3d["flavours"]["globals"],
              "bench_adjoint3d_gradient200":
                  bench_adj3d["grad200"]["flavours"]["globals"],
              "bench_adjoint3d_gradient1000":
                  bench_adj3d["grad1000"]["flavours"]["globals"]})):
        by_name[key]["globals_flavour"] = {
            **{k: times[f"{key} globals"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "wrapper_host_ms", "shape")},
            "launches_by_path": flavour_launches,
            "globals_max_abs_err": errs[f"{key} globals"]["max_abs_err"]}
        res = key.replace("step", "resident")
        if res in by_name:
            by_name[res]["steps"] = times[res]["steps"]
    for step_b in ("generic2d_step_b[d2q9_heat_adj]",
                   "generic3d_step_b[d3q19_adj]"):
        by_name[step_b]["settings_max_rel_err"] = \
            errs[f"{step_b} settings"]["max_rel_err"]
    for key in (f"{k}[{m}]" for mod, m in ((gk, "d2q9"), (g3, "d3q19_adj"))
                for k in mod.SERIES_KERNELS[1:]):
        by_name[key]["globals_max_abs_err"] = \
            errs[f"{key} globals"]["max_abs_err"]
    for key in ladder["launches"]:
        e = errs[key]
        by_name[key]["flips"] = e.get("flips")
        if key.startswith("generic2d_step_bf16"):
            by_name[key]["globals_flavour"] = {
                **{k: times[f"{key} globals"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "wrapper_host_ms", "shape")},
                "launches_by_path": ladder["globals_launches"][key],
                "globals_max_abs_err": errs[f"{key} globals"]["max_abs_err"]}
        if key.startswith("generic2d_resident_bf16"):
            by_name[key]["steps"] = times[key]["steps"]
            by_name[key]["chain_bit_identical"] = e["chain_bit_identical"]
            # against as many narrowed eager steps from the start
            by_name[key]["eager_max_abs_err"] = e["eager_max_abs_err"]
    for key, t in times_512.items():
        by_name[key]["at_512x96"] = {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "wrapper_host_ms")}
    # d2q9's plain generic kernels: held and timed, on no path (d2q9
    # without a series takes K1/K2), so not in the kernels line
    d2q9_generic = {key: {**{k: t[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "wrapper_host_ms",
        "shape")}, "max_abs_err": errs[key.replace(" globals", "")
                                       ]["max_abs_err"]}
        for key, t in times_d2q9.items()}
    d2q9_generic["generic2d_step[d2q9] globals"]["globals_max_abs_err"] = \
        errs["generic2d_step[d2q9] globals"]["max_abs_err"]
    keys = ("wall_s", "mlups_end_to_end", "mlups_iterate", "iterate_ms",
            "iterate_host_ms", "eager_step_ms", "eager_steps")
    heat_keys = ("wall_s", "objectives", "material", "fd_records",
                 "grad_rel_l2_f64", "solid_nodes")
    say(json.dumps({
        "karman": {k: main_path[k] for k in keys},
        "channel_mlups_iterate": band["mlups_iterate"],
        "3d_channel": {k: path3d[k] for k in keys},
        "drop": {k: path_drop[k] for k in keys},
        "drop1024_mlups_iterate": band_drop["mlups_iterate"],
        "heat_adj": {k: path_heat[k] for k in heat_keys},
        "heat_adj1024": {k: heat_band[k] for k in (
            "mlups_iterate", "grad8_max_abs_err", "grad1000")},
        "adj3d_case": {k: path3d_adj[k] for k in heat_keys + (
            "fd_in_block",)},
        "bench_adjoint3d": {k: bench_adj3d[k] for k in (
            "mlups_iterate", "grad8_max_abs_err", "grad200", "grad1000")},
        **family["summary"],
        "3dcum_turbulence": {**{k: path_turb[k] for k in keys},
                             "synth_digests": path_turb["synth_digests"]},
        "channel48_mlups_iterate": {m: path_b[m]["mlups_iterate"]
                                    for m in D3Q_FAMILY},
        "poiseuille3d": poiseuille3d,
        "karman_control": path_control,
        "adj3d_control": path_control3d,
        "sample": path_sample,
        "storage_ladder": ladder["summary"],
        "d2q9_generic_kernels_off_path": d2q9_generic,
        "karman_control_iterate_profile": busy_control,
        "adj3d_control_iterate_profile": busy_control3d,
        "3dcum_turbulence_iterate_profile": busy_turb,
        "channel48_iterate_profile": busy48,
        "cumulant2d_iterate_profile": busy_cum2d,
        "d2q9_cumulant1024_iterate_profile": busy_cum1024,
        "karman_iterate_profile": busy,
        "3d_channel_iterate_profile": busy3d,
        "drop_iterate_profile": busy_drop,
        "heat_adj1024_gradient_profile": busy_grad,
        "bench_adjoint3d_gradient1000_profile": busy_grad3d}))
    case_tmp.cleanup()
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
