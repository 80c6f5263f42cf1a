"""Error-against-reference harness of the storage ladder.

The port's copy of the JAX package's ``precision.py``.  Narrowed storage
(``Lattice(storage_dtype=torch.bfloat16)``) trades mantissa for device-memory
bytes, so its contract is not bit-parity but a bounded drift from the f32
run: this module runs the same case twice (f32 storage and narrowed
storage: the same flags, settings and engine selection), measures the
relative L2/Linf error of the whole field stack at fixed iterations, and
holds it against :data:`ERROR_BOUNDS`, the JAX package's bounds copied as
they are.  Both runs take the engines ``Lattice`` selects: on the card the
kernels (the generic 2D kernels carry the bf16 rung of both cases), on the
CPU the eager engine, which narrows once per step.

    python -m tclb_tpu_torch.precision                 # on the card
    python -m tclb_tpu_torch.precision --device cpu    # eager, on the host
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Optional, Sequence

import numpy as np
import torch

# error growth is roughly sqrt(t) (random-walk rounding), so a mid-run
# sample catches a blowup the endpoint alone would misattribute
DEFAULT_CHECKPOINTS = (100, 250, 500)

# the JAX package's bounds (tclb_tpu/precision.py, measured there on the
# CPU XLA path at 64x64 and 500 steps with ~2x headroom), keyed (case,
# storage dtype, storage repr)
ERROR_BOUNDS = {
    ("cavity", "bfloat16", "raw"): {"l2": 1.2e-2, "linf": 3.5e-2},
    ("kuper_drop", "bfloat16", "raw"): {"l2": 2.5e-2, "linf": 1.0e-1},
    ("cavity", "bfloat16", "shifted"): {"l2": 3.0e-4, "linf": 1.0e-3},
    ("kuper_drop", "bfloat16", "shifted"): {"l2": 5.0e-2,
                                            "linf": 2.5e-1},
}

CASE_NAMES = ("cavity", "kuper_drop")
REPR_NAMES = ("raw", "shifted")


def build_case(name: str, n: int = 64):
    """One harness case as ``(model, shape, settings, flags, zonal)``; the
    caller builds the Lattice, so it can pass ``storage_dtype``.

    * ``cavity`` -- d2q9: walls top and bottom, a WVelocity inlet, an
      EPressure outlet and a square obstacle (boundaries and MRT bulk);
    * ``kuper_drop`` -- d2q9_kuper, drop.xml's physics: a liquid drop (zone
      1's Density) settling in vapour (the CalcPhi stencil's two stages).
    """
    from tclb_tpu_torch.models import get_model
    if name == "cavity":
        m = get_model("d2q9")
        settings = {"nu": 0.05, "Velocity": 0.02}
        flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
        flags[:, 0] = m.flag_for("WVelocity", "MRT")
        flags[:, -1] = m.flag_for("EPressure", "MRT")
        flags[0, :] = flags[-1, :] = m.flag_for("Wall")
        q = n // 4
        flags[q:q + q // 2, q:q + q // 2] = m.flag_for("Wall")
        return m, (n, n), settings, flags, {}
    if name == "kuper_drop":
        m = get_model("d2q9_kuper")
        settings = {"omega": 1.0, "Temperature": 0.56, "FAcc": 1.0,
                    "Magic": 0.01, "MagicA": -0.152,
                    "MagicF": -2.0 / 3.0,
                    "Density": 3.2600529440452366}
        zonal = {("Density", 1): 0.014500641645077492}
        flags = np.full((n, n), m.flag_for("MRT"), dtype=np.uint16)
        yy, xx = np.mgrid[0:n, 0:n]
        drop = (yy - n / 2) ** 2 + (xx - n / 2) ** 2 < (n / 5) ** 2
        flags[drop] = m.flag_for("MRT", zone=1)
        return m, (n, n), settings, flags, zonal
    raise ValueError(f"unknown precision case {name!r}; "
                     f"have {CASE_NAMES}")


def case_lattice(name: str, n: int = 64, storage_dtype: Any = None,
                 storage_repr: Optional[str] = None, device: Any = None):
    """The case's initialised f32-compute ``Lattice``."""
    from tclb_tpu_torch.core.lattice import Lattice
    model, shape, settings, flags, zonal = build_case(name, n)
    lat = Lattice(model, shape, dtype=torch.float32, settings=settings,
                  device=device, storage_dtype=storage_dtype,
                  storage_repr=storage_repr)
    for (sname, zone), val in zonal.items():
        lat.set_setting(sname, val, zone=zone)
    lat.set_flags(flags)
    lat.init()
    return lat


def _run(name: str, n: int, niter: int, storage_dtype,
         checkpoints: Sequence[int], storage_repr: Optional[str] = None,
         device: Any = None) -> tuple:
    """(field stack, velocity) as f64 numpy at each checkpoint, and the
    engine's tag.  Field stacks come through ``Lattice.fields_raw``, so a
    shifted run and its reference compare in the raw representation."""
    lat = case_lattice(name, n, storage_dtype, storage_repr, device)
    out, prev = {}, 0
    for it in sorted(set(int(c) for c in checkpoints) | {int(niter)}):
        if it > niter:
            break
        if it > prev:
            lat.iterate(it - prev)
        prev = it
        out[it] = (lat.fields_raw(),
                   lat.get_quantity("U").double().cpu().numpy())
    return out, lat.engine_name


def _norm_rows(ref: dict, alt: dict) -> list:
    rows = []
    for it in sorted(ref):
        (r, ru), (a, au) = ref[it], alt[it]
        d = a - r
        du = au - ru
        rnorm = float(np.linalg.norm(r))
        rmax = float(np.max(np.abs(r)))
        rows.append({
            "iteration": it,
            "l2": float(np.linalg.norm(d)) / max(rnorm, 1e-30),
            "linf": float(np.max(np.abs(d))) / max(rmax, 1e-30),
            "u_l2": float(np.linalg.norm(du))
            / max(float(np.linalg.norm(ru)), 1e-30),
            "u_linf": float(np.max(np.abs(du)))
            / max(float(np.max(np.abs(ru))), 1e-30),
        })
    return rows


def _report(case: str, n: int, niter: int, storage_dtype, repr_: str,
            ref: tuple, alt: tuple) -> dict:
    from tclb_tpu_torch.core.shift import dtype_name
    return {"case": case, "storage_dtype": dtype_name(storage_dtype),
            "storage_repr": repr_, "shape": [n, n], "niter": int(niter),
            "engine": alt[1], "reference_engine": ref[1],
            "checkpoints": _norm_rows(ref[0], alt[0])}


def error_norms(case: str = "cavity", niter: int = 500, n: int = 64,
                storage_dtype: Any = "bfloat16",
                storage_repr: str = "raw",
                checkpoints: Sequence[int] = DEFAULT_CHECKPOINTS,
                device: Any = None) -> dict:
    """Relative L2/Linf error of the narrowed run against the f32 run,
    over the whole field stack in the raw representation (``l2 = ||a -
    r|| / ||r||``, ``linf = max|a - r| / max|r|``).  Each row also holds
    the same norms over the velocity (``u_l2``/``u_linf``), informational:
    with raw storage the rounding of the O(1) background swamps a low-Mach
    velocity, with shifted storage it does not.  ``device=None`` is the
    card."""
    ref = _run(case, n, niter, None, checkpoints, device=device)
    alt = _run(case, n, niter, storage_dtype, checkpoints, storage_repr,
               device)
    return _report(case, n, niter, storage_dtype, storage_repr, ref, alt)


def compare_reprs(case: str = "cavity", niter: int = 500, n: int = 64,
                  storage_dtype: Any = "bfloat16",
                  checkpoints: Sequence[int] = DEFAULT_CHECKPOINTS,
                  device: Any = None) -> list[dict]:
    """The raw and the shifted report of one case off one shared f32
    run."""
    ref = _run(case, n, niter, None, checkpoints, device=device)
    return [_report(case, n, niter, storage_dtype, repr_, ref,
                    _run(case, n, niter, storage_dtype, checkpoints, repr_,
                         device))
            for repr_ in REPR_NAMES]


def check_bounds(report: dict,
                 bounds: Optional[dict] = None) -> list[str]:
    """Violations (empty: within the contract).  Every checkpoint must
    hold the case's bound."""
    key = (report["case"], report["storage_dtype"],
           report.get("storage_repr", "raw"))
    bound = (bounds if bounds is not None else ERROR_BOUNDS).get(key)
    if bound is None:
        return [f"no documented error bound for {key}"]
    out = []
    for row in report["checkpoints"]:
        for norm in ("l2", "linf"):
            if row[norm] > bound[norm]:
                out.append(
                    f"{report['case']} @ iter {row['iteration']}: "
                    f"{norm}={row[norm]:.3e} exceeds bound "
                    f"{bound[norm]:.1e}")
    return out


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tclb_tpu_torch.precision",
        description="bf16 storage-ladder error harness against the f32 run")
    p.add_argument("--case", choices=CASE_NAMES + ("all",), default="all")
    p.add_argument("--niter", type=int, default=500)
    p.add_argument("--n", type=int, default=64,
                   help="lattice edge length (default 64)")
    p.add_argument("--storage-dtype", default="bfloat16")
    p.add_argument("--repr", dest="repr_", metavar="REPR",
                   choices=REPR_NAMES + ("both",), default="both",
                   help="storage representation to measure; 'both' "
                   "(default) prints the raw/shifted column pair off one "
                   "shared f32 run")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default): the card and its kernels; cpu: "
                   "the eager engine on the host")
    args = p.parse_args(argv)

    from tclb_tpu_torch.utils import log
    level = log.get_level()
    if args.format == "json":
        # stdout carries the JSON alone; each report names its engines
        log.set_level("warning")
    cases = CASE_NAMES if args.case == "all" else (args.case,)
    reports, violations = [], []
    try:
        for case in cases:
            if args.repr_ == "both":
                reps = compare_reprs(case, niter=args.niter, n=args.n,
                                     storage_dtype=args.storage_dtype,
                                     device=args.device)
            else:
                reps = [error_norms(case, niter=args.niter, n=args.n,
                                    storage_dtype=args.storage_dtype,
                                    storage_repr=args.repr_,
                                    device=args.device)]
            reports += reps
            for rep in reps:
                violations += check_bounds(rep)
    finally:
        log.set_level(level)
    if args.format == "json":
        print(json.dumps({"reports": reports, "violations": violations},
                         indent=2))
    else:
        _print_text(reports)
        for v in violations:
            print("VIOLATION:", v)
        if not violations:
            print("all error bounds hold")
    return 1 if violations else 0


def _print_text(reports: list) -> None:
    """One block per case; both representations of a case print side by
    side (the low-Mach cavity's u norms are the comparison to read)."""
    by_case: dict = {}
    for rep in reports:
        by_case.setdefault(rep["case"], []).append(rep)
    for case, reps in by_case.items():
        head = (f"{case} ({reps[0]['storage_dtype']} storage, "
                f"{reps[0]['shape'][0]}x{reps[0]['shape'][1]}; engines "
                + ", ".join(rep["engine"] for rep in reps)
                + f" against {reps[0]['reference_engine']})")
        if len(reps) == 1:
            rep = reps[0]
            print(f"{head}, repr={rep['storage_repr']}:")
            for row in rep["checkpoints"]:
                print(f"  iter {row['iteration']:>5}  "
                      f"l2 {row['l2']:.3e}  linf {row['linf']:.3e}  "
                      f"(u: l2 {row['u_l2']:.3e}  "
                      f"linf {row['u_linf']:.3e})")
            continue
        cols = {rep["storage_repr"]: rep for rep in reps}
        print(f"{head}:")
        print(f"  {'':>10}  {'---- raw ----':^25}  "
              f"{'-- shifted --':^25}")
        print(f"  {'':>10}  {'linf':^11} {'u_linf':^12}  "
              f"{'linf':^11} {'u_linf':^12}")
        for rr, rs in zip(cols["raw"]["checkpoints"],
                          cols["shifted"]["checkpoints"]):
            print(f"  iter {rr['iteration']:>5}  "
                  f"{rr['linf']:.3e}  {rr['u_linf']:.3e}   "
                  f"{rs['linf']:.3e}  {rs['u_linf']:.3e}")


if __name__ == "__main__":
    sys.exit(main())
