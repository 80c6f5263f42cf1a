"""Solver: process-level orchestration + config entry points.

The port's counterpart of the JAX package's ``control/solver.py``: read the
units and gauge them, size the lattice from the <Geometry> element, run the
handler tree, write the CSV log and VTK output.  One process drives one
device until the multi-device slice (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import os
import time
import xml.etree.ElementTree as ET
from typing import Any, Optional

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import Lattice
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.utils import log
from tclb_tpu_torch.utils.geometry import Geometry
from tclb_tpu_torch.utils.units import UnitEnv
from tclb_tpu_torch.utils.vtk import CSVLog, write_pvti, write_vti

ITERATION_STOP = 1


class Solver:
    """Host orchestration state shared by all handlers."""

    def __init__(self, model: Model, output: str = "output/",
                 mesh: Any = None, dtype: Optional[torch.dtype] = None,
                 device: Any = None):
        self.model = model
        self.units = UnitEnv()
        self.output_prefix = output
        self.mesh = mesh
        self.dtype = dtype
        self.device = device
        self.lattice: Optional[Lattice] = None
        self.geometry: Optional[Geometry] = None
        self.shape: tuple[int, ...] = ()
        self.iter = 0
        self.opt_iter = 0
        # what the adjoint and optimization handlers record
        self.designs: list = []      # <InternalTopology> and friends
        self.design: Any = None
        self.adjoint_engine: Optional[str] = None
        self.objective: Optional[float] = None
        self.gradient: Any = None
        self.fd_records: list = []   # <FDTest>
        self.opt_history: list = []  # <Optimize>: each evaluation's objective
        self.opt_material: Optional[dict] = None
        self.hands: list = []        # stacked periodic callbacks
        self.synthetic_turbulence = None   # set by <SyntheticTurbulence>
        self.log: Optional[CSVLog] = None
        self.start_walltime = time.time()
        self.conf_name = "run"

    # -- naming (reference Solver::outIterFile/outGlobalFile) --------------- #

    def out_path(self, name: str, ext: str, with_iter: bool = True) -> str:
        base = self.output_prefix
        if base.endswith("/"):
            os.makedirs(base, exist_ok=True)
            base = os.path.join(base, self.conf_name)
        tag = f"_{name}_{self.iter:08d}" if with_iter else f"_{name}"
        return f"{base}{tag}.{ext}"

    @property
    def is_main(self) -> bool:
        """File-output duty; one process until the multi-device slice."""
        return True

    # -- setup --------------------------------------------------------------- #

    def set_size(self, shape: tuple[int, ...]) -> None:
        """Allocate the lattice and the geometry painter."""
        self.shape = tuple(int(s) for s in shape)
        self.lattice = Lattice(self.model, self.shape,
                               dtype=self.dtype or torch.float32,
                               device=self.device, mesh=self.mesh)
        self.geometry = Geometry(self.model, self.shape, self.units)

    def set_unit(self, name: str, value: str, gauge: str = "1") -> None:
        self.units.set_unit(name, self.units.read_text(value),
                            float(self.units.si(gauge)))

    def gauge(self) -> None:
        self.units.make_gauge()

    # -- progress/throughput (reference MainCallback live MLBUps/GB/s) ----- #

    def progress(self, steps: int) -> None:
        """Called by <Solve> after each iterate chunk: logs MLUPS and
        effective GB/s, throttled to about one report a second."""
        now = time.time()
        if not hasattr(self, "_prog_t0"):
            self._prog_t0, self._prog_iters = now, 0
            return
        self._prog_iters += steps
        if now - self._prog_t0 < 1.0:
            return
        # wait for the device so the rate is real (launches are async)
        self.lattice.synchronize()
        dt = time.time() - self._prog_t0
        mlups = float(np.prod(self.shape)) * self._prog_iters / dt / 1e6
        bytes_per = (2 * self.model.n_storage
                     * self.lattice.state.fields.element_size() + 2)
        log.info(f"iter {self.iter}: {mlups:8.1f} MLUPS "
                 f"({mlups * bytes_per / 1e3:6.1f} GB/s eff) "
                 f"[{self._prog_iters} it in {dt:.2f} s]")
        self._prog_t0, self._prog_iters = time.time(), 0

    # -- config provenance --------------------------------------------------- #

    def dump_config(self, root) -> None:
        import copy

        from tclb_tpu_torch import __version__
        annotated = copy.deepcopy(root)
        annotated.set("solver_version", __version__)
        annotated.set("model_name", self.model.name)
        annotated.set("precision",
                      "double" if self.dtype == torch.float64 else "single")
        annotated.set("backend", self.lattice.device.type)
        path = self.out_path("config", "xml", with_iter=False)
        ET.ElementTree(annotated).write(path)

    # -- synthetic turbulence (modes drawn per handler segment) ------------- #

    def update_synthetic_turbulence(self, steps: int) -> None:
        """Advance the SynthT coupling planes by one handler segment of
        ``steps`` iterations with the variance-exact AR(1) update
        (``utils/turbulence.py``)."""
        st = self.synthetic_turbulence
        m = self.model
        if st is None or st.nmodes == 0 or "SynthT" not in m.groups:
            return
        fluct = st.evaluate(self.shape)
        k_aa = st.ar1_factor(steps)
        k_bb = float(np.sqrt(max(0.0, 1.0 - k_aa * k_aa)))
        lat = self.lattice
        idx = list(m.groups["SynthT"])
        # only the SynthT planes cross to the host
        old = lat.state.fields[idx].cpu().numpy()
        lat.set_density_planes(
            {m.storage_names[i]: k_aa * old[c] + k_bb * fluct[c]
             for c, i in enumerate(idx)})

    # -- output ------------------------------------------------------------- #

    def log_row(self) -> dict[str, float]:
        m = self.model
        lat = self.lattice
        row: dict[str, float] = {
            "Iteration": float(self.iter),
            # 1 s == units.scale[1] lattice iterations (UnitEnv gauge)
            "Time_si": float(self.iter) / float(self.units.scale[1]),
            "Walltime": time.time() - self.start_walltime,
            "OptIteration": float(self.opt_iter),
        }
        svec = lat.params.settings.cpu().numpy()
        for s in m.settings:
            row[f"{s.name}"] = float(svec[m.setting_index[s.name]])
        if self.geometry:
            table = lat.params.zone_table.cpu().numpy()
            for s in m.zonal_settings:
                for zname, zid in self.geometry.setting_zones.items():
                    row[f"{s}-{zname}"] = float(table[m.setting_index[s], zid])
        for name, val in lat.get_globals().items():
            row[name] = val
        return row

    def write_log(self) -> None:
        if not self.is_main:
            return
        if self.log is None:
            self.log = CSVLog(self.out_path("Log", "csv", with_iter=False))
        self.log.write(self.log_row())

    def quantity_arrays(self, what: Optional[set[str]] = None
                        ) -> dict[str, np.ndarray]:
        """Evaluate the selected quantities into host arrays."""
        out = {}
        for q in self.model.quantities:
            if q.adjoint:
                continue
            if what and q.name not in what and "all" not in what:
                continue
            out[q.name] = self.lattice.get_quantity(q.name).cpu().numpy()
        return out

    def write_geometry_vti(self) -> str:
        """The painted geometry as VTI: raw flags, one 0/1 layer per
        node-type group, and the settings-zone ids."""
        m = self.model
        flags = self.lattice.flags_numpy()
        arrays = {"Flag": flags}
        for group, mask in m.group_masks.items():
            if group in ("ALL", "SETTINGZONE") or mask == 0:
                continue
            arrays[group] = ((flags & mask) != 0).astype(np.uint8)
        arrays["Zone"] = (flags >> m.zone_shift).astype(np.uint16)
        path = self.out_path("geometry", "vti", with_iter=False)
        write_vti(path, arrays)
        return path

    def write_vtk(self, what: Optional[set[str]] = None,
                  compress: bool = False) -> Optional[str]:
        if not self.is_main:
            return None
        arrays = self.quantity_arrays(what)
        if what is None or "flag" in what or not what:
            arrays["Flag"] = self.lattice.flags_numpy()
        piece = write_vti(self.out_path("VTK", "vti"), arrays,
                          compress=compress)
        write_pvti(self.out_path("VTK", "pvti"), piece, arrays)
        return piece


# --------------------------------------------------------------------------- #
# Config entry points (reference main(), src/main.cpp.Rt:172-346)
# --------------------------------------------------------------------------- #


def _read_units(root: ET.Element, solver: Solver) -> None:
    """<Units><Params Re="100" gauge="1"/>...</Units>."""
    units = root.find("Units")
    if units is None:
        return
    for p in units.findall("Params"):
        gauge = p.get("gauge", "1")
        rest = {k: v for k, v in p.attrib.items() if k != "gauge"}
        if len(rest) != 1:
            raise ValueError(
                f"exactly one variable per Units/Params, got {sorted(rest)}")
        (name, value), = rest.items()
        solver.set_unit(name, value, gauge)
    solver.gauge()


def run_config_string(xml_text: str, model: Model, mesh: Any = None,
                      dtype: Optional[torch.dtype] = None,
                      output: Optional[str] = None, conf_name: str = "run",
                      device: Any = None) -> Solver:
    root = ET.fromstring(xml_text)
    return _run_root(root, model, mesh, dtype, output, conf_name,
                     device=device)


def run_config(path: str, model: Model, mesh: Any = None,
               dtype: Optional[torch.dtype] = None,
               output: Optional[str] = None, device: Any = None) -> Solver:
    root = ET.parse(path).getroot()
    name = os.path.splitext(os.path.basename(path))[0]
    return _run_root(root, model, mesh, dtype, output, name, device=device)


def _run_root(root: ET.Element, model: Model, mesh, dtype,
              output: Optional[str], conf_name: str,
              device: Any = None) -> Solver:
    from tclb_tpu_torch.control.handlers import MainContainer
    if root.tag != "CLBConfig":
        raise ValueError(f"config root must be <CLBConfig>, got <{root.tag}>")
    solver = Solver(model, output=output or root.get("output", "output/"),
                    mesh=mesh, dtype=dtype, device=device)
    solver.conf_name = conf_name
    _read_units(root, solver)
    geom = root.find("Geometry")
    if geom is None:
        raise ValueError("config must contain a <Geometry> element")
    if model.ndim == 2:
        shape = (int(round(solver.units.alt(geom.get("ny", "1")))),
                 int(round(solver.units.alt(geom.get("nx", "1")))))
    else:
        shape = (int(round(solver.units.alt(geom.get("nz", "1")))),
                 int(round(solver.units.alt(geom.get("ny", "1")))),
                 int(round(solver.units.alt(geom.get("nx", "1")))))
    solver.set_size(shape)
    MainContainer(root, solver).init()
    return solver
