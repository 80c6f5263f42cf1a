"""XML handler tree — element name -> behavior.

The port's counterpart of the JAX package's ``control/handlers.py``: the
same scheduling (fractional intervals, Now/Next), the same recursive
``GenericAction`` execution with callback stacking, and the handlers the
main path and its goldens use, with ``<Control>`` time series, the
``<Sample>`` point sampler and the ``<Keep>`` feedback loop; the adjoint
and optimization handlers are in ``opt_handlers.py``.  Every other
element of the JAX package's handler table raises
``NotImplementedError`` naming the ROADMAP item that ports it; an element
neither package knows raises ``ValueError``.

Handlers run on the host; everything device-bound goes through the Lattice.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from tclb_tpu_torch.control.solver import ITERATION_STOP, Solver
from tclb_tpu_torch.utils import log
from tclb_tpu_torch.utils.sampler import Sampler
from tclb_tpu_torch.utils.turbulence import SyntheticTurbulence


class Handler:
    """Base scheduling unit."""

    kind = "action"   # action | callback | container

    def __init__(self, node: ET.Element, solver: Solver):
        self.node = node
        self.solver = solver
        self.start_iter = 0
        self.every_iter = 0.0

    # -- schedule ----------------------------------------------------------- #

    def _parse_interval(self) -> None:
        self.start_iter = self.solver.iter
        attr = self.node.get("Iterations")
        self.every_iter = self.solver.units.alt(attr) if attr else 0.0

    def now(self, it: int) -> bool:
        """True when ``it`` is a firing iteration (fractional intervals
        fire by floor-crossing)."""
        if not self.every_iter:
            return False
        it -= self.start_iter
        return math.floor(it / self.every_iter) > \
            math.floor((it - 1) / self.every_iter)

    def next_it(self, it: int) -> int:
        """Steps until the next firing."""
        if not self.every_iter:
            return -1
        it -= self.start_iter
        k = math.floor(it / self.every_iter)
        return int(-math.floor(-(k + 1) * self.every_iter)) - it

    # -- lifecycle ---------------------------------------------------------- #

    def init(self) -> int:
        self._parse_interval()
        if self.node.get("output"):
            self.solver.output_prefix = self.node.get("output")
        return 0

    def do_it(self) -> int:
        return 0

    def finish(self) -> int:
        return 0


class GenericAction(Handler):
    """Container executing children immediately; periodic children stack
    into ``solver.hands`` until this action completes."""

    def init(self) -> int:
        super().init()
        return self.execute_internal()

    def execute_internal(self) -> int:
        self._stacked = 0
        for child in self.node:
            h = get_handler(child, self.solver)
            if h is None:
                continue
            ret = h.init()
            if ret not in (0, None):
                return ret
            if h.every_iter:
                self.solver.hands.append(h)
                self._stacked += 1
        return 0

    def unstack(self) -> None:
        for _ in range(getattr(self, "_stacked", 0)):
            h = self.solver.hands.pop()
            h.finish()


class MainContainer(GenericAction):
    """The <CLBConfig> root."""

    kind = "container"

    def init(self) -> int:
        self.start_iter = self.solver.iter
        self.every_iter = 0.0
        if self.node.get("output"):
            self.solver.output_prefix = self.node.get("output")
        self.solver.dump_config(self.node)
        ret = self.execute_internal()
        self.unstack()
        return ret


class acSolve(GenericAction):
    """<Solve Iterations="N">: the main loop — lattice iterations batched
    between due callbacks."""

    def init(self) -> int:
        Handler.init(self)
        if not self.every_iter:
            raise ValueError("<Solve> needs a positive Iterations attribute")
        ret = self.execute_internal()
        if ret not in (0, None):
            return ret
        s = self.solver
        stop = False
        while True:
            next_it = self.next_it(s.iter)
            for h in s.hands:
                it = h.next_it(s.iter)
                if 0 < it < next_it:
                    next_it = it
            s.iter += next_it
            s.update_synthetic_turbulence(next_it)
            s.lattice.iterate(next_it)
            s.progress(next_it)
            for h in s.hands:
                if h.now(s.iter):
                    r = h.do_it()
                    if r == ITERATION_STOP:
                        stop = True
                    elif r not in (0, None):
                        return r
            if stop or self.now(s.iter):
                break
        self.unstack()
        return 0


class acRepeat(GenericAction):
    """<Repeat Times="N">: run the children N times."""

    def init(self) -> int:
        Handler.init(self)
        for _ in range(int(self.node.get("Times", "1"))):
            ret = self.execute_internal()
            if ret not in (0, None):
                return ret
            self.unstack()
        return 0


class acGeometry(Handler):
    """<Geometry>: run the painter and push the flags."""

    def init(self) -> int:
        super().init()
        s = self.solver
        s.geometry.load(self.node)
        s.lattice.set_flags(s.geometry.result())
        if self.node.get("export") == "vti":
            s.write_geometry_vti()
        return 0


class acModel(GenericAction):
    """<Model>: the children (Params), then the lattice's Init."""

    def init(self) -> int:
        Handler.init(self)
        ret = self.execute_internal()
        if ret not in (0, None):
            return ret
        self.solver.lattice.init()
        self.unstack()
        return 0


class acInit(Handler):
    """<Init/>: re-run the Init action."""

    def init(self) -> int:
        super().init()
        self.solver.lattice.init()
        return 0


class acParams(Handler):
    """<Params name="value" name-zone="value">: set (zonal) settings
    through the units engine; unknown names are ignored with a warning."""

    def init(self) -> int:
        super().init()
        s = self.solver
        m = s.model
        for name, raw in self.node.attrib.items():
            if name in ("Iterations", "output"):
                continue
            zone: Optional[int] = None
            par = name
            if "-" in name:
                par, zname = name.split("-", 1)
                if zname not in s.geometry.setting_zones:
                    log.warning(f"unknown zone {zname!r} (setting {par})")
                    continue
                zone = s.geometry.setting_zones[zname]
            if par in m.setting_index:
                s.lattice.set_setting(par, s.units.alt(raw), zone=zone)
            else:
                log.warning(f"Params: model {m.name} has no setting "
                            f"{par!r} — ignored")
        return 0


class conControl(Handler):
    """<Control Iterations="N"><CSV file="..." Time="col*1s"/>
    <Params name-zone="col*1m/s+0.5"/></Control>: time-dependent zonal
    settings.  CSV columns are read through the units engine, linearly
    interpolated onto the iteration grid [0, N), and each <Params> value is
    an expression ``term + term + ...`` whose terms are ``variable*scale``
    (a column) or a constant with units; the per-iteration series land in
    the lattice's time series (``Lattice.set_setting_series``)."""

    def init(self) -> int:
        super().init()
        s = self.solver
        horizon = int(round(s.units.alt(self.node.get("Iterations", "0"))))
        if horizon <= 0:
            raise ValueError("<Control> needs a positive Iterations horizon")
        self.horizon = horizon
        context: dict[str, np.ndarray] = {}
        for child in self.node:
            if child.tag == "CSV":
                self._load_csv(child, context)
            elif child.tag == "Params":
                self._params(child, context)
            else:
                raise ValueError(f"unknown element <{child.tag}> in Control")
        return 0

    def _eval(self, context: dict[str, np.ndarray], expr: str) -> np.ndarray:
        """``var*scale+var2*scale2+const`` -> per-iteration array.

        Terms split on top-level ``+``/``-``.  A sign after a digit and
        ``e``/``E`` is an exponent (``1e+5``), one after ``*`` a negative
        factor (``flow*-2``); a leading sign negates the first term."""
        s = self.solver
        out = np.zeros(self.horizon)
        expr = re.sub(r"\s*\*\s*", "*", expr)
        parts = re.split(r"(?<![\d.][eE])(?<!\*)([+-])", expr)
        sign = 1.0
        for part in parts:
            part = part.strip()
            if part == "+":
                continue
            if part == "-":
                sign = -sign
                continue
            if not part:
                continue
            factors = part.split("*")
            if factors[0].strip() in context:
                val = context[factors[0].strip()].copy()
                for f in factors[1:]:
                    val = val * s.units.alt(f)
            else:
                v = 1.0
                for f in factors:
                    v *= s.units.alt(f)
                val = v
            out = out + sign * val
            sign = 1.0
        return out

    def _load_csv(self, node: ET.Element, context: dict) -> None:
        """Parse the CSV, convert through the units engine, interpolate
        every column onto the iteration grid."""
        s = self.solver
        fn = node.get("file")
        if not fn:
            raise ValueError("<CSV> in Control needs file=")
        with open(fn) as f:
            header = [h.strip().strip('"') for h in
                      f.readline().strip().split(",")]
            rows = [[s.units.alt(tok) for tok in line.strip().split(",")]
                    for line in f if line.strip()]
        data = {name: np.array([r[i] for r in rows])
                for i, name in enumerate(header)}
        n = len(rows)
        data["_index"] = np.arange(n, dtype=np.float64)
        tattr = node.get("Time")
        if tattr:
            # a time expression in iterations, over the CSV's rows
            saved, self.horizon = self.horizon, n
            t = self._eval(data, tattr)
            self.horizon = saved
        else:
            t = data["_index"] * (self.horizon / n)
        # np.interp needs an increasing grid: sort, and refuse duplicates
        order = np.argsort(t, kind="stable")
        t = np.asarray(t, dtype=np.float64)[order]
        if (np.diff(t) <= 0).any():
            raise ValueError(f"<CSV {fn}>: Time column has duplicate or "
                             "non-increasing entries after sorting")
        grid = np.arange(self.horizon, dtype=np.float64)
        for name, col in data.items():
            context[name] = np.interp(grid, t, np.asarray(col)[order])
        # <Params> may also sit inside <CSV>
        for child in node:
            if child.tag == "Params":
                self._params(child, context)

    def _params(self, node: ET.Element, context: dict) -> None:
        s = self.solver
        for name, raw in node.attrib.items():
            par, zones = name, None
            if "-" in name:
                par, zname = name.split("-", 1)
                if zname in s.geometry.setting_zones:
                    zones = [s.geometry.setting_zones[zname]]
                else:
                    log.warning(f"unknown zone {zname!r} (Control "
                                f"setting {par})")
                    continue
            if par not in s.model.setting_index:
                continue
            if zones is None:
                # zone-less: every allocated zone
                zones = sorted({0} | set(s.geometry.setting_zones.values()))
            series = self._eval(context, raw)
            for z in zones:
                s.lattice.set_setting_series(par, series, zone=z)


class _Callback(Handler):
    """A callback that fires once at init when it has no interval."""

    kind = "callback"

    def init(self) -> int:
        super().init()
        if not self.every_iter:
            return self.do_it()
        return 0


class cbVTK(_Callback):
    def do_it(self) -> int:
        w = self.node.get("what")
        compress = (self.node.get("compress", "") or "").lower() \
            in ("1", "true", "yes")
        self.solver.write_vtk(set(w.split(",")) if w else None,
                              compress=compress)
        return 0


class cbLog(_Callback):
    def do_it(self) -> int:
        self.solver.write_log()
        return 0


class cbSample(Handler):
    """<Sample what="U,Rho" Iterations="N"><Point dx=... dy=.../></Sample>:
    per-iteration point probes, flushed to ``<prefix>_Sample.csv`` on each
    firing.  While attached, the lattice steps on the eager engine."""

    kind = "callback"

    def init(self) -> int:
        super().init()
        if not self.every_iter:
            raise ValueError("Sampler needs a nonzero Iterations attribute")
        s = self.solver
        what = self.node.get("what")
        quants = ([q.name for q in s.model.quantities if not q.adjoint]
                  if not what or what == "all" else what.split(","))
        pts = []
        for p in self.node:
            if p.tag != "Point":
                raise ValueError(f"unknown element <{p.tag}> in Sampler")
            x = int(round(s.units.alt(p.get("dx", "0"))))
            y = int(round(s.units.alt(p.get("dy", "0"))))
            z = int(round(s.units.alt(p.get("dz", "0"))))
            pts.append((z, y, x)[-s.model.ndim:])
        self.sampler = Sampler(s.model, quants, np.asarray(pts),
                               s.out_path("Sample", "csv", with_iter=False))
        s.lattice.attach_sampler(self.sampler)
        return 0

    def do_it(self) -> int:
        self.sampler.flush()
        return 0

    def finish(self) -> int:
        self.sampler.flush()
        self.solver.lattice.detach_sampler()
        return 0


class cbKeep(Handler):
    """<Keep What="..." Above=|Below=|Equal=... Rate=...>: a feedback loop
    on the host that holds a Global at a target by adjusting its InObj
    weight."""

    kind = "callback"

    def init(self) -> int:
        super().init()
        self.gname = self.node.get("What")
        if self.gname not in self.solver.model.global_index:
            raise ValueError(f"Keep: unknown global {self.gname!r}")
        for mode in ("Above", "Below", "Equal"):
            if self.node.get(mode) is not None:
                self.mode = mode
                self.target = self.solver.units.alt(self.node.get(mode))
                break
        else:
            raise ValueError("Keep needs Above=, Below= or Equal=")
        self.rate = float(self.node.get("Rate", "1.0"))
        return 0

    def do_it(self) -> int:
        s = self.solver
        val = s.lattice.get_globals()[self.gname]
        wname = self.gname + "InObj"
        cur = float(s.lattice.params.settings[
            s.model.setting_index[wname]])
        err = val - self.target
        if (self.mode == "Above" and err < 0) or \
           (self.mode == "Below" and err > 0) or self.mode == "Equal":
            cur -= self.rate * err
            s.lattice.set_setting(wname, cur)
        return 0


class cbStop(Handler):
    """<Stop GlobalChange="eps" Times="k">: stop when every watched Global
    changed less than eps for k consecutive checks."""

    kind = "callback"

    def init(self) -> int:
        super().init()
        self.watch: list[tuple[str, float]] = []
        for g in self.solver.model.globals_:
            a = self.node.get(g.name + "Change")
            if a is not None:
                self.watch.append((g.name, float(a)))
        if not self.watch:
            raise ValueError("No *Change attribute in <Stop>")
        self.times = int(self.node.get("Times", "1"))
        self.old = {n: -12341234.0 for n, _ in self.watch}
        self.score = 0
        return 0

    def do_it(self) -> int:
        g = self.solver.lattice.get_globals()
        any_change = 0
        for name, eps in self.watch:
            if abs(self.old[name] - g[name]) > eps:
                any_change += 1
            self.old[name] = g[name]
        self.score = 0 if any_change else self.score + 1
        if self.score >= self.times:
            self.score = 0
            for name, _ in self.watch:
                self.old[name] = -12341234.0
            return ITERATION_STOP
        return 0


class cbFailcheck(Handler):
    """<Failcheck Iterations="N">: scan the quantities for non-finite
    values; on failure run the child elements (a rescue dump), then
    stop."""

    kind = "callback"

    def do_it(self) -> int:
        s = self.solver
        what = self.node.get("what")
        names = set(what.split(",")) if what else {"all"}
        bad = False
        for q in s.model.quantities:
            if q.adjoint:
                continue
            if "all" not in names and q.name not in names:
                continue
            arr = s.lattice.get_quantity(q.name).cpu().numpy()
            finite = np.isfinite(arr)
            if not finite.all():
                log.warning(f"Failcheck: {q.name} has "
                            f"{int(arr.size - finite.sum())} non-finite "
                            f"values at iteration {s.iter}")
                bad = True
                break
        if bad:
            for child in self.node:
                h = get_handler(child, self.solver)
                if h is not None:
                    h.init()
                    h.do_it()
            return ITERATION_STOP
        return 0


class cbAveraging(Handler):
    """<Average>: reset the running averages (``average=True`` densities)
    and restart their sample counter, at init and on every firing."""

    kind = "callback"

    def init(self) -> int:
        super().init()
        return self.do_it()

    def do_it(self) -> int:
        self.solver.lattice.reset_average()
        return 0


class acSyntheticTurbulence(Handler):
    """<SyntheticTurbulence>: configure the synthetic-inflow turbulence
    generator.  Wave parameters take <name>WaveLength (inverted),
    <name>WaveNumber or <name>WaveFrequency (times 2 pi), all
    unit-converted; the spectrum is "Von Karman" or "One Wave"."""

    def _wave_number(self, name: str):
        u = self.solver.units
        val = None
        a = self.node.get(name + "WaveLength")
        if a is not None:
            val = 1.0 / u.alt(a)
        a = self.node.get(name + "WaveNumber")
        if a is not None:
            val = u.alt(a)
        a = self.node.get(name + "WaveFrequency")
        if a is not None:
            val = u.alt(a) * 2.0 * math.pi
        return val

    def init(self) -> int:
        super().init()
        st = SyntheticTurbulence()
        nmodes = int(self.node.get("Modes", 100))
        spec = self.node.get("Spectrum", "Von Karman")
        if spec == "Von Karman":
            main_wn = self._wave_number("Main")
            diff_wn = self._wave_number("Diffusion")
            if main_wn is None or diff_wn is None:
                raise ValueError(
                    "Von Karman spectrum needs MainWaveNumber and "
                    "DiffusionWaveNumber (or WaveLength/Frequency forms)")
            max_wn = self._wave_number("Shortest")
            if max_wn is None:
                max_wn = 2.0 * math.pi / 4.0   # 2 pi over 4 elements
            min_wn = self._wave_number("Longest")
            if min_wn is None:
                min_wn = main_wn / 2.0
            frac = st.set_von_karman(main_wn, diff_wn, min_wn, max_wn,
                                     nmodes)
            if frac < 0.7:
                log.notice(f"synthetic turbulence resolves only "
                           f"{frac:.0%} of the spectrum")
        elif spec == "One Wave":
            wn = self._wave_number("")
            if wn is None:
                raise ValueError("One Wave spectrum needs a WaveNumber")
            st.set_one_wave(wn)
        else:
            raise ValueError(f"unknown spectrum {spec!r}")
        t_wn = self._wave_number("Time")
        if t_wn is None:
            raise ValueError("synthetic turbulence needs TimeWaveNumber "
                             "(iteration correlation scale)")
        st.set_time_scale(t_wn)
        self.solver.synthetic_turbulence = st
        return 0


class acNop(Handler):
    """Elements handled elsewhere (<Units> is read before the tree
    runs)."""

    def init(self) -> int:
        return 0


_HANDLERS = {
    "CLBConfig": MainContainer,
    "Solve": acSolve,
    "Repeat": acRepeat,
    "Geometry": acGeometry,
    "Model": acModel,
    "Init": acInit,
    "Params": acParams,
    "VTK": cbVTK,
    "Log": cbLog,
    "Stop": cbStop,
    "Failcheck": cbFailcheck,
    "Average": cbAveraging,
    "SyntheticTurbulence": acSyntheticTurbulence,
    "Control": conControl,
    "Sample": cbSample,
    "Keep": cbKeep,
    "Units": acNop,
}

# elements of the JAX package's handler table not ported yet -> the ROADMAP
# queue 1 item that ports them
_WAITING = {
    "OptSolve": 11, "OptimalControl": 10, "OptimalControlSecond": 10,
    "Fourier": 10, "BSpline": 10, "RepeatControl": 10,
    "BIN": 13, "SaveBinary": 13, "SaveMemoryDump": 13, "SaveCheckpoint": 13,
    "LoadBinary": 13, "LoadMemoryDump": 13,
    "TXT": 15, "Catalyst": 15, "DumpSettings": 15, "CallPython": 15,
    "Container": 15, "FieldParameter": 15, "ControlParameter": 15,
}


def _optimization_handlers() -> dict:
    from tclb_tpu_torch.control.opt_handlers import HANDLERS
    return HANDLERS


def get_handler(node: ET.Element, solver: Solver) -> Optional[Handler]:
    """Element name -> handler instance."""
    cls = _HANDLERS.get(node.tag) or _optimization_handlers().get(node.tag)
    if cls is not None:
        return cls(node, solver)
    if node.tag in _WAITING:
        raise NotImplementedError(
            f"<{node.tag}> is not ported to PyTorch yet (ROADMAP queue 1, "
            f"item {_WAITING[node.tag]})")
    raise ValueError(f"unknown config element <{node.tag}>")
