"""Units & gauging engine — behavioral parity with the reference's
``UnitVal``/``UnitEnv`` (reference src/unit.h:29-199, src/unit.cpp:60-275).

A value with unit is ``val * m^u0 s^u1 kg^u2 K^u3 x^u4 y^u5 z^u6 A^u7 t^u8``
(reference m_units, src/unit.h:18).  The user supplies *gauge* equations
(e.g. ``Viscosity="0.1m2/s"`` together with the model's lattice value) and
the scales of all nine base units are solved from the gauge set by Gauss
elimination over the unit-exponent matrix in log space (reference
UnitEnv::makeGauge, src/unit.cpp:223-262).  ``alt()`` converts an SI-tagged
value into lattice units — every attribute read in the control layer goes
through it, as in the reference.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

M_UNITS = ("m", "s", "kg", "K", "x", "y", "z", "A", "t")
N_UNITS = len(M_UNITS)


@dataclass(frozen=True)
class UnitVal:
    """value * prod(base_i ^ uni_i)  (reference UnitVal, src/unit.h:29-135)."""

    val: float = 0.0
    uni: tuple[int, ...] = (0,) * N_UNITS

    def __mul__(self, o: "UnitVal | float") -> "UnitVal":
        o = _coerce(o)
        return UnitVal(self.val * o.val,
                       tuple(a + b for a, b in zip(self.uni, o.uni)))

    def __truediv__(self, o: "UnitVal | float") -> "UnitVal":
        o = _coerce(o)
        return UnitVal(self.val / o.val,
                       tuple(a - b for a, b in zip(self.uni, o.uni)))

    def __add__(self, o: "UnitVal") -> "UnitVal":
        o = _coerce(o)
        if o.uni != self.uni:
            raise ValueError(
                f"Different units in addition: {self} + {o}")
        return UnitVal(self.val + o.val, self.uni)

    def __pow__(self, n: int) -> "UnitVal":
        return UnitVal(self.val ** n, tuple(u * n for u in self.uni))

    def same_unit(self, o: "UnitVal") -> bool:
        return self.uni == o.uni

    def __str__(self) -> str:
        s = f"{self.val:g} [ "
        s += " ".join(f"{m}^{u}" for m, u in zip(M_UNITS, self.uni))
        return s + " ]"


def _coerce(v) -> UnitVal:
    return v if isinstance(v, UnitVal) else UnitVal(float(v))


def _base(k: int) -> UnitVal:
    uni = [0] * N_UNITS
    uni[k] = 1
    return UnitVal(1.0, tuple(uni))


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


class UnitEnv:
    """Unit environment: unit dictionary + gauge + scales
    (reference UnitEnv, src/unit.h:147-199)."""

    def __init__(self):
        self.units: dict[str, UnitVal] = {}
        self.gauge: dict[str, UnitVal] = {}
        self.scale = np.ones(N_UNITS)
        for i, name in enumerate(M_UNITS):
            self.units[name] = _base(i)
        # derived units & prefixes (reference src/unit.cpp:69-96)
        for name, txt in (("N", "1kgm/s2"), ("Pa", "1N/m2"), ("J", "1Nm"),
                          ("W", "1J/s"), ("V", "1kgm2/t3/A"), ("C", "1tA"),
                          ("nm", "1e-9m"), ("um", "1e-6m"), ("mm", "1e-3m"),
                          ("cm", "1e-2m"), ("km", "1e+3m"), ("h", "3600s"),
                          ("ns", "1e-9s"), ("us", "1e-6s"), ("ms", "1e-3s"),
                          ("g", "1e-3kg"), ("mg", "1e-6kg")):
            self.units[name] = self.read_text(txt)
        self.units["d"] = UnitVal(math.pi / 180.0)
        self.units["%"] = UnitVal(0.01)
        self.units["An"] = UnitVal(6.022e23)

    # -- parsing ----------------------------------------------------------- #

    def _read_alpha(self, s: str, p: int) -> UnitVal:
        """Longest-prefix factorization of an alpha unit run, preferring the
        2-char head when both parses exist (reference readUnitAlpha,
        src/unit.cpp:105-140): e.g. 'ms2' -> (1e-3 s)^2, 'kgm' -> kg*m."""
        if s in self.units:
            return self.units[s] ** p
        for head in (2, 1):
            if len(s) > head and s[:head] in self.units:
                try:
                    return (self.units[s[:head]]
                            * self._read_alpha(s[head:], 1)) ** p
                except ValueError:
                    continue
        raise ValueError(f"Unknown unit: {s!r}")

    def read_unit(self, s: str) -> UnitVal:
        """Parse a unit expression: alpha runs with integer powers joined by
        nothing (multiply) or '/' (divide) — reference readUnit,
        src/unit.cpp:142-183."""
        ret = UnitVal(1.0)
        i, w = 0, 1
        while i < len(s):
            j = i
            while i < len(s) and s[i].isalpha() or (i < len(s) and s[i] == "%"):
                i += 1
            k = i
            while i < len(s) and s[i].isdigit():
                i += 1
            p = int(s[k:i]) if i > k else 1
            last = self._read_alpha(s[j:k], p) if k > j else UnitVal(1.0)
            ret = ret * last if w > 0 else ret / last
            j = i
            while i < len(s) and not (s[i].isalnum() or s[i] == "%"):
                i += 1
            if i - j > 1:
                raise ValueError(f"Too many non-alphanumeric chars in {s!r}")
            if i - j == 1:
                if s[j] != "/":
                    raise ValueError(f"Only '/' allowed in units, got {s[j]!r}")
                w = -1
        return ret

    def read_text(self, s: str) -> UnitVal:
        """number + unit, e.g. '0.1m2/s' (reference readText,
        src/unit.cpp:184-216)."""
        s = s.strip()
        m = _NUM_RE.match(s)
        if m:
            num, unit = float(m.group(0)), s[m.end():]
        else:
            num, unit = 1.0, s
        ret = self.read_unit(unit) if unit else UnitVal(1.0)
        return ret * num

    def __call__(self, s: str) -> UnitVal:
        return self.read_text(s)

    # -- conversion -------------------------------------------------------- #

    def si(self, v) -> float:
        if isinstance(v, str):
            v = self.read_text(v)
        return v.val

    def alt(self, v, default: float | None = None) -> float:
        """SI-tagged value -> lattice units using the solved gauge scales;
        strings may be sums like '1m+10cm' (reference alt(), src/unit.h:159-191).
        """
        if isinstance(v, str):
            if not v:
                if default is None:
                    raise ValueError("empty value with no default")
                return default
            total = 0.0
            for term in _split_terms(v):
                total += self.alt(self.read_text(term))
            return total
        if v is None:
            if default is None:
                raise ValueError("missing value with no default")
            return default
        ret = v.val
        for i in range(N_UNITS):
            ret *= self.scale[i] ** v.uni[i]
        return ret

    # -- gauging ------------------------------------------------------------ #

    def set_unit(self, name: str, v: UnitVal, lattice_value: float = None
                 ) -> None:
        """Add a gauge equation: SI value ``v`` corresponds to
        ``lattice_value`` lattice units (reference setUnit,
        src/unit.cpp:217-222)."""
        if lattice_value is not None:
            v = v / UnitVal(float(lattice_value))
        self.gauge[name] = v

    def make_gauge(self) -> None:
        """Solve base-unit scales from the gauge equations: each equation
        ``val * prod(base^uni) == 1`` becomes a linear equation
        ``sum(uni_j * log(scale_j)) == -log(val)``; unconstrained base units
        get scale 1 (reference makeGauge, src/unit.cpp:223-262)."""
        rows, rhs = [], []
        for v in self.gauge.values():
            rows.append(list(v.uni))
            rhs.append(math.log(v.val))
        # pad: any base unit untouched by the gauge gets scale 1
        touched = np.any(np.array(rows, dtype=float).reshape(-1, N_UNITS) != 0,
                         axis=0) if rows else np.zeros(N_UNITS, bool)
        for j in range(N_UNITS):
            if not touched[j]:
                if len(rows) >= N_UNITS:
                    raise ValueError("Gauge variables over-constructed")
                r = [0] * N_UNITS
                r[j] = 1
                rows.append(r)
                rhs.append(0.0)
        if len(rows) < N_UNITS:
            raise ValueError("Gauge variables under-constructed")
        if len(rows) > N_UNITS:
            raise ValueError("Gauge variables over-constructed")
        x = np.linalg.solve(np.array(rows, dtype=float),
                            np.array(rhs, dtype=float))
        self.scale = np.exp(-x)

    def gauge_summary(self) -> str:
        lines = ["/---------------[ GAUGE ]-----------------"]
        for name, v in self.gauge.items():
            lines.append(f"|  {name}: {v}")
        lines.append("-" * 42)
        for j, m in enumerate(M_UNITS):
            lines.append(f"| 1 {m} = {self.scale[j]:f} units")
        lines.append("\\" + "-" * 41)
        return "\n".join(lines)


def _split_terms(s: str) -> list[str]:
    """Split '1m+10cm-2mm' into signed terms, keeping exponent signs
    (reference alt() scanner, src/unit.h:166-190)."""
    terms, cur = [], ""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "+-" and cur and cur[-1].lower() != "e":
            terms.append(cur)
            cur = c if c == "-" else ""
        else:
            cur += c
        i += 1
    if cur:
        terms.append(cur)
    return terms
