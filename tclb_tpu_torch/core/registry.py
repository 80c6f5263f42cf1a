"""Model registry DSL — the TPU-native equivalent of the reference R DSL.

The reference describes every physical model with R calls (``AddDensity``,
``AddSetting``, ``AddGlobal``, ``AddQuantity``, ``AddNodeType``, ``AddStage``,
``AddAction`` — reference src/conf.R:104-339) and derives from them the
node-type bit packing (src/conf.R:391-447), the settings table and the kernel
dispatch table.  Here the same vocabulary is a set of Python dataclasses
collected by :class:`ModelDef` and frozen into a :class:`Model`, which the
lattice engine (core/lattice.py) consumes.  There is no code generation step:
models are ordinary Python functions on PyTorch tensors.

This is the PyTorch port's own copy of the JAX package's registry (numpy
only): the port imports nothing from the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------------- #
# Specs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Density:
    """A per-node stored & streamed variable (reference AddDensity, conf.R:104).

    ``dx,dy,dz`` is the streaming vector: during the streaming step the value
    at node ``x`` is pulled from ``x - (dx,dy,dz)`` (pull scheme, reference
    src/LatticeAccess.inc.cpp.Rt).  A density with a zero vector is stored but
    not moved (the reference uses those for coupling buffers, e.g. d2q9's
    ``BC[0]``, src/d2q9/Dynamics.R:18-20).
    """

    name: str
    dx: int = 0
    dy: int = 0
    dz: int = 0
    group: str = ""
    comment: str = ""
    average: bool = False       # participates in running averages (<Average>)
    parameter: bool = False     # is a design variable (adjoint optimization)


@dataclass(frozen=True)
class Field:
    """A stored, non-streamed array with a declared access stencil
    (reference AddField, conf.R:134).  Models read neighbors of a Field with
    ``ctx.load(name, dx, dy, dz)``; the declared ranges bound the halo width.
    """

    name: str
    dx_range: tuple[int, int] = (0, 0)
    dy_range: tuple[int, int] = (0, 0)
    dz_range: tuple[int, int] = (0, 0)
    group: str = ""
    comment: str = ""
    average: bool = False
    parameter: bool = False


@dataclass(frozen=True)
class Setting:
    """A scalar (or zonal) runtime parameter (reference AddSetting, conf.R:167).

    ``derived`` maps *other* setting names to functions of this setting's
    value: assigning this setting also assigns those (the reference expresses
    this as e.g. ``AddSetting(name="nu", omega='1.0/(3*nu+0.5)')``,
    src/d2q9/Dynamics.R:38).
    """

    name: str
    default: float = 0.0
    unit: str = "1"
    zonal: bool = False
    comment: str = ""
    derived: tuple[tuple[str, Callable[[float], float]], ...] = ()


@dataclass(frozen=True)
class GlobalSpec:
    """A monitored/optimized global integral (reference AddGlobal, conf.R:203).

    ``op`` is the reduction: "SUM" or "MAX".  Each global also implies an
    ``<name>InObj`` setting — its weight in the scalar objective (reference
    Lattice.cu.Rt:1113-1129)."""

    name: str
    op: str = "SUM"
    unit: str = "1"
    comment: str = ""


@dataclass(frozen=True)
class Quantity:
    """An exportable derived field (reference AddQuantity, conf.R:222)."""

    name: str
    unit: str = "1"
    vector: bool = False
    adjoint: bool = False
    comment: str = ""


@dataclass(frozen=True)
class NodeTypeSpec:
    name: str
    group: str


@dataclass(frozen=True)
class NodeType:
    """A packed node-type constant: ``(flags & mask) == value`` tests membership
    (reference packing algorithm at src/conf.R:391-447)."""

    name: str
    group: str
    value: int
    mask: int
    shift: int
    index: int


@dataclass(frozen=True)
class Stage:
    """One kernel pass (reference AddStage, conf.R:290).  ``main`` is the name
    of the model function run by the pass; ``load_densities`` controls whether
    streamed reads happen (Init stages don't stream)."""

    name: str
    main: str
    load_densities: bool = True
    save_fields: bool = True
    fixed_point: bool = False


# Default node types every model gets (reference src/conf.R:263-286).
_DEFAULT_NODE_TYPES: tuple[tuple[str, str], ...] = (
    ("BGK", "COLLISION"),
    ("MRT", "COLLISION"),
    ("Wall", "BOUNDARY"),
    ("Solid", "BOUNDARY"),
    ("WVelocity", "BOUNDARY"),
    ("WPressure", "BOUNDARY"),
    ("WPressureL", "BOUNDARY"),
    ("EPressure", "BOUNDARY"),
    ("EVelocity", "BOUNDARY"),
    ("Inlet", "OBJECTIVE"),
    ("Outlet", "OBJECTIVE"),
    ("DesignSpace", "DESIGNSPACE"),
)

FLAG_BITS = 16  # the reference's flag_t is a 16-bit bitfield (src/types.h:14)


class ModelDef:
    """Mutable model definition mirroring the reference DSL registration
    phase."""

    def __init__(self, name: str, ndim: int = 2, description: str = ""):
        self.name = name
        self.ndim = ndim
        self.description = description or name
        self.densities: list[Density] = []
        self.fields: list[Field] = []
        self.settings: list[Setting] = []
        self.globals_: list[GlobalSpec] = []
        self.quantities: list[Quantity] = []
        self._node_type_specs: list[NodeTypeSpec] = [
            NodeTypeSpec(n, g) for n, g in _DEFAULT_NODE_TYPES
        ]
        self.stages: list[Stage] = []
        self.actions: dict[str, tuple[str, ...]] = {}

    # -- registration API (names mirror the reference DSL) ----------------- #

    def add_density(self, name: str, dx: int = 0, dy: int = 0, dz: int = 0,
                    group: str = "", comment: str = "", average: bool = False,
                    parameter: bool = False) -> None:
        if not group:
            group = name.split("[")[0]
        self.densities.append(
            Density(name, dx, dy, dz, group, comment, average, parameter))

    def add_densities(self, base: str, e: Sequence[Sequence[int]],
                      group: str = "", **kw: Any) -> None:
        """Register a family ``base[i]`` with streaming vectors ``e[i]``."""
        for i, v in enumerate(e):
            v = tuple(v) + (0,) * (3 - len(v))
            self.add_density(f"{base}[{i}]", *v, group=group or base, **kw)

    def add_field(self, name: str, dx: Any = 0, dy: Any = 0, dz: Any = 0,
                  group: str = "", comment: str = "", average: bool = False,
                  parameter: bool = False) -> None:
        def _rng(r: Any) -> tuple[int, int]:
            if isinstance(r, (tuple, list)):
                return (int(min(r)), int(max(r)))
            return (min(0, int(r)), max(0, int(r)))
        if not group:
            group = name.split("[")[0]
        self.fields.append(Field(name, _rng(dx), _rng(dy), _rng(dz), group,
                                 comment, average, parameter))

    def add_setting(self, name: str, default: float = 0.0, unit: str = "1",
                    zonal: bool = False, comment: str = "",
                    derived: Optional[dict[str, Callable[[float], float]]] = None
                    ) -> None:
        d = tuple(sorted((derived or {}).items()))
        self.settings.append(Setting(name, float(default), unit, zonal, comment, d))

    def add_global(self, name: str, op: str = "SUM", unit: str = "1",
                   comment: str = "") -> None:
        assert op in ("SUM", "MAX"), op
        self.globals_.append(GlobalSpec(name, op, unit, comment))

    def add_quantity(self, name: str, unit: str = "1", vector: bool = False,
                     adjoint: bool = False, comment: str = "") -> None:
        self.quantities.append(Quantity(name, unit, vector, adjoint, comment))

    def add_node_type(self, name: str, group: str) -> None:
        self._node_type_specs.append(NodeTypeSpec(name, group))

    def add_stage(self, name: str, main: str = "", load_densities: bool = True,
                  save_fields: bool = True, fixed_point: bool = False) -> None:
        self.stages.append(
            Stage(name, main or name, load_densities, save_fields, fixed_point))

    def add_action(self, name: str, stages: Sequence[str]) -> None:
        self.actions[name] = tuple(stages)

    # -- finalize ----------------------------------------------------------- #

    def finalize(self) -> "Model":
        # Default stages/actions (reference src/conf.R:350-363): every model
        # has an Iteration action running the "Run" stage and an Init action.
        stages = list(self.stages)
        actions = dict(self.actions)
        if "Iteration" not in actions:
            actions["Iteration"] = ("BaseIteration",)
        if "Init" not in actions:
            actions["Init"] = ("BaseInit",)
        names = {s.name for s in stages}
        if "BaseIteration" in {st for a in actions.values() for st in a} \
                and "BaseIteration" not in names:
            stages.append(Stage("BaseIteration", "Run", True, True))
        if "BaseInit" in {st for a in actions.values() for st in a} \
                and "BaseInit" not in names:
            stages.append(Stage("BaseInit", "Init", False, True))
        return Model(self, stages, actions)


def _pack_node_types(specs: Sequence[NodeTypeSpec]) -> tuple[dict, dict, int, int]:
    """Pack node-type groups into a 16-bit flag.

    Same algorithm as the reference (src/conf.R:391-447): groups are laid out
    in alphabetical order; a group with n members occupies ceil(log2(n+1))
    bits holding values 1..n; remaining high bits are the settings-zone index.
    Returns (types, group_masks, zone_shift, zone_bits).
    """
    seen: dict[str, list[str]] = {}
    for s in specs:
        seen.setdefault(s.group, [])
        if s.name not in seen[s.group]:
            seen[s.group].append(s.name)
    types: dict[str, NodeType] = {}
    group_masks: dict[str, int] = {}
    shift = 0
    for group in sorted(seen):
        members = seen[group]
        bits = math.ceil(math.log2(len(members) + 1))
        mask = ((1 << bits) - 1) << shift
        group_masks[group] = mask
        for i, name in enumerate(members, start=1):
            types[name] = NodeType(name, group, i << shift, mask, shift, i)
        shift += bits
    if shift > FLAG_BITS:
        raise ValueError(
            f"node types need {shift} bits; flag is {FLAG_BITS}-bit")
    zone_shift = shift
    zone_bits = FLAG_BITS - shift
    group_masks["SETTINGZONE"] = ((1 << zone_bits) - 1) << zone_shift
    types["DefaultZone"] = NodeType("DefaultZone", "SETTINGZONE", 0,
                                    group_masks["SETTINGZONE"], zone_shift, 1)
    types["None"] = NodeType("None", "NONE", 0, 0, 0, 1)
    group_masks["ALL"] = (1 << FLAG_BITS) - 1
    return types, group_masks, zone_shift, zone_bits


class Model:
    """Frozen model metadata consumed by the lattice engine.

    Physics callables are attached by the model module via
    :meth:`bind` — ``run``/``init`` operate on a :class:`~tclb_tpu_torch.core.lattice.NodeCtx`.
    """

    def __init__(self, d: ModelDef, stages: list[Stage],
                 actions: dict[str, tuple[str, ...]]):
        self.name = d.name
        self.ndim = d.ndim
        self.description = d.description
        self.densities = tuple(d.densities)
        self.fields = tuple(d.fields)
        self.settings = tuple(d.settings)
        self.globals_ = tuple(d.globals_)
        self.quantities = tuple(d.quantities)
        self.stages = {s.name: s for s in stages}
        self.actions = dict(actions)

        # storage layout: densities first, then fields, one plane each
        self.storage_names = tuple([x.name for x in self.densities]
                                   + [x.name for x in self.fields])
        self.storage_index = {n: i for i, n in enumerate(self.storage_names)}
        self.n_storage = len(self.storage_names)
        # streaming vectors, zero-padded for fields
        ei = [(x.dx, x.dy, x.dz) for x in self.densities] \
            + [(0, 0, 0) for _ in self.fields]
        self.ei = np.array(ei, dtype=np.int32)

        # group -> ordered storage indices (densities and fields share groups)
        groups: dict[str, list[int]] = {}
        for i, x in enumerate(list(self.densities) + list(self.fields)):
            groups.setdefault(x.group, []).append(i)
        self.groups = {g: tuple(ix) for g, ix in groups.items()}

        # settings layout; every Global implies an "<name>InObj" weight setting
        # (reference src/conf.R:212-216)
        settings = list(self.settings)
        have = {s.name for s in settings}
        for g in self.globals_:
            if g.name + "InObj" not in have:
                settings.append(Setting(g.name + "InObj", 0.0, "1", False,
                                        f"weight of {g.name} in objective"))
        self.settings = tuple(settings)
        self.setting_index = {s.name: i for i, s in enumerate(self.settings)}
        self.setting_defaults = np.array([s.default for s in self.settings],
                                         dtype=np.float64)
        self.zonal_settings = tuple(s.name for s in self.settings if s.zonal)

        self.global_index = {g.name: i for i, g in enumerate(self.globals_)}
        self.n_globals = len(self.globals_)

        (self.node_types, self.group_masks,
         self.zone_shift, self.zone_bits) = _pack_node_types(d._node_type_specs)
        self.zone_max = 1 << self.zone_bits

        # physics callables, bound by the model module
        self.run: Optional[Callable] = None
        self.init: Optional[Callable] = None
        self.quantity_fns: dict[str, Callable] = {}
        self.stage_fns: dict[str, Callable] = {}
        self.max_stencil = int(np.max(np.abs(self.ei))) if len(ei) else 1
        for f in self.fields:
            for lo, hi in (f.dx_range, f.dy_range, f.dz_range):
                self.max_stencil = max(self.max_stencil, abs(lo), abs(hi))

    # -- structural identity ------------------------------------------------ #

    def structural_key(self) -> tuple:
        """A hashable tuple of everything the kernel engines specialize on:
        storage layout, streaming vectors, declared stencils, settings
        (zonal-ness + derived targets), globals, node-type packing and the
        stage/action plan.  Two independently built instances of the same
        model compare equal, so caches keyed on this survive model rebuilds
        — unlike ``id(model)`` keys, which both alias recycled addresses
        and miss rebuilt-but-identical models."""
        return (
            self.name, self.ndim,
            tuple((x.name, x.dx, x.dy, x.dz, x.group, x.average,
                   x.parameter) for x in self.densities),
            tuple((x.name, x.dx_range, x.dy_range, x.dz_range, x.group,
                   x.average, x.parameter) for x in self.fields),
            tuple((s.name, s.default, s.zonal,
                   tuple(t for t, _ in s.derived)) for s in self.settings),
            tuple((g.name, g.op) for g in self.globals_),
            tuple((t.name, t.group, t.value, t.mask, t.shift)
                  for t in self.node_types.values()),
            tuple((s.name, s.main, s.load_densities, s.save_fields,
                   s.fixed_point) for s in self.stages.values()),
            tuple((a, tuple(st)) for a, st in sorted(self.actions.items())),
        )

    @property
    def fingerprint(self) -> str:
        """Short stable hex digest of :meth:`structural_key`."""
        if getattr(self, "_fingerprint", None) is None:
            import hashlib
            raw = repr(self.structural_key()).encode()
            self._fingerprint = hashlib.sha1(raw).hexdigest()[:16]
        return self._fingerprint

    # -- binding physics ---------------------------------------------------- #

    def bind(self, run: Callable = None, init: Callable = None,
             quantities: Optional[dict[str, Callable]] = None,
             stages: Optional[dict[str, Callable]] = None) -> "Model":
        self.run = run
        self.init = init
        if quantities:
            self.quantity_fns.update(quantities)
        self.stage_fns = {"Run": run, "Init": init}
        if stages:
            self.stage_fns.update(stages)
        return self

    # -- node-type helpers -------------------------------------------------- #

    def nt_value(self, name: str) -> int:
        return self.node_types[name].value

    def group_mask(self, group: str) -> int:
        return self.group_masks[group]

    def flag_for(self, *names: str, zone: int = 0) -> int:
        """Compose a flag value from node-type names + a settings-zone index
        (what the geometry painter writes into the flag field)."""
        v = 0
        for n in names:
            v |= self.node_types[n].value
        return v | (zone << self.zone_shift)

    def settings_vector(self, values: Optional[dict[str, float]] = None
                        ) -> np.ndarray:
        """Defaults + user values, with derived-setting propagation
        (reference src/Lattice.cu.Rt:1164-1191)."""
        vec = self.setting_defaults.copy()
        # propagate defaults through derived chains recursively, in
        # declaration order, so later defaults (e.g. nu) re-derive earlier
        # targets (omega, then S78) consistently
        for s in self.settings:
            self._set_with_derived(vec, s.name, vec[self.setting_index[s.name]])
        for k, v in (values or {}).items():
            self._set_with_derived(vec, k, float(v))
        return vec

    def _set_with_derived(self, vec: np.ndarray, name: str, value: float) -> None:
        if name not in self.setting_index:
            raise KeyError(f"model {self.name} has no setting {name!r}; "
                           f"has: {sorted(self.setting_index)}")
        vec[self.setting_index[name]] = value
        for s in self.settings:
            if s.name == name:
                for target, fn in s.derived:
                    self._set_with_derived(vec, target, fn(value))
