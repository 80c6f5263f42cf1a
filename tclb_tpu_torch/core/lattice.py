"""Lattice engine on PyTorch: state, streaming, per-stage step, iteration.

The port's counterpart of the JAX package's ``core/lattice.py``.  Same
planar layout at every public function: fields ``(n_storage, *shape)``,
flags with the registry's bit packing, globals and settings in registry
order.  Inside, PyTorch idiom: dataclasses of tensors, an explicit
``device``, and Python loops where the JAX package scans.

Flags live on the device as an int32 copy (``torch.uint16`` has no shift on
the CPU, and the zone id is ``flags >> zone_shift``); they cross to numpy as
uint16 in ``set_flags``, ``flags_numpy`` and ``save``/``load``.

Engines: the eager path below runs every model at any dtype.  For ``d2q9``
and its family and ``d3q27_cumulant`` at f32 the hand-written CUDA kernels of
:mod:`tclb_tpu_torch.ops.d2q9_kernels` and
:mod:`tclb_tpu_torch.ops.d3q27_kernels` take ``niter - 1`` steps and one
eager step computes the globals (the JAX package's hybrid); the generic
kernels of :mod:`tclb_tpu_torch.ops.generic_kernels` and
:mod:`tclb_tpu_torch.ops.generic3d_kernels` (the models with a device
header) sum the globals themselves (``full_globals``) and take all
``niter`` steps.  Under a ``<Control>`` time series only the generic band
engines, which read the series per step (``supports_series``), are
chosen; with a ``<Sample>`` sampler attached every step is eager.
The engine is chosen by each module's ``supports()``; a kernel that fails
to build or launch fails the run — nothing falls back to eager after a
failure.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from tclb_tpu_torch.core import shift as ddf
from tclb_tpu_torch.core.registry import Model
from tclb_tpu_torch.utils import log

FLAG_DTYPE = torch.int32     # device-side flag copy (uint16 at numpy seams)


@dataclasses.dataclass
class SimParams:
    """Runtime settings: ``settings[s]`` for plain settings and
    ``zone_table[s, z]`` for the value of setting ``s`` in zone ``z``.

    ``<Control>`` time series: row ``r`` of the ``(n_series, T)``
    ``time_series`` is the per-iteration value of the (setting, zone) pair
    that ``series_map`` lists as ``(setting_index, zone, r)``.  At
    iteration ``t`` that zone reads ``time_series[r, t % T]`` instead of
    its ``zone_table`` entry."""

    settings: torch.Tensor       # (n_settings,)
    zone_table: torch.Tensor     # (n_settings, zone_max)
    time_series: Optional[torch.Tensor] = None   # (n_series, T)
    series_map: tuple = ()


@dataclasses.dataclass
class LatticeState:
    """The complete per-step lattice state."""

    fields: torch.Tensor         # (n_storage, *shape)
    flags: torch.Tensor          # (*shape) int32 node-type bitfield
    globals_: torch.Tensor       # (n_globals,) last step's integrals
    iteration: int


def resolve_device(device: Any = None) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "eager engine on the host")
    return dev


# --------------------------------------------------------------------------- #
# Streaming
# --------------------------------------------------------------------------- #


def pull_stream(model: Model, fields: torch.Tensor) -> torch.Tensor:
    """Pull-scheme streaming with periodic wrap: plane ``i`` at node ``x``
    receives the value stored at ``x - e_i``.  ``torch.roll(a, s)[x] ==
    a[x - s]``, so rolling plane ``i`` by ``e_i`` is exactly the pull."""
    ndim = model.ndim
    out = []
    for i in range(model.n_storage):
        dx, dy, dz = (int(v) for v in model.ei[i])
        shifts, dims = [], []
        for shift, dim in ((dz, -3), (dy, -2), (dx, -1)):
            if shift and ndim >= -dim:
                shifts.append(shift)
                dims.append(dim)
        plane = fields[i]
        out.append(torch.roll(plane, shifts, dims) if shifts else plane)
    return torch.stack(out)


class Streaming:
    """Streaming strategy: the single-device periodic pull.  The sharded
    strategy waits for ROADMAP queue 1 item 12."""

    def __init__(self, model: Model):
        self.model = model

    def pull(self, fields: torch.Tensor) -> torch.Tensor:
        return pull_stream(self.model, fields)

    def make_loader(self, raw: torch.Tensor) -> Callable:
        """``load(index, dx, dy, dz)``: the value of storage plane
        ``index`` at ``x + (dx, dy, dz)`` with periodic wrap, which is a
        roll by ``-d`` (``torch.roll(a, s)[x] == a[x - s]``)."""
        ndim = self.model.ndim

        def load(index: int, dx: int, dy: int, dz: int) -> torch.Tensor:
            shifts, dims = [], []
            for shift, dim in ((dz, -3), (dy, -2), (dx, -1)):
                if shift and ndim >= -dim:
                    shifts.append(-shift)
                    dims.append(dim)
            plane = raw[index]
            return torch.roll(plane, shifts, dims) if shifts else plane

        return load


# --------------------------------------------------------------------------- #
# Control time series
# --------------------------------------------------------------------------- #


def _series_rows(params: SimParams, i: int) -> list:
    return [(z, r) for (si, z, r) in params.series_map if si == i]


def series_overrides(params: SimParams, i: int, iteration: int) -> list:
    """``[(zone, value)]`` overrides of setting ``i`` from its <Control>
    time series at ``iteration`` (wrapping modulo the horizon); empty
    without a series.  ``value`` is a 0-d tensor."""
    rows = _series_rows(params, i)
    if not rows or params.time_series is None:
        return []
    t = int(iteration) % params.time_series.shape[1]
    return [(z, params.time_series[r, t]) for z, r in rows]


def series_dt_overrides(params: SimParams, i: int, iteration: int) -> list:
    """``[(zone, d/dt value)]`` of setting ``i``'s series: central
    differences, one-sided at the ends of the horizon (the horizon is
    finite, not periodic: a wrapped difference would mix its two ends);
    empty without a series."""
    rows = _series_rows(params, i)
    if not rows or params.time_series is None:
        return []
    ts = params.time_series
    T = ts.shape[1]
    t = int(iteration) % T
    lo, hi = max(t - 1, 0), min(t + 1, T - 1)
    span = float(max(hi - lo, 1))
    return [(z, (ts[r, hi] - ts[r, lo]) / span) for z, r in rows]


# --------------------------------------------------------------------------- #
# Node context — what a model's Run()/Init() sees
# --------------------------------------------------------------------------- #


class NodeCtx:
    """The model-facing view of one lattice-wide step: every accessor
    returns whole planes, and per-node dispatch is mask algebra."""

    def __init__(self, model: Model, fields: torch.Tensor,
                 raw: torch.Tensor, flags: torch.Tensor, params: SimParams,
                 iteration: int = 0, avg_start: int = 0,
                 present: Optional[set] = None,
                 compute_globals: bool = True,
                 loader: Optional[Callable] = None):
        self.model = model
        self._fields = fields      # pulled (streamed) storage
        self._raw = raw            # un-streamed storage (for Field loads)
        self._loader = loader or Streaming(model).make_loader(raw)
        self.flags = flags
        self.params = params
        self.iteration = iteration
        self.avg_start = avg_start
        self.present = present
        self.compute_globals = compute_globals
        self._globals: dict[str, torch.Tensor] = {}
        self._zone_ids: Optional[torch.Tensor] = None

    def avg_samples(self) -> torch.Tensor:
        """Iterations accumulated into the running averages since the last
        <Average> reset (``iteration - avg_start``); at least 1."""
        n = max(int(self.iteration) - int(self.avg_start), 1)
        return torch.tensor(float(n), dtype=self._fields.dtype,
                            device=self._fields.device)

    # -- field access ------------------------------------------------------- #

    def group(self, name: str) -> torch.Tensor:
        """Streamed stack of all densities in a group: (n, *shape)."""
        idx = self.model.groups[name]
        return self._fields[list(idx)]

    def density(self, name: str) -> torch.Tensor:
        return self._fields[self.model.storage_index[name]]

    def load(self, name: str, dx: int = 0, dy: int = 0, dz: int = 0
             ) -> torch.Tensor:
        """Neighbour access to a stored Field on the un-streamed storage:
        the value at ``x + (dx, dy, dz)``, periodic."""
        return self._loader(self.model.storage_index[name], dx, dy, dz)

    def store(self, groups: dict[str, torch.Tensor]) -> dict:
        """Declare the stage's write set (group/plane name -> new stack);
        unmentioned planes keep their un-streamed value."""
        return groups

    # -- settings ----------------------------------------------------------- #

    def setting(self, name: str) -> torch.Tensor:
        """Scalar for plain settings; per-node plane for zonal settings,
        gathered through the flag's zone bits.  Zones with a <Control>
        time series read this iteration's entry instead."""
        i = self.model.setting_index[name]
        if not self.model.settings[i].zonal:
            return self.params.settings[i]
        plane = self.params.zone_table[i][self._zones()]
        for z, v in series_overrides(self.params, i, self.iteration):
            plane = torch.where(self._zones() == z, v.to(plane.dtype), plane)
        return plane

    def setting_dt(self, name: str) -> torch.Tensor:
        """Time derivative of a zonal setting from its time series
        (:func:`series_dt_overrides`); zero where no series applies."""
        i = self.model.setting_index[name]
        plane = torch.zeros(self.flags.shape, dtype=self._fields.dtype,
                            device=self._fields.device)
        for z, v in series_dt_overrides(self.params, i, self.iteration):
            plane = torch.where(self._zones() == z, v.to(plane.dtype), plane)
        return plane

    def _zones(self) -> torch.Tensor:
        if self._zone_ids is None:
            self._zone_ids = (self.flags >> self.model.zone_shift).long()
        return self._zone_ids

    # -- node types --------------------------------------------------------- #

    def nt_is(self, name: str) -> torch.Tensor:
        """Bool plane: the node's group field equals this node type."""
        t = self.model.node_types[name]
        return (self.flags & t.mask) == t.value

    def nt_in_group(self, group: str) -> torch.Tensor:
        """Bool plane: any bit of the group's field is set."""
        return (self.flags & self.model.group_masks[group]) != 0

    def boundary_case(self, f: torch.Tensor,
                      cases: dict[Any, Callable[[torch.Tensor],
                                                torch.Tensor]]
                      ) -> torch.Tensor:
        """Vectorized ``switch (NodeType & NODE_<group>)``: nodes whose
        group field equals a case's type select that case's result (a
        tuple key shares one function between several types); cases of
        types not painted are skipped."""
        from tclb_tpu_torch.models.family import dispatch_boundary_cases
        return dispatch_boundary_cases(cases, f, self.nt_is, self.present)

    # -- globals ------------------------------------------------------------ #

    def add_global(self, name: str, plane: torch.Tensor,
                   where: Optional[torch.Tensor] = None) -> None:
        """Accumulate a per-node contribution to a Global; ``where`` masks
        the contributing nodes."""
        if not self.compute_globals:
            return
        if where is not None:
            plane = torch.where(where, plane, torch.zeros_like(plane))
        if name in self._globals:
            self._globals[name] = self._globals[name] + plane
        else:
            self._globals[name] = plane

    def reduce_globals(self) -> torch.Tensor:
        m = self.model
        out = torch.zeros((m.n_globals,), dtype=self._fields.dtype,
                          device=self._fields.device)
        for name, plane in self._globals.items():
            g = m.globals_[m.global_index[name]]
            out[m.global_index[name]] = (torch.max(plane) if g.op == "MAX"
                                         else torch.sum(plane))
        return out


# --------------------------------------------------------------------------- #
# Step / iterate
# --------------------------------------------------------------------------- #


def make_stage_step(model: Model, stage_name: str,
                    streaming: Optional[Streaming] = None,
                    present: Optional[set] = None,
                    compute_globals: bool = True) -> Callable:
    """The step function of one stage.  ``present`` skips boundary cases
    of absent node types; ``compute_globals=False`` is the NoGlobals
    flavour (every reduction skipped)."""
    stage = model.stages[stage_name]
    fn = model.stage_fns[stage.main]
    if fn is None:
        raise ValueError(f"model {model.name}: stage {stage_name} has no "
                         f"bound function {stage.main!r}")
    streaming = streaming or Streaming(model)

    def step(state: LatticeState, params: SimParams) -> LatticeState:
        raw = state.fields
        pulled = streaming.pull(raw) if stage.load_densities else raw
        ctx = NodeCtx(model, pulled, raw, state.flags, params,
                      iteration=state.iteration, present=present,
                      compute_globals=compute_globals,
                      loader=streaming.make_loader(raw))
        new_fields = fn(ctx)
        if isinstance(new_fields, dict):
            # only the stage's write set is saved; every other plane keeps
            # its un-streamed storage
            buf = raw.clone()
            for name, stack in new_fields.items():
                if name in model.groups:
                    idx = list(model.groups[name])
                    buf[idx] = stack.reshape((len(idx),) + buf.shape[1:])
                else:
                    buf[model.storage_index[name]] = stack
            new_fields = buf
        if not compute_globals:
            return dataclasses.replace(state, fields=new_fields)
        stage_globals = ctx.reduce_globals()
        max_rows = [i for i, g in enumerate(model.globals_) if g.op == "MAX"]
        combined = state.globals_ + stage_globals
        if max_rows:
            combined[max_rows] = torch.maximum(state.globals_[max_rows],
                                               stage_globals[max_rows])
        return dataclasses.replace(state, fields=new_fields,
                                   globals_=combined)

    return step


def make_action_step(model: Model, action: str = "Iteration",
                     streaming: Optional[Streaming] = None,
                     present: Optional[set] = None,
                     compute_globals: bool = True) -> Callable:
    """Compose an action's stages into one step; the iteration counter
    advances once per streaming action."""
    steps = [make_stage_step(model, s, streaming, present=present,
                             compute_globals=compute_globals)
             for s in model.actions[action]]
    advances = any(model.stages[s].load_densities
                   for s in model.actions[action])

    def step(state: LatticeState, params: SimParams) -> LatticeState:
        if compute_globals:
            state = dataclasses.replace(
                state, globals_=torch.zeros_like(state.globals_))
        for s in steps:
            state = s(state, params)
        if advances:
            state = dataclasses.replace(state,
                                        iteration=state.iteration + 1)
        return state

    return step


def make_iterate(model: Model, action: str = "Iteration",
                 streaming: Optional[Streaming] = None,
                 present: Optional[set] = None,
                 storage_dtype: Any = None,
                 storage_shift: Optional[np.ndarray] = None) -> Callable:
    """``niter``-step loop.  Its contract is "globals_ = the LAST step's
    integrals", so the first ``niter - 1`` steps run the NoGlobals flavour
    and only the final step reduces.

    ``storage_dtype`` (the storage ladder) narrows the carry: each step
    widens the fields to the compute dtype (the settings'), runs the whole
    action and narrows the result, so the state between steps is
    ``storage_dtype`` -- once per step, after the last stage, never
    between stages.  ``storage_shift`` is the float32 block of
    :func:`tclb_tpu_torch.core.shift.stack_shift` (``storage_repr=
    "shifted"``: the carry stores ``f_i - w_i``); ``None`` is the raw
    representation, pure casts.  Without ``storage_dtype`` nothing is
    cast."""
    step_ng = narrowed_step(make_action_step(
        model, action, streaming, present=present, compute_globals=False),
        storage_dtype, storage_shift)
    step_full = narrowed_step(make_action_step(
        model, action, streaming, present=present, compute_globals=True),
        storage_dtype, storage_shift)

    def iterate(state: LatticeState, params: SimParams, niter: int
                ) -> LatticeState:
        if niter <= 0:
            return state
        with torch.no_grad():
            for _ in range(niter - 1):
                state = step_ng(state, params)
            return step_full(state, params)

    return iterate


def narrowed_step(step: Callable, storage_dtype: Any = None,
                  storage_shift: Optional[np.ndarray] = None) -> Callable:
    """``step`` on a narrowed carry: widen the fields to the compute dtype
    (the settings') with the shift restored, run ``step``, narrow its
    fields with the shift removed.  ``storage_dtype=None``: ``step``
    itself."""
    if storage_dtype is None:
        return step

    def one(state: LatticeState, params: SimParams) -> LatticeState:
        wide = ddf.widen_stack(state.fields, params.settings.dtype,
                               storage_shift)
        out = step(dataclasses.replace(state, fields=wide), params)
        return dataclasses.replace(out, fields=ddf.narrow_stack(
            out.fields, storage_dtype, storage_shift))

    return one


def make_sampled_iterate(model: Model, points: np.ndarray,
                         quantities: Sequence[str],
                         storage_dtype: Any = None,
                         storage_shift: Optional[np.ndarray] = None
                         ) -> Callable:
    """Like :func:`make_iterate`, but every step also gathers the listed
    quantities at fixed lattice points (the <Sample> probes).

    ``points`` is ``(npoints, ndim)`` in array index order (z, y, x / y,
    x).  Returns ``iterate(state, params, niter, avg_start=0) -> (state,
    samples)`` with ``samples`` ``(niter, npoints, ncols)``: a vector
    quantity gives its components as consecutive columns.  Every step
    reduces the globals, so the state's globals are the last step's.  On a
    narrowed carry (``storage_dtype``, ``storage_shift`` as in
    :func:`make_iterate`) each step narrows once and the probes read the
    stored state widened with its shift, as ``Lattice.get_quantity``
    does."""
    step = narrowed_step(make_action_step(model), storage_dtype,
                         storage_shift)
    idx = tuple(torch.as_tensor(np.asarray(points)[:, k], dtype=torch.long)
                for k in range(np.asarray(points).shape[1]))
    qfns = [model.quantity_fns[q] for q in quantities]

    def sample(state: LatticeState, params: SimParams, avg_start: int
               ) -> torch.Tensor:
        f = state.fields
        if storage_dtype is not None:
            f = ddf.widen_stack(f, params.settings.dtype, storage_shift)
        ctx = NodeCtx(model, f, f, state.flags, params,
                      iteration=state.iteration, avg_start=avg_start)
        at = tuple(i.to(state.fields.device) for i in idx)
        cols = []
        for fn in qfns:
            plane = fn(ctx)
            if plane.dim() == state.flags.dim():
                cols.append(plane[at][:, None])
            else:   # vector: (ncomp, *shape) -> (npoints, ncomp)
                cols.append(plane[(slice(None),) + at].T)
        return torch.cat(cols, dim=-1)

    def iterate(state: LatticeState, params: SimParams, niter: int,
                avg_start: int = 0) -> tuple:
        rows = []
        with torch.no_grad():
            for _ in range(niter):
                state = step(state, params)
                rows.append(sample(state, params, avg_start))
        return state, torch.stack(rows) if rows else None

    return iterate


def _roadmap(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP queue 1, {item})")


# --------------------------------------------------------------------------- #
# Host-side Lattice wrapper
# --------------------------------------------------------------------------- #


class Lattice:
    """Host-side wrapper: allocate, Init, Iterate, get/set densities,
    quantities, settings, save/load.  ``device=None`` means the card.

    The storage ladder: ``storage_dtype`` (opt-in; default the compute
    dtype) narrows the field stack at rest only -- every step computes in
    ``dtype``, and settings, zone tables and globals stay at ``dtype``.
    A narrowed lattice with a recognized velocity set stores ``f_i - w_i``
    (``storage_repr="shifted"``) unless ``storage_repr="raw"`` is asked
    for; a full-width lattice is always raw, so the f32 path is unchanged.
    The density accessors, ``get_quantity`` and ``fields_raw`` read and
    write raw distributions in either representation."""

    def __init__(self, model: Model, shape: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 settings: Optional[dict[str, float]] = None,
                 device: Any = None,
                 mesh: Any = None,
                 storage_dtype: Any = None,
                 storage_repr: Optional[str] = None):
        if len(shape) != model.ndim:
            raise ValueError(f"model {model.name} is {model.ndim}D; "
                             f"got shape {shape}")
        if mesh is not None:
            raise _roadmap("a sharded (mesh) lattice", "item 12")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        sdt = dtype if storage_dtype is None \
            else ddf.torch_dtype(storage_dtype)
        narrowed = sdt != dtype
        if narrowed and (not sdt.is_floating_point or sdt.itemsize
                         > dtype.itemsize):
            raise ValueError(
                f"storage_dtype {ddf.dtype_name(sdt)} must be a float dtype "
                f"no wider than the compute dtype {ddf.dtype_name(dtype)}")
        self.model = model
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.storage_dtype = sdt
        self.storage_repr = ddf.resolve_repr(model, narrowed, storage_repr)
        self._shift_vec = ddf.shift_of(model, self.storage_repr)
        self._shift_block = ddf.stack_shift(model, self.storage_repr)
        self.device = resolve_device(device)
        vec = model.settings_vector(settings)
        self.params = self._params_from(
            vec, np.broadcast_to(vec[:, None], (len(vec), model.zone_max)))
        self.state = LatticeState(
            fields=torch.zeros((model.n_storage,) + self.shape, dtype=sdt,
                               device=self.device),
            flags=torch.zeros(self.shape, dtype=FLAG_DTYPE,
                              device=self.device),
            globals_=torch.zeros((model.n_globals,), dtype=dtype,
                                 device=self.device),
            iteration=0,
        )
        self._host_flags = np.zeros(self.shape, dtype=np.uint16)
        self.avg_start = 0    # iteration of the last <Average> reset
        self._init = narrowed_step(make_action_step(model, "Init"),
                                   *self._carry())
        self._iterate_cached: Optional[Callable] = None
        self._fast: Optional[Callable] = None
        self._fast_name: Optional[str] = None
        self._fast_tried = False
        self.eager_steps = 0  # steps ``iterate`` ran on the eager engine
        self._series: dict = {}   # (setting index, zone) -> host series
        self.sampler = None       # a <Sample> point sampler, if attached
        self._iterate_sampled: Optional[Callable] = None

    @property
    def narrowed(self) -> bool:
        """Whether the fields are stored narrower than they compute."""
        return self.storage_dtype != self.dtype

    def _carry(self) -> tuple:
        """``(storage_dtype, storage_shift)`` as :func:`make_iterate`
        takes them: ``(None, None)`` for a full-width lattice."""
        if not self.narrowed:
            return None, None
        return self.storage_dtype, self._shift_block

    def _params_from(self, vec: np.ndarray, table: np.ndarray) -> SimParams:
        return SimParams(
            settings=torch.as_tensor(np.array(vec, dtype=np.float64),
                                     dtype=self.dtype, device=self.device),
            zone_table=torch.as_tensor(np.array(table, dtype=np.float64),
                                       dtype=self.dtype, device=self.device))

    # -- setup -------------------------------------------------------------- #

    def set_flags(self, flags: np.ndarray) -> None:
        """Overwrite the node-type field (uint16 bit packing)."""
        flags = np.asarray(flags)
        if flags.shape != self.shape:
            raise ValueError(f"flags shape {flags.shape} != {self.shape}")
        self._host_flags = flags.astype(np.uint16)
        self.state = dataclasses.replace(
            self.state, flags=torch.as_tensor(
                self._host_flags.astype(np.int32), device=self.device))
        self._fast_tried = False   # present node types may have changed
        self._iterate_cached = None

    def set_state(self, state: LatticeState, params: SimParams) -> None:
        """Adopt a whole state and its params (e.g. from
        :func:`tclb_tpu_torch.convert.state_from_numpy`); the fields are
        at rest in this lattice's storage dtype and representation."""
        self.set_flags(state.flags.cpu().numpy())
        self.state = dataclasses.replace(
            state, flags=self.state.flags,
            fields=state.fields.to(self.device, self.storage_dtype),
            globals_=state.globals_.to(self.device, self.dtype))
        ts = params.time_series
        self.params = SimParams(
            settings=params.settings.to(self.device, self.dtype),
            zone_table=params.zone_table.to(self.device, self.dtype),
            time_series=None if ts is None else ts.to(self.device,
                                                      self.dtype),
            series_map=tuple(params.series_map))
        self._series = {} if ts is None else {
            (si, z): ts[r].double().cpu().numpy()
            for si, z, r in params.series_map}

    def flags_numpy(self) -> np.ndarray:
        """The flag field as the uint16 array the JAX package keeps."""
        return self._host_flags.copy()

    def set_setting(self, name: str, value: float, zone: Optional[int] = None
                    ) -> None:
        """Set a setting (with its derived settings), or one zone of a
        zonal setting."""
        m = self.model
        vec = self.params.settings.cpu().numpy().astype(np.float64)
        table = self.params.zone_table.cpu().numpy().astype(np.float64)
        if zone is None:
            m._set_with_derived(vec, name, float(value))
            # un-touched zones keep following the scalar value
            table[m.setting_index[name], :] = vec[m.setting_index[name]]
        else:
            table[m.setting_index[name], zone] = float(value)
        new = self._params_from(vec, table)     # the series stays
        self.params = dataclasses.replace(self.params, settings=new.settings,
                                          zone_table=new.zone_table)

    def set_setting_series(self, name: str, values, zone: int = 0) -> None:
        """Attach a per-iteration time series to one zone of a zonal
        setting (<Control>).  All series share one horizon; the iteration
        wraps modulo its length.  The engine is chosen again: only the
        engines that read a series per step take it."""
        m = self.model
        i = m.setting_index[name]
        if not m.settings[i].zonal:
            raise ValueError(f"setting {name!r} is not zonal; Control time "
                             "series apply to zonal settings")
        values = np.asarray(values, dtype=np.float64).ravel()
        for old in self._series.values():
            if len(old) != len(values):
                raise ValueError(
                    f"all Control series must share one horizon: got "
                    f"{len(values)}, existing {len(old)}")
        self._series[(i, int(zone))] = values
        self._fast_tried = False   # the engine re-selects series-aware
        keys = sorted(self._series)
        self.params = dataclasses.replace(
            self.params,
            time_series=torch.as_tensor(
                np.stack([self._series[k] for k in keys]), dtype=self.dtype,
                device=self.device),
            series_map=tuple((si, z, r) for r, (si, z) in enumerate(keys)))

    def attach_sampler(self, sampler) -> None:
        """Register a point sampler (<Sample>): every later step also
        gathers its quantities at its points.  Sampled steps run on the
        eager engine by selection (engine ``sampled_eager``): no kernel
        gathers per step.  ``detach_sampler`` returns to the kernels."""
        self.sampler = sampler
        self._iterate_sampled = make_sampled_iterate(
            self.model, sampler.points, sampler.quantities, *self._carry())
        log.info(f"engine: sampled_eager ({len(sampler.points)} points, "
                 f"{','.join(sampler.quantities)} every step; kernel "
                 "engines resume when the sampler is detached)")

    def detach_sampler(self) -> None:
        self.sampler = None
        self._iterate_sampled = None

    def init(self) -> None:
        """Run the model's Init action."""
        with torch.no_grad():
            self.state = self._init(self.state, self.params)

    # -- running ------------------------------------------------------------ #

    @property
    def _iterate(self) -> Callable:
        """The eager engine, specialized on the painted node types."""
        if self._iterate_cached is None:
            from tclb_tpu_torch.ops.lbm import present_types
            self._iterate_cached = make_iterate(
                self.model, present=present_types(self.model,
                                                  self._host_flags),
                storage_dtype=self._carry()[0],
                storage_shift=self._carry()[1])
        return self._iterate_cached

    def _build_fast(self):
        """Pick the kernel engine for this configuration, or none.

        The kernels run on the card only, and ``TCLB_FASTPATH=0`` turns
        them off.  Each kernel module is asked in turn and the first whose
        ``supports()`` accepts is taken; anything every one rejects —
        another model, f64, a storage dtype the kernel has no rung for —
        runs eager by selection, not after a failure.  Each engine is
        handed the storage dtype and representation and names them in its
        tag (``cuda_generic_band[d2q9,fuse=1,bfloat16/shifted]``)."""
        from tclb_tpu_torch.ops import (d2q9_kernels, d3q27_kernels,
                                        generic3d_kernels, generic_kernels)
        if os.environ.get("TCLB_FASTPATH") == "0" \
                or self.device.type != "cuda":
            return None, None
        # the tuned kernels first, the generic engines last; under a
        # <Control> series only the engines that read it per step accept
        series = self.params.time_series is not None
        for mod in (d2q9_kernels, d3q27_kernels, generic3d_kernels,
                    generic_kernels):
            fast, tag = mod.select_engine(
                self.model, self.shape, self.dtype, series=series,
                storage_dtype=self.storage_dtype,
                storage_repr=self.storage_repr)
            if fast is not None:
                return fast, tag
        return None, None

    def _fast_path(self) -> Optional[Callable]:
        if not self._fast_tried:
            self._fast_tried = True
            self._fast, self._fast_name = self._build_fast()
            if self._fast is not None:
                suffix = ("(in-kernel globals)"
                          if getattr(self._fast, "full_globals", False)
                          else "(+1 eager step per call for globals)")
                log.info(f"engine: {self._fast_name} {suffix}")
            elif self.narrowed:
                log.info(f"engine: {self.eager_tag} (no kernel engine "
                         "takes this configuration)")
            else:
                log.debug(f"engine: eager ({self.model.name} {self.shape} "
                          f"{self.dtype} on {self.device})")
        return self._fast

    @property
    def engine_name(self) -> str:
        """Tag of the engine ``iterate`` runs on (``eager`` when no
        kernel engine was selected, ``sampled_eager`` while a sampler is
        attached)."""
        if self.sampler is not None:
            return "sampled_eager"
        self._fast_path()
        return self._fast_name or self.eager_tag

    @property
    def eager_tag(self) -> str:
        """The eager engine's tag: ``eager``, and on a narrowed lattice
        ``eager[bfloat16/shifted]``."""
        if not self.narrowed:
            return "eager"
        return (f"eager[{ddf.dtype_name(self.storage_dtype)}/"
                f"{self.storage_repr}]")

    def iterate(self, niter: int) -> None:
        """Advance ``niter`` steps.  An engine that returns the last step's
        globals itself (``full_globals``) takes all of them; the others
        take ``niter - 1`` and one eager step computes the globals; without
        an engine every step is eager.  With a sampler attached every step
        is eager and sampled."""
        if self.sampler is not None:
            it0 = int(self.state.iteration)
            self.state, samples = self._iterate_sampled(
                self.state, self.params, niter, self.avg_start)
            self.eager_steps += niter
            if samples is not None:
                self.sampler.append(it0, samples.cpu().numpy())
            return
        fast = self._fast_path()
        if fast is not None and self.params.time_series is not None \
                and not getattr(fast, "supports_series", False):
            raise RuntimeError(f"engine {self._fast_name} cannot read a "
                               "Control time series")
        full = bool(getattr(fast, "full_globals", False))
        nfast = niter if full else niter - 1
        if fast is not None and nfast >= 1:
            self.state = fast(self.state, self.params, nfast)
            eager = niter - nfast
        else:
            eager = niter
        if eager > 0:
            self.state = self._iterate(self.state, self.params, eager)
            self.eager_steps += eager

    def synchronize(self) -> None:
        """Wait for the device (no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- inspection --------------------------------------------------------- #

    def get_quantity(self, name: str) -> torch.Tensor:
        """Evaluate a registered Quantity over the lattice."""
        fn = self.model.quantity_fns[name]
        # quantities evaluate in the compute dtype over raw distributions
        f = ddf.widen_stack(self.state.fields, self.dtype, self._shift_block)
        ctx = NodeCtx(self.model, f, f, self.state.flags, self.params,
                      iteration=self.state.iteration,
                      avg_start=self.avg_start)
        with torch.no_grad():
            return fn(ctx)

    def reset_average(self) -> None:
        """Zero the ``average=True`` storage planes and restart the sample
        counter (the JAX package's ``Lattice.reset_average``)."""
        idx = [i for i, d in enumerate(self.model.densities) if d.average]
        if idx:
            fields = self.state.fields.clone()
            fields[idx] = 0.0
            self.state = dataclasses.replace(self.state, fields=fields)
        self.avg_start = int(self.state.iteration)

    def _plane_w(self, idx: int) -> Optional[float]:
        """Plane ``idx``'s shift under the shifted representation, else
        ``None``."""
        if self._shift_vec is None:
            return None
        return float(self._shift_vec[idx]) or None

    def get_density(self, name: str) -> torch.Tensor:
        """One storage plane in raw distribution values (a narrowed plane
        widened with its shift; a full-width plane as it is stored)."""
        idx = self.model.storage_index[name]
        if not self.narrowed:
            return self.state.fields[idx]
        return ddf.widen_plane(self.state.fields[idx], self.dtype,
                               self._plane_w(idx))

    def set_density_planes(self, values: dict) -> None:
        """Write several storage planes from raw distribution values; a
        narrowed plane has its shift removed in the compute dtype before
        the cast."""
        fields = self.state.fields.clone()
        for name, value in values.items():
            idx = self.model.storage_index[name]
            plane = torch.as_tensor(np.asarray(value), dtype=self.dtype,
                                    device=self.device)
            fields[idx] = ddf.narrow_plane(plane, self.storage_dtype,
                                           self._plane_w(idx))
        self.state = dataclasses.replace(self.state, fields=fields)

    def set_density(self, name: str, value) -> None:
        self.set_density_planes({name: value})

    def fields_raw(self) -> np.ndarray:
        """The field stack as a host float64 array in the raw
        representation (exact for either storage layout: the arithmetic
        runs in f64)."""
        return ddf.convert_fields_host(
            self.state.fields.double().cpu().numpy(), self.storage_repr,
            "raw", ddf.storage_shift(self.model), np.float64)

    def get_globals(self) -> dict[str, float]:
        vals = self.state.globals_.cpu().numpy()
        return {g.name: float(vals[i])
                for i, g in enumerate(self.model.globals_)}

    def get_objective(self) -> float:
        """Weighted objective from the <Global>InObj settings."""
        m = self.model
        vals = self.state.globals_.cpu().numpy()
        svec = self.params.settings.cpu().numpy()
        return sum(float(svec[m.setting_index[g.name + "InObj"]])
                   * float(vals[i]) for i, g in enumerate(m.globals_))

    # -- checkpoint --------------------------------------------------------- #

    def save(self, path: str) -> None:
        """Full-state dump in the JAX package's legacy ``.npz`` format,
        written atomically, stamped with the storage dtype and
        representation (bf16 fields as their uint16 bits, as the JAX
        package's ``npy_safe`` writes them)."""
        from tclb_tpu_torch.checkpoint.writer import atomic_path, with_suffix
        extra = {}
        if self.params.time_series is not None:
            extra["time_series"] = self.params.time_series.cpu().numpy()
            extra["series_map"] = np.asarray(self.params.series_map,
                                             dtype=np.int64)
        target = with_suffix(path, ".npz")
        with atomic_path(target) as tmp:
            with open(tmp, "wb") as f:
                np.savez(f,
                         fields=self._fields_at_rest(),
                         flags=self._host_flags,
                         iteration=int(self.state.iteration),
                         settings=self.params.settings.cpu().numpy(),
                         zone_table=self.params.zone_table.cpu().numpy(),
                         storage_dtype=ddf.dtype_name(self.storage_dtype),
                         storage_repr=self.storage_repr, **extra)

    def _fields_at_rest(self) -> np.ndarray:
        """The field stack at rest on the host: bf16 as its uint16 bits."""
        if self.storage_dtype == torch.bfloat16:
            return ddf.bf16_bits(self.state.fields)
        return self.state.fields.cpu().numpy()

    def load(self, path: str) -> None:
        """Restore a ``.npz`` written by :meth:`save` or by the JAX
        package's ``Lattice.save`` / ``<SaveBinary>``.  A file in this
        lattice's storage representation is cast to its storage dtype
        (bit-exact when the dtype is the same too); one in the other
        representation is converted on the host in f64.  Files without a
        stamp are raw."""
        from tclb_tpu_torch.checkpoint.writer import resolve_npz
        with np.load(resolve_npz(path)) as d:
            src_repr = str(d["storage_repr"]) if "storage_repr" in d \
                else "raw"
            src_dtype = str(d["storage_dtype"]) if "storage_dtype" in d \
                else str(d["fields"].dtype)
            if src_repr not in ddf.STORAGE_REPRS:
                raise ValueError(f"unknown storage_repr {src_repr!r} in "
                                 f"{path}; known: {ddf.STORAGE_REPRS}")
            src = ddf.tensor_from_numpy(d["fields"], src_dtype)
            flags = np.asarray(d["flags"], dtype=np.uint16)
            iteration = int(d["iteration"])
            settings = np.asarray(d["settings"])
            table = np.asarray(d["zone_table"])
            ts = np.asarray(d["time_series"]) if "time_series" in d \
                else None
            smap = tuple(tuple(int(v) for v in row)
                         for row in d["series_map"]) if ts is not None \
                else ()
        if src_repr == self.storage_repr:
            fields = src.to(self.storage_dtype)
        else:
            fields = ddf.tensor_from_numpy(ddf.convert_fields_host(
                src.double().numpy(), src_repr, self.storage_repr,
                ddf.storage_shift(self.model), self.storage_dtype),
                self.storage_dtype)
        self.set_flags(flags)
        self.state = dataclasses.replace(
            self.state, fields=fields.to(self.device), iteration=iteration)
        self._series = {} if ts is None else {
            (si, z): ts[r].astype(np.float64) for si, z, r in smap}
        self.params = dataclasses.replace(
            self._params_from(settings, table),
            time_series=None if ts is None else torch.as_tensor(
                ts, dtype=self.dtype, device=self.device),
            series_map=smap)
