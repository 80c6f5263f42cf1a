"""State carried across from the JAX package.

A lattice-Boltzmann run has no weights: what it carries is its state.  The
two packages keep the same planar layout (fields ``(n_storage, *shape)``,
uint16 flags with the registry's bit packing, globals and settings in
registry order), so crossing over is a change of container, not of layout:

* :func:`state_from_numpy` turns the JAX package's ``LatticeState`` and
  ``SimParams`` (its <Control> time series included), handed over as numpy
  arrays, into the port's;
* :func:`state_to_numpy` is its inverse;
* ``Lattice.load`` reads a ``.npz`` that the JAX package's ``Lattice.save``
  or ``<SaveBinary>`` wrote (raw f32/f64 storage, with its time series).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tclb_tpu_torch.core.lattice import (FLAG_DTYPE, LatticeState, SimParams,
                                         resolve_device)
from tclb_tpu_torch.core.registry import Model


def state_from_numpy(model: Model, fields, flags, globals_, iteration,
                     settings, zone_table, device: Any = None,
                     time_series=None, series_map=()
                     ) -> tuple[LatticeState, SimParams]:
    """The port's ``(LatticeState, SimParams)`` from numpy arrays of the
    JAX package's state and params.  The field dtype (f32 or f64) is kept;
    settings, the zone table, the <Control> time series (if any) and the
    globals take the fields' dtype, as they do in the JAX ``Lattice``.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    fields = np.asarray(fields)
    if fields.dtype not in (np.float32, np.float64):
        raise ValueError(f"fields must be float32 or float64 (raw storage), "
                         f"got {fields.dtype}")
    shape = fields.shape[1:]
    if fields.shape[0] != model.n_storage or len(shape) != model.ndim:
        raise ValueError(f"fields {fields.shape} do not fit model "
                         f"{model.name} ({model.n_storage} planes, "
                         f"{model.ndim}D)")
    flags = np.asarray(flags)
    if flags.shape != shape:
        raise ValueError(f"flags {flags.shape} != lattice shape {shape}")
    dtype = torch.float64 if fields.dtype == np.float64 else torch.float32

    def tensor(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)   # copies

    state = LatticeState(
        fields=tensor(fields),
        flags=tensor(flags.astype(np.uint16).astype(np.int32), FLAG_DTYPE),
        globals_=tensor(np.asarray(globals_, dtype=np.float64)),
        iteration=int(np.asarray(iteration)))
    params = SimParams(
        settings=tensor(np.asarray(settings, dtype=np.float64)),
        zone_table=tensor(np.asarray(zone_table, dtype=np.float64)),
        time_series=None if time_series is None else tensor(
            np.asarray(time_series, dtype=np.float64)),
        series_map=tuple(tuple(int(v) for v in row) for row in series_map))
    return state, params


def state_to_numpy(state: LatticeState, params: SimParams) -> dict:
    """The inverse of :func:`state_from_numpy`: numpy arrays in the JAX
    package's layout and dtypes (uint16 flags, int32 iteration), with
    ``time_series`` and ``series_map`` where a series is set."""
    out = {
        "fields": state.fields.cpu().numpy(),
        "flags": state.flags.cpu().numpy().astype(np.uint16),
        "globals_": state.globals_.cpu().numpy(),
        "iteration": np.int32(state.iteration),
        "settings": params.settings.cpu().numpy(),
        "zone_table": params.zone_table.cpu().numpy(),
    }
    if params.time_series is not None:
        out["time_series"] = params.time_series.cpu().numpy()
        out["series_map"] = tuple(params.series_map)
    return out
