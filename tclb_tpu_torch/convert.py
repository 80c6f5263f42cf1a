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
  or ``<SaveBinary>`` wrote (any storage dtype and representation, with its
  time series).

A bf16 stack (the storage ladder) crosses as its uint16 bits: numpy has no
bfloat16 of its own, and a JAX bf16 array's numpy dtype (named
``bfloat16``) views as uint16 without any further package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tclb_tpu_torch.core import shift as ddf
from tclb_tpu_torch.core.lattice import (FLAG_DTYPE, LatticeState, SimParams,
                                         resolve_device)
from tclb_tpu_torch.core.registry import Model


def state_from_numpy(model: Model, fields, flags, globals_, iteration,
                     settings, zone_table, device: Any = None,
                     time_series=None, series_map=(), storage_dtype=None,
                     dtype=None) -> tuple[LatticeState, SimParams]:
    """The port's ``(LatticeState, SimParams)`` from numpy arrays of the
    JAX package's state and params.  The field dtype is kept: f32, f64, or
    bf16 (a JAX bf16 array, or its uint16 bits with
    ``storage_dtype="bfloat16"``), at rest as they are.  Settings, the zone
    table, the <Control> time series (if any) and the globals take the
    compute dtype ``dtype``: by default the fields' dtype, float32 for a
    bf16 stack, as in the JAX ``Lattice``.  ``device=None`` means the
    card."""
    dev = resolve_device(device)
    fields = np.asarray(fields)
    sdt = ddf.dtype_name(storage_dtype) if storage_dtype is not None \
        else fields.dtype.name
    if sdt not in ("float32", "float64", "bfloat16"):
        raise ValueError(f"fields must be float32, float64 or bfloat16, "
                         f"got {fields.dtype}")
    shape = fields.shape[1:]
    if fields.shape[0] != model.n_storage or len(shape) != model.ndim:
        raise ValueError(f"fields {fields.shape} do not fit model "
                         f"{model.name} ({model.n_storage} planes, "
                         f"{model.ndim}D)")
    flags = np.asarray(flags)
    if flags.shape != shape:
        raise ValueError(f"flags {flags.shape} != lattice shape {shape}")
    if dtype is None:
        dtype = torch.float64 if sdt == "float64" else torch.float32

    def tensor(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)   # copies

    state = LatticeState(
        fields=ddf.tensor_from_numpy(fields, sdt, dev),
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
    ``time_series`` and ``series_map`` where a series is set.  A bf16 stack
    comes as its uint16 bits, with ``storage_dtype: "bfloat16"``."""
    bf16 = state.fields.dtype == torch.bfloat16
    out = {
        "fields": (ddf.bf16_bits(state.fields) if bf16
                   else state.fields.cpu().numpy()),
        "flags": state.flags.cpu().numpy().astype(np.uint16),
        "globals_": state.globals_.cpu().numpy(),
        "iteration": np.int32(state.iteration),
        "settings": params.settings.cpu().numpy(),
        "zone_table": params.zone_table.cpu().numpy(),
    }
    if params.time_series is not None:
        out["time_series"] = params.time_series.cpu().numpy()
        out["series_map"] = tuple(params.series_map)
    if bf16:
        out["storage_dtype"] = "bfloat16"
    return out
