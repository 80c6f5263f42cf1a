"""DDF shifting: the at-rest representation of the storage ladder.

The port's copy of the JAX package's ``core/shift.py``.  A narrowed
(bf16) field stack spends its 8-bit mantissa on whatever it holds.  Raw
distributions carry the O(1) rest-equilibrium background ``w_i``, so the
rounding noise of each round trip (~``2**-8 * w_i``) rivals a low-Mach
velocity signal.  DDF shifting (Lehmann et al. 2022) stores the deviation
``f_i - w_i`` instead, and the mantissa goes to the signal.  The shift is a
per-plane constant: it commutes with pull streaming (a per-plane roll) and
costs one add at each widen seam and one subtract at each narrow seam.

* :data:`STORAGE_REPRS` -- ``"raw"`` stores ``f_i``, ``"shifted"`` stores
  ``f_i - w_i``; stamped into checkpoints;
* :func:`storage_shift` -- the per-plane shift vector (float64): the
  lattice weight for each streamed plane of a recognized D2Q9/D3Q19/D3Q27
  group, 0 for fields, averages, SynthT planes and unrecognized groups;
* the seam helpers :func:`widen_plane`/:func:`narrow_plane` (one plane, a
  Python float shift, as the kernels' seams take it) and
  :func:`widen_stack`/:func:`narrow_stack` (the whole stack and the float32
  block of :func:`stack_shift`, as the eager engine's carry takes it).
  With no shift every helper is a pure cast, so the f32 path never sees a
  ``+ 0.0`` (``-0.0 + 0.0`` is ``+0.0``);
* :func:`convert_fields_host` -- conversion between representations in
  numpy float64 (checkpoints, ``Lattice.fields_raw``), so shifted bf16 ->
  raw f32 -> shifted bf16 gives back the same bits.

The kernels' seams are ``csrc/storage.cuh``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional

import numpy as np
import torch

#: at-rest layouts of the field stack: ``raw`` stores ``f_i``, ``shifted``
#: stores ``f_i - w_i`` (w_i = lattice weights)
STORAGE_REPRS = ("raw", "shifted")
#: the stacks at rest the bf16-capable kernels take
STORAGE_DTYPES = (torch.float32, torch.bfloat16)

# |e|^2 -> weight for the standard velocity sets, with the member count per
# ring that identifies the set (a group that merely has 9 members is not a
# D2Q9 set)
_WEIGHT_TABLES = {
    9: ({0: 4.0 / 9.0, 1: 1.0 / 9.0, 2: 1.0 / 36.0},
        {0: 1, 1: 4, 2: 4}),
    19: ({0: 1.0 / 3.0, 1: 1.0 / 18.0, 2: 1.0 / 36.0},
         {0: 1, 1: 6, 2: 12}),
    27: ({0: 8.0 / 27.0, 1: 2.0 / 27.0, 2: 1.0 / 54.0, 3: 1.0 / 216.0},
         {0: 1, 1: 6, 2: 12, 3: 8}),
}

_shift_cache: dict[str, np.ndarray] = {}


def group_weights(ei: np.ndarray) -> Optional[np.ndarray]:
    """Lattice weights of one group's velocity vectors ``ei`` ((q, 3)
    integer offsets), or ``None`` when the group is not a standard
    D2Q9/D3Q19/D3Q27 set (all-zero field rows fail the ring count)."""
    ei = np.asarray(ei)
    table = _WEIGHT_TABLES.get(len(ei))
    if table is None or np.any(np.abs(ei) > 1):
        return None
    weights, counts = table
    e2 = (ei * ei).sum(axis=1)
    have = {int(v): int(n) for v, n in
            zip(*np.unique(e2, return_counts=True))}
    if have != counts:
        return None
    return np.array([weights[int(v)] for v in e2], dtype=np.float64)


def storage_shift(model) -> np.ndarray:
    """Per-plane shift vector ``(n_storage,)`` in float64: the lattice
    weight for every streamed plane of a recognized velocity-set group, 0
    for everything else.  Cached on ``Model.fingerprint``."""
    key = model.fingerprint
    out = _shift_cache.get(key)
    if out is None:
        out = np.zeros((model.n_storage,), dtype=np.float64)
        n_dens = len(model.densities)
        for idx in model.groups.values():
            idx = [i for i in idx if i < n_dens]   # streamed planes only
            if not idx:
                continue
            w = group_weights(model.ei[idx])
            if w is not None:
                out[idx] = w
        _shift_cache[key] = out
    return out


def has_shift(model) -> bool:
    """Whether the model has a recognized velocity set to shift."""
    return bool(np.any(storage_shift(model)))


def default_repr(model, narrowed: bool) -> str:
    """``shifted`` on a narrowed rung with a recognized velocity set,
    ``raw`` otherwise (every full-width lattice included)."""
    return "shifted" if (narrowed and has_shift(model)) else "raw"


def resolve_repr(model, narrowed: bool, storage_repr: Optional[str]) -> str:
    """Validate or resolve the representation asked for one lattice."""
    if storage_repr is None:
        return default_repr(model, narrowed)
    if storage_repr not in STORAGE_REPRS:
        raise ValueError(f"storage_repr {storage_repr!r} must be one of "
                         f"{STORAGE_REPRS}")
    if storage_repr == "shifted":
        if not narrowed:
            raise ValueError(
                "storage_repr='shifted' requires a narrowed storage_dtype "
                "(the full-width path keeps the raw representation so it "
                "stays bit-identical)")
        if not has_shift(model):
            raise ValueError(
                f"model {model.name} has no recognized standard velocity "
                "set to derive DDF shifts from; use storage_repr='raw'")
    return storage_repr


def shift_of(model, storage_repr: str) -> Optional[np.ndarray]:
    """The float64 shift vector for ``"shifted"``, ``None`` for ``"raw"``."""
    return storage_shift(model) if storage_repr == "shifted" else None


def plane_shifts(model, storage_repr: str) -> list:
    """Per-plane shifts as the kernels' seams take them: Python floats,
    with 0.0 entries as ``None`` (a pure cast)."""
    vec = shift_of(model, storage_repr)
    if vec is None:
        return [None] * model.n_storage
    return [float(w) if w else None for w in vec]


def kernel_shift(model, storage_repr: str) -> Optional[tuple]:
    """The per-plane shift a kernel wrapper hands its kernel: the float32
    weights as a tuple for ``"shifted"`` (0 where the plane is a pure
    cast), ``None`` for ``"raw"``."""
    vec = shift_of(model, storage_repr)
    if vec is None:
        return None
    return tuple(float(np.float32(w)) for w in vec)


def c_shift(shift: Optional[tuple]):
    """A :func:`kernel_shift` tuple as the bf16 kernels take it: a C
    float array, or ``None`` (a null pointer: raw)."""
    if shift is None:
        return None
    return (ctypes.c_float * len(shift))(*shift)


def shift_block(shift: Optional[tuple], ndim: int) -> Optional[np.ndarray]:
    """A :func:`kernel_shift` tuple as :func:`widen_stack` takes it: the
    float32 block broadcast over ``ndim`` lattice axes, or ``None``."""
    if shift is None:
        return None
    return _bshape(np.asarray(shift, dtype=np.float32), ndim + 1)


# --------------------------------------------------------------------------- #
# Seam helpers.  With no shift each is a pure cast.
# --------------------------------------------------------------------------- #


def widen_plane(x: torch.Tensor, cdtype, w: Optional[float] = None
                ) -> torch.Tensor:
    """Storage plane -> compute dtype, with the plane's shift restored."""
    y = x.to(cdtype)
    return y + torch.tensor(w, dtype=y.dtype) if w else y


def narrow_plane(x: torch.Tensor, sdtype, w: Optional[float] = None
                 ) -> torch.Tensor:
    """Compute plane -> storage dtype: the shift is removed in the compute
    dtype before the cast, so the narrowing rounds the deviation."""
    if not w:
        return x.to(sdtype)
    return (x - torch.tensor(w, dtype=x.dtype)).to(sdtype)


def _bshape(shift: np.ndarray, ndim: int) -> np.ndarray:
    return np.asarray(shift).reshape((len(shift),) + (1,) * (ndim - 1))


def widen_stack(fields: torch.Tensor, cdtype,
                shift_b: Optional[np.ndarray] = None) -> torch.Tensor:
    """Whole stack -> compute dtype.  ``shift_b`` is the float32 block of
    :func:`stack_shift` (``None``: raw, a pure cast); it is cast to the
    compute dtype, so at f64 the stack gains ``f64(f32(w_i))``."""
    y = fields.to(cdtype)
    if shift_b is None:
        return y
    return y + torch.as_tensor(shift_b, device=y.device).to(y.dtype)


def narrow_stack(fields: torch.Tensor, sdtype,
                 shift_b: Optional[np.ndarray] = None) -> torch.Tensor:
    """Whole compute-dtype stack -> storage dtype."""
    if shift_b is None:
        return fields.to(sdtype)
    return (fields - torch.as_tensor(shift_b, device=fields.device)
            .to(fields.dtype)).to(sdtype)


def narrowed_bounds(wide: torch.Tensor, sdtype, shift_b=None,
                    rtol: float = 0.0, atol: float = 0.0) -> tuple:
    """``(lo, hi)`` at rest in ``sdtype``: the least and the greatest value
    that narrowing (:func:`narrow_stack` with ``shift_b``) can store for
    a compute-dtype stack within ``rtol``/``atol`` of ``wide`` (raw
    values).  Rounding is monotone, so a kernel whose compute values lie
    within that tolerance of ``wide`` stores values in ``[lo, hi]``: the
    compute tolerance carried through one narrowing.  The interval also
    covers the rounding of the shift's subtraction in f32."""
    x = wide.double()
    sb = torch.zeros((), dtype=torch.float64, device=x.device) \
        if shift_b is None else torch.as_tensor(
            shift_b, device=x.device).double()
    tol = atol + rtol * x.abs() + (x.abs() + sb.abs()) * 2.0 ** -23
    return (x - tol - sb).to(sdtype), (x + tol - sb).to(sdtype)


def stack_shift(model, storage_repr: str) -> Optional[np.ndarray]:
    """The broadcastable ``(n_storage, 1[, 1[, 1]])`` float32 shift block
    for :func:`widen_stack`/:func:`narrow_stack`; ``None`` for raw."""
    vec = shift_of(model, storage_repr)
    if vec is None:
        return None
    return _bshape(vec, model.ndim + 1).astype(np.float32)


def convert_fields_host(arr: np.ndarray, from_repr: str, to_repr: str,
                        shift: np.ndarray, dtype: Any) -> np.ndarray:
    """At-rest ``arr`` (any storage dtype and representation, numpy) ->
    the ``(dtype, to_repr)`` at-rest layout.  The arithmetic runs in
    float64, which holds ``f_dev + w`` exactly for every bf16 deviation.
    ``dtype`` is a numpy dtype or ``"bfloat16"`` (then the result is the
    bf16 bits as uint16, see :func:`bf16_bits`); a torch dtype is read by
    its name."""
    for r in (from_repr, to_repr):
        if r not in STORAGE_REPRS:
            raise ValueError(f"unknown storage_repr {r!r}; "
                             f"known: {STORAGE_REPRS}")
    wide = to_float64(arr)
    sb = _bshape(np.asarray(shift, dtype=np.float64), wide.ndim)
    if from_repr == "shifted":
        wide = wide + sb
    if to_repr == "shifted":
        wide = wide - sb
    name = dtype_name(dtype)
    if name == "bfloat16":
        return bf16_bits(torch.from_numpy(wide).to(torch.bfloat16))
    return wide.astype(np.dtype(name))


# --------------------------------------------------------------------------- #
# bfloat16 across numpy.  numpy has no bfloat16 of its own: a bf16 stack
# crosses as its uint16 bits (as the JAX package's ``npy_safe`` saves it),
# reinterpreted through torch's ``view``.  A JAX bf16 array's numpy dtype is
# named ``bfloat16`` and views as uint16 too.
# --------------------------------------------------------------------------- #


def dtype_name(dtype) -> str:
    """``"float32"``, ``"float64"``, ``"bfloat16"``... of a torch or numpy
    dtype (or a name)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a name, numpy dtype or torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, dtype_name(name))


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bits as a uint16 numpy array (host copy)."""
    return t.detach().view(torch.int16).cpu().numpy().view(np.uint16)


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """A bf16 CPU tensor from uint16 bits (or a numpy ``bfloat16``
    array)."""
    raw = np.ascontiguousarray(np.asarray(bits).view(np.uint16))
    return torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)


def to_float64(arr) -> np.ndarray:
    """A numpy float64 copy of ``arr``; a numpy ``bfloat16`` array (from
    the JAX package) is read through its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return bf16_from_bits(arr).double().numpy()
    return arr.astype(np.float64)


def tensor_from_numpy(arr, storage_dtype=None, device=None) -> torch.Tensor:
    """A tensor of ``arr`` at ``storage_dtype``: uint16 bits when
    ``storage_dtype`` is bf16 (or a numpy ``bfloat16`` array) are
    reinterpreted, anything else is cast."""
    arr = np.asarray(arr)
    name = dtype_name(storage_dtype) if storage_dtype is not None \
        else arr.dtype.name
    if name == "bfloat16":
        if arr.dtype.name in ("uint16", "int16", "bfloat16"):
            t = bf16_from_bits(arr)
        else:
            t = torch.from_numpy(arr.astype(np.float64)).to(torch.bfloat16)
        return t.to(device)
    return torch.tensor(arr, dtype=torch_dtype(name), device=device)
