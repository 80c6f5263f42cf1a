"""Point sampler: per-iteration probes flushed to CSV.

The port's copy of the JAX package's ``utils/sampler.py``: points come
from the <Sample><Point .../></Sample> element, ``Lattice.iterate`` gathers
the quantities at every step (``core/lattice.py:make_sampled_iterate``)
and hands them to :meth:`Sampler.append`, and the <Sample> callback
flushes them to a CSV whose layout is the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np


class Sampler:
    def __init__(self, model, quantities: list[str],
                 points: np.ndarray, path: str):
        """``points`` is (npoints, ndim) in array index order."""
        self.model = model
        self.quantities = list(quantities)
        self.points = np.asarray(points, dtype=np.int32)
        self.path = path
        self._rows: list[tuple[int, np.ndarray]] = []
        self._wrote_header = False
        # column names: per point, per quantity (a vector takes 3 columns)
        self.columns: list[str] = []
        for i in range(len(self.points)):
            for q in self.quantities:
                spec = next(x for x in model.quantities if x.name == q)
                if spec.vector:
                    self.columns += [f"{q}_{i}_{c}" for c in "xyz"]
                else:
                    self.columns.append(f"{q}_{i}")

    def append(self, it0: int, samples: np.ndarray) -> None:
        """``samples``: (nsteps, npoints, ncols-per-point), the steps
        after iteration ``it0``."""
        flat = samples.reshape(samples.shape[0], -1)
        for k in range(flat.shape[0]):
            self._rows.append((it0 + k + 1, flat[k]))

    def flush(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        mode = "a" if self._wrote_header else "w"
        with open(self.path, mode) as f:
            if not self._wrote_header:
                f.write(",".join(["Iteration"] + self.columns) + "\n")
                self._wrote_header = True
            for it, row in self._rows:
                f.write(str(it) + "," + ",".join(f"{v:g}" for v in row)
                        + "\n")
        self._rows.clear()
