"""Path helpers and atomic writes — the few pieces of the JAX package's
``checkpoint/writer.py`` that the legacy ``.npz`` save/load and the solver's
file output need.  The manifest-verified checkpoint directory format waits
for ROADMAP queue 1 item 13."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator


def with_suffix(path: str, ext: str) -> str:
    """``path`` guaranteed to end with ``ext`` (appended when absent)."""
    return path if path.endswith(ext) else path + ext


def resolve_npz(path: str) -> str:
    """The on-disk file a legacy ``.npz`` reference points at: the path
    itself when it exists (or already carries the suffix), else the
    suffixed variant ``np.savez`` would have produced."""
    if path.endswith(".npz") or os.path.exists(path):
        return path
    return path + ".npz"


@contextlib.contextmanager
def atomic_path(path: str) -> Iterator[str]:
    """Yield a temp path; on clean exit fsync it and rename it onto
    ``path``, so readers see either the old file or the complete new one.
    On error the temp file is removed and nothing replaces ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
