"""Leveled console logging — the reference's ``myprint`` stack
(reference src/Global.cpp.Rt:181, macros debug2..error in
src/Global.h.Rt:100-150, rank filtering via InitPrint,
src/main.cpp.Rt:186).

Single-process until the port's multi-device slice lands, so
the rank prefix/filter degenerates to a level filter: set the threshold
with ``set_level()`` or the ``TCLB_LOG`` environment variable
(debug|info|notice|warning|error, default info).  ``error`` raises like
the reference's ERROR macro aborts.
"""

from __future__ import annotations

import os
import sys

LEVELS = {"debug": 0, "info": 1, "notice": 2, "warning": 3, "error": 4}


def _threshold_from_env() -> int:
    raw = os.environ.get("TCLB_LOG", "info")
    if raw not in LEVELS:
        # warn once at import, then fall back to info — a typo in TCLB_LOG
        # must not silently change verbosity
        print(f"[warning] TCLB_LOG={raw!r} is not a log level "
              f"(accepted: {', '.join(LEVELS)}); falling back to 'info'",
              file=sys.stderr, flush=True)
        return LEVELS["info"]
    return LEVELS[raw]


_threshold = _threshold_from_env()


def set_level(level: str) -> None:
    global _threshold
    if level not in LEVELS:
        raise ValueError(
            f"unknown log level {level!r} (accepted: {', '.join(LEVELS)})")
    _threshold = LEVELS[level]


def get_level() -> str:
    """The current threshold's name."""
    return next(k for k, v in LEVELS.items() if v == _threshold)


def _emit(level: str, msg: str) -> None:
    if LEVELS[level] >= _threshold:
        stream = sys.stderr if LEVELS[level] >= 3 else sys.stdout
        print(f"[{level:7s}] {msg}", file=stream,
              flush=LEVELS[level] >= 2)   # reference per-level fflush


def debug(msg: str) -> None:
    _emit("debug", msg)


def info(msg: str) -> None:
    _emit("info", msg)


def notice(msg: str) -> None:
    _emit("notice", msg)


def warning(msg: str) -> None:
    _emit("warning", msg)


def error(msg: str) -> None:
    """Emit and raise — the reference's ERROR macro aborts the run."""
    _emit("error", msg)
    raise RuntimeError(msg)
