"""Typed errors and the debug-gated assert (counterpart of
``sortx/utils/errors.py``).

``sortx_assert`` raises :class:`SortxError` in debug mode
(``SORTX_DEBUG=1`` in the environment at import, or ``set_debug(True)``)
and returns at once otherwise, so the checks cost nothing when off.
"""

from __future__ import annotations

import os
from typing import Callable

from .log import log_error

__all__ = ["CapacityError", "SortxError", "sortx_assert", "set_debug",
           "debug_enabled"]

_DEBUG = bool(int(os.environ.get("SORTX_DEBUG", "0")))


class SortxError(AssertionError):
    """Raised by ``sortx_assert`` in debug mode."""


class CapacityError(MemoryError):
    """A requested single-device operation cannot fit device memory."""


def set_debug(enable: bool) -> None:
    global _DEBUG
    _DEBUG = enable


def debug_enabled() -> bool:
    return _DEBUG


def sortx_assert(cond, msg: str = "", lazy: Callable[[], str] | None = None):
    """Debug-gated assert: ``cond`` (a value or a callable) must hold.
    ``lazy`` builds the message only on failure."""
    if not _DEBUG:
        return
    if not (cond() if callable(cond) else cond):
        text = msg or (lazy() if lazy else "assertion failed")
        log_error(f"SORTX_ASSERT: {text}")
        raise SortxError(text)
