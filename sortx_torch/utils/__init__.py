"""Scalar helpers, typed errors, the debug-gated assert and the logger."""

from .errors import (CapacityError, SortxError, debug_enabled, set_debug,
                     sortx_assert)
from .log import Channel, LogWriter, log, log_debug, log_error
from .math import cdiv, clamp, is_pow2, next_multiple_of, next_pow2

__all__ = ["CapacityError", "SortxError", "sortx_assert", "set_debug",
           "debug_enabled", "Channel", "LogWriter", "cdiv", "clamp",
           "is_pow2", "next_multiple_of", "next_pow2", "log", "log_debug",
           "log_error"]
