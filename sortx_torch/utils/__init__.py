"""Scalar helpers, typed errors and the logger."""

from .errors import CapacityError
from .log import Channel, LogWriter, log, log_debug, log_error
from .math import cdiv

__all__ = ["CapacityError", "Channel", "LogWriter", "cdiv", "log",
           "log_debug", "log_error"]
