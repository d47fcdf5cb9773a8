"""Debugging and profiling hooks."""

from .debug import enable_nan_debugging
from .profiling import profile_trace

__all__ = ["enable_nan_debugging", "profile_trace"]
