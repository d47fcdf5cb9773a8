"""Debugging, profiling and cost-model hooks."""

from .debug import enable_nan_debugging
from .profiling import profile_trace, span, span_seconds

__all__ = ["enable_nan_debugging", "profile_trace", "span", "span_seconds"]
