"""What the readers of ``program_span`` metrics share: the program's own
spans (``adaptive_voice_conversion_tpu_torch/utils/profiling.py``) inside
the traced window, in milliseconds per traced training step (a unit's
``steps``) or per traced unit (a request, a grid call).

The program records a span only while a torch profiler records, on the
``time.time_ns()`` clock that also bounds ``record["trace"].window_ns``; a
span counts when it lies wholly inside the window. A program without the
recorder, or a window without a span of the name, reads None.
"""


def ms_per_unit(record, name: str):
    try:
        from adaptive_voice_conversion_tpu_torch.utils.profiling import span_seconds
    except ImportError:
        return None
    n = sum(u.get("steps", 1) for u in record["units"])
    s = span_seconds(name, *record["trace"].window_ns)
    return 1e3 * s / n if s > 0 and n else None
