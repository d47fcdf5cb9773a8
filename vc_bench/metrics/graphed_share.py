"""graphed_share.<cell>: the share of the traced training steps that ran as
a replay of the program's CUDA graph of the step, in %: the program's
``train.replay`` spans (one a replayed step) wholly inside the traced
window, over the traced steps. A program without the span, or a window
without one, reads None."""


def read(record):
    try:
        from adaptive_voice_conversion_tpu_torch.utils import profiling
    except ImportError:
        return None
    t0, t1 = record["trace"].window_ns
    n = sum(1 for name, s, e in profiling.SPAN_LOG.spans if name == "train.replay" and s >= t0 and e <= t1)
    steps = sum(u.get("steps", 1) for u in record["units"])
    return 100.0 * n / steps if n and steps else None
