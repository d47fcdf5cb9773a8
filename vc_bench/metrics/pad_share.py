"""pad_share.<cell>: the share of the samples the HiFi-GAN generator computed
in the traced window that are padding, in %: 100 x (computed - valid) /
computed, from the program's counters ``voc.computed_samples`` and
``voc.samples`` (``utils/profiling.py``). A program without the counters,
or a window without a count, reads None."""


def read(record):
    try:
        from adaptive_voice_conversion_tpu_torch.utils.profiling import counter_total
    except ImportError:
        return None
    t0, t1 = record["trace"].window_ns
    computed = counter_total("voc.computed_samples", t0, t1)
    valid = counter_total("voc.samples", t0, t1)
    return 100.0 * (computed - valid) / computed if computed > 0 else None
