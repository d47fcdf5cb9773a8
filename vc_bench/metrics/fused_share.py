"""fused_share.<cell>: the share of the HiFi-GAN generator's junctions (the
elementwise passes between two of its convolutions) that its hand-written
junction kernel ran in the traced window, in %: 100 x
``voc.fused_junctions`` / ``voc.junctions``, the program's counters
(``utils/profiling.py``). A program without the counters, or a window
without a count, reads None."""


def read(record):
    try:
        from adaptive_voice_conversion_tpu_torch.utils.profiling import counter_total
    except ImportError:
        return None
    t0, t1 = record["trace"].window_ns
    junctions = counter_total("voc.junctions", t0, t1)
    fused = counter_total("voc.fused_junctions", t0, t1)
    return 100.0 * fused / junctions if junctions > 0 else None
