"""generator_ms.<cell>: the program's ``infer.generate`` spans: the HiFi-GAN
generator's dispatch and its length masks, per grid call, in ms over the
traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "infer.generate")
