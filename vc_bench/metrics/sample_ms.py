"""sample_ms.<cell>: the program's ``train.sample`` spans: a training step's
draw of its batch (the step's seed, the segment gather on the device, the KL
weight), per step, in ms over the traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train.sample")
