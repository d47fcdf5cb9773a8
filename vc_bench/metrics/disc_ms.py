"""disc_ms.<cell>: the program's ``vtrain.disc`` spans: a HiFi-GAN
training step's generator forward and discriminators' update, through its
optimiser step, per step, in ms over the traced window
(vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "vtrain.disc")
