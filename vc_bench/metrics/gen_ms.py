"""gen_ms.<cell>: the program's ``vtrain.gen`` spans: a HiFi-GAN training
step's generator update (the loss mels, both discriminators again, the
losses, backward, the optimiser step), per step, in ms over the traced
window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "vtrain.gen")
