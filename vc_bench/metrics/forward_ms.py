"""forward_ms.<cell>: the program's ``train.forward`` spans: a training step's
forward dispatch (zero_grad through the loss), per step, in ms over the
traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train.forward")
