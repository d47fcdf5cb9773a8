"""backward_ms.<cell>: the program's ``train.backward`` spans: a training
step's ``loss.backward()`` dispatch, per step, in ms over the traced window
(vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train.backward")
