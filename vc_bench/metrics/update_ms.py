"""update_ms.<cell>: the program's ``train.update`` spans: a training step's
update (spectral norm's power iteration where the decoder has it, the
optimiser), per step, in ms over the traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train.update")
