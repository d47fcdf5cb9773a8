"""chunk_wait_ms.<cell>: the program's ``train.chunk_wait`` spans: the
chunked mode's wait, at a chunk switch, for the next chunk's copy to the
device, per training step, in ms over the traced window
(vc_bench/spans.py). A program without the span reads None."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train.chunk_wait")
