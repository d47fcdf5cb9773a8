"""vocode_ms.<cell>: the program's ``infer.vocode`` spans: the vocoder's
dispatch (mel to magnitude, Griffin-Lim, de-emphasis), per request or grid
call, in ms over the traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "infer.vocode")
