"""wait_ms.<cell>: the program's ``infer.to_host`` spans: the host's wait for
the device and the copy of each result to the host, per request or grid
call, in ms over the traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "infer.to_host")
