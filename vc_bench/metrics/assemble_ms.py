"""assemble_ms.<cell>: the program's ``infer.assemble`` spans: the Inferencer's
input assembly (framing, padding, stacking, the cross product, host-to-
device copies, length reads), per request or grid call, in ms over the
traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "infer.assemble")
