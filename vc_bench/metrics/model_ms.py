"""model_ms.<cell>: the program's ``infer.model`` spans: the model's forward
dispatch in the Inferencer, per request or grid call, in ms over the traced
window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "infer.model")
