"""trim_ms.<cell>: the program's ``dsp.trim`` spans: the host's silence trims
(the featurizer's input trims and the converted wavs' trims), per request or
grid call, in ms over the traced window (vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "dsp.trim")
