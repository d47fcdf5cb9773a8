"""mel_ms.<cell>: the program's ``dsp.mel`` spans: the host featurizer's STFT,
mel product and dB normalisation, per request, in ms over the traced window
(vc_bench/spans.py)."""

from vc_bench.spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "dsp.mel")
