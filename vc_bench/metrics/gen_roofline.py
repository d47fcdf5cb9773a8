"""gen_roofline.<cell>: the HiFi-GAN generator's valid work as a share of
the device's busy time, in %.

The least time of the traced calls' generator work at their pairs' true
decoder lengths (reference/hifigan_flops.py: its operations at 495 TFLOP/s,
TF32, or its input, weights and output once over 3.35 TB/s, whichever is
longer; a unit's ``gl_frames``, every pair at its decoder's length, the
frames the vocoder runs over) over the union of every device operation
in the traced window. It counts the valid work only, so it reads the same
work however the program pads, fuses or packs; it reads low by the model's
and the copies' share of the busy time.
"""

from vc_bench.reference.hifigan_flops import gen_least_seconds


def read(record):
    voc = record["config"]["vocoder"]
    units = [u for u in record["units"] if not u.get("failed")]
    least = gen_least_seconds(voc, sum(u["gl_frames"] for u in units), calls=len(units))
    busy = record["trace"].busy_s()
    return 100.0 * least / busy if busy > 0 and least > 0 else None
