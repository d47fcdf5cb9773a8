"""mfu.<cell>: the traced units' share of the H100's peaks over the traced
window.

A training unit is its ``steps`` x the step's operations from the
configuration (reference/flops.py: 658.0 GFLOP at 128 x 128 for the
published model, plus spectral norm's power iterations) at the TF32 peak:
the cells' convolutions run in TF32. A conversion unit is the model forward
of each of its pairs at their true lengths (the speaker encoder on the
target, the content encoder on the source, the decoder) at the TF32 peak,
plus its Griffin-Lim kernel work over ``gl_frames`` at the bf16 peak.
"""

from vc_bench.reference.flops import PEAK_BF16, PEAK_TF32, gl_flops, inference_flops, train_step_flops


def least_seconds(cfg: dict, u: dict) -> float:
    if "steps" in u:
        dl = cfg["data_loader"]
        return u["steps"] * train_step_flops(cfg, dl["batch_size"], dl["segment_size"]) / PEAK_TF32
    model = sum(inference_flops(cfg, s, t) for s in u["src_frames"] for t in u["tar_frames"])
    return model / PEAK_TF32 + gl_flops(cfg["signal"], u["gl_frames"]) / PEAK_BF16


def read(record):
    t = sum(least_seconds(record["config"], u) for u in record["units"] if not u.get("failed"))
    return 100.0 * t / record["trace"].window_s
