"""gl_roofline.<cell>: the Griffin-Lim kernel's share of its roofline.

The least time the traced units' kernel work needs (reference/flops.py: 94
iterations of two bf16 products over the frames of a unit's launch, its
``gl_frames``, at 989 TFLOP/s, or its inputs and output once over
3.35 TB/s, whichever is longer) over the device time of the kernel's
launches (the union of the ``gl_prep`` / ``gl_gemm`` / ``gl_band``
intervals: the launches overlap).
"""

from vc_bench.reference.flops import gl_least_seconds

KERNEL = r"\bgl_(prep|gemm|band)\b"


def read(record):
    sig = record["config"]["signal"]
    least = sum(gl_least_seconds(sig, u["gl_frames"]) for u in record["units"] if not u.get("failed"))
    busy = record["trace"].busy_s(KERNEL)
    return 100.0 * least / busy if busy > 0 and least > 0 else None
