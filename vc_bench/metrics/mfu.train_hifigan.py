"""mfu.train_hifigan: the traced HiFi-GAN training steps' share of the
H100's TF32 peak over the traced window, in %.

A step is the cost model's operations (reference/hifigan_train_flops.py:
the generator's forward and backward, four passes of both discriminators,
the discriminators' backward to their weights and the generator's update's
backward through them to y_hat; 3.04 TFLOP at 16 x 8400 samples); the
steps traced are the program's ``vtrain.segments`` counter
(``utils/profiling.py``) over the window, over the batch. The cell's
convolutions run in TF32. A program without the counter, or a window
without a count, reads None."""

from vc_bench.reference.flops import PEAK_TF32
from vc_bench.reference.hifigan_train_flops import step_flops


def read(record):
    try:
        from adaptive_voice_conversion_tpu_torch.utils.profiling import counter_total
    except ImportError:
        return None
    tr, cfg = record["trace"], record["config"]
    segments = counter_total("vtrain.segments", *tr.window_ns)
    if segments <= 0:
        return None
    steps = segments / cfg["vocoder_train"]["batch_size"]
    return 100.0 * steps * step_flops(cfg) / PEAK_TF32 / tr.window_s
