"""The tiny HiFi-GAN training configuration and cell for the CPU tests:
``convert_grid8x16_hifigan``'s tiny AdaIN-VC and generator (16 mels, hop
40, a 32-channel generator at scales [5, 8]), periods [2, 3], the
discriminators' channels divided by 16, batch 2 x 320 samples (8 frames)."""

from __future__ import annotations

import copy

from vc_bench import run
from vc_bench.tests.tiny import load, tiny_config

CELL = "train_hifigan_b16"
TINY_TRAIN = dict(batch_size=2, segment_samples=320, mpd_periods=[2, 3], mpd_channels=[2, 8, 32, 64, 64],
                  msd_channels=[8, 8, 16, 32, 64, 64, 64], msd_groups=[1, 2, 4, 4, 4, 4, 1])


def tiny_train_config() -> dict:
    cfg = tiny_config()
    full = load("configs", "adain_vc_hifigan_train")
    cfg["vocoder"] = dict(full["vocoder"], in_channels=16, channels=32, upsample_scales=[5, 8],
                          upsample_kernel_sizes=[10, 16])
    cfg["vocoder_train"] = dict(full["vocoder_train"], **TINY_TRAIN)
    return copy.deepcopy(cfg)


def tiny_train_cell() -> dict:
    return dict(load("workloads", CELL), corpus_frames=1500, utt_frames=[20, 80], inner_steps=3,
                warmup_calls=1, trace_units=1)


def tiny_train_run(seed: int, control: bool = False, cfg=None, trace: bool = False) -> dict:
    return run.run_cell(CELL, seed, 0.1, trace, device="cpu", cell=tiny_train_cell(),
                        cfg=cfg or tiny_train_config(), control=control, log=lambda s: None)
