"""Tiny configurations and cells for the CPU tests: the cells' own drivers
and traffic files at widths and lengths a CPU test run holds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def tiny_config(sn: bool = False) -> dict:
    cfg = copy.deepcopy(load("configs", "adain_vc_sn" if sn else "adain_vc"))
    for enc in ("SpeakerEncoder", "ContentEncoder"):
        cfg[enc].update(c_in=16, c_h=8, c_out=4, c_bank=4, bank_size=4, n_conv_blocks=3,
                        subsample=[1, 2, 2])
    cfg["SpeakerEncoder"]["n_dense_blocks"] = 2
    cfg["Decoder"].update(c_in=4, c_cond=4, c_h=8, c_out=16, n_conv_blocks=3, upsample=[2, 2, 1])
    cfg["data_loader"].update(batch_size=8, segment_size=16)
    cfg["signal"].update(sr=8000, n_fft=256, hop_length=40, win_length=160, n_mels=16, n_iter=12)
    return cfg


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(load("workloads", name))
    if cell["driver"] == "train_device":
        cell.update(corpus_frames=4000, utt_frames=[20, 80], inner_steps=4, warmup_calls=1,
                    trace_units=1)
    elif cell["driver"] == "oneshot":
        cell.update(wave_seconds=[0.6, 1.2], pool=4, check_share=0.5, trace_units=2)
    else:
        cell.update(mel_frames=[12, 40], n_src=2, n_tar=3, pool=8, cycle_calls=2,
                    check_share=0.5, trace_units=1)
    return cell
