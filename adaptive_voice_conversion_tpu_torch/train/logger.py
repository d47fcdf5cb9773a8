"""Metrics logging: tensorboardX scalars when that package is installed,
plus a JSONL stream (``metrics.jsonl``), written by the main process only."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class Logger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        # one process for now, so every Logger is the main process's
        self.is_main = True
        self.logdir = logdir
        self._tb = None
        self._jsonl = None
        if not self.is_main:
            return
        os.makedirs(logdir, exist_ok=True)
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar_summary(self, tag: str, value, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        self._write_jsonl(step, {tag: float(value)})

    def scalars_summary(self, tag: str, dictionary: Dict, step: int) -> None:
        vals = {k: float(v) for k, v in dictionary.items()}
        if self._tb is not None:
            self._tb.add_scalars(tag, vals, step)
        self._write_jsonl(step, {f"{tag}/{k}": v for k, v in vals.items()})

    def text_summary(self, tag: str, value: str, step: int) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, value, step)

    def audio_summary(self, tag: str, value, step: int, sr: int) -> None:
        """Falls back to writing a wav next to the logs when tensorboardX is
        absent or lacks its soundfile dependency. Always records the
        emission in metrics.jsonl (sample count) so runs are auditable
        without parsing event files."""
        self._write_jsonl(step, {f"{tag}/audio_n_samples": int(len(value))})
        if self._tb is not None:
            try:
                self._tb.add_audio(tag, value, step, sample_rate=sr)
                return
            except Exception:
                pass
        if self.is_main:
            from ..dsp.audio import save_wav

            safe = tag.replace("/", "_")
            save_wav(
                os.path.join(self.logdir, f"{safe}_{step}.wav"),
                np.asarray(value, dtype=np.float32),
                sr,
            )

    def _write_jsonl(self, step: int, payload: Dict) -> None:
        if self._jsonl is None:
            return
        rec = {"step": step, "time": time.time(), **payload}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
