"""Segment dataset over the reference's preprocess artifacts.

Consumes the artifact formats the reference produces (so its preprocessing
output is drop-in): a pickle dict ``{utt_id: (T, n_mels) float32}`` and a
JSON index of ``[utt_id, t]`` pairs.

All utterances are packed into one contiguous array at load; a whole batch
of segments is then a single vectorised fancy-index gather, fast enough on
one host thread, with no worker processes.

``storage_dtype="bfloat16"`` holds the packed array as the bf16 **bit
pattern** in uint16 (rounded to nearest even with integer arithmetic), the
format a batch crosses to the device in; the training step reinterprets it
there (train/step.py ``from_wire_format``).
"""

from __future__ import annotations

import json
import pickle
from typing import Sequence

import numpy as np


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the bfloat16 bit pattern (uint16), round to nearest even;
    NaNs become the quiet NaN of their sign."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (bits + (((bits >> 16) & 1) + np.uint32(0x7FFF))) >> 16
    nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = (bits >> 16) | np.uint32(0x0040)
    return np.where(nan, quiet, rounded).astype(np.uint16)


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """The bfloat16 bit pattern (uint16) -> float32, exactly."""
    return (np.ascontiguousarray(bits, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)


def make_frames(batch: np.ndarray, frame_size: int) -> np.ndarray:
    """(B, T, n_mels) -> (B, T/frame_size, frame_size*n_mels); the identity
    for the shipped frame_size=1."""
    if frame_size == 1:
        return batch
    b, t, c = batch.shape
    return batch.reshape(b, t // frame_size, frame_size * c)


class SegmentDataset:
    """Random fixed-length segments from packed utterances."""

    def __init__(
        self,
        pickle_path: str,
        index_path: str,
        segment_size: int,
        storage_dtype: str = "float32",
    ):
        """``storage_dtype='bfloat16'`` halves RAM, host-gather bytes and the
        host-to-device copy; mel values are O(1) normalised so bf16 costs
        ~1e-2 relative quantisation on the training target. float32 is
        bit-exact with the reference."""
        with open(pickle_path, "rb") as f:
            data: dict = pickle.load(f)
        with open(index_path) as f:
            indexes: Sequence = json.load(f)
        self.segment_size = segment_size
        self.bf16 = storage_dtype == "bfloat16"
        dtype = np.dtype(np.uint16) if self.bf16 else np.dtype(storage_dtype)

        utt_ids = list(data.keys())
        id_to_row = {u: i for i, u in enumerate(utt_ids)}
        lengths = np.array([data[u].shape[0] for u in utt_ids], dtype=np.int64)
        offsets = np.zeros(len(utt_ids) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        n_mels = data[utt_ids[0]].shape[1] if utt_ids else 0
        packed = np.empty((int(offsets[-1]), n_mels), dtype=dtype)
        for u, i in id_to_row.items():
            packed[offsets[i] : offsets[i + 1]] = (
                to_bf16_bits(data[u]) if self.bf16 else data[u]
            )
        self.packed = packed
        self.utt_ids = utt_ids
        self.n_mels = n_mels
        self._id_to_row = id_to_row
        self._offsets = offsets

        # absolute start row of every indexed segment
        rows = np.array([id_to_row[u] for u, _ in indexes], dtype=np.int64)
        ts = np.array([t for _, t in indexes], dtype=np.int64)
        self.starts = offsets[rows] + ts

    def __len__(self) -> int:
        return len(self.starts)

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Segment batch for index positions ``idx``: (len(idx), seg, n_mels)
        in the packed array's dtype (uint16 bit patterns for bf16 storage)."""
        starts = self.starts[idx]
        rows = starts[:, None] + np.arange(self.segment_size)[None, :]
        return self.packed[rows]

    def get_utterance(self, utt_id: str) -> np.ndarray:
        """Full (T, n_mels) float32 mel of one utterance, sliced out of the
        packed array through the retained row offsets."""
        i = self._id_to_row[utt_id]
        out = self.packed[self._offsets[i] : self._offsets[i + 1]]
        return from_bf16_bits(out) if self.bf16 else np.asarray(out, dtype=np.float32)
