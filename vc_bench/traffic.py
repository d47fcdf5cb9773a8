"""The benchmark's inputs, made from the seed: waves, normalised mels, the
attribute file, and the order a window takes them in.

Every seed gets the same set of sizes in another order: a pool's lengths
are spread evenly over the cell's range (the midpoints of equal strata),
and each cycle through a pool is a fresh seeded permutation, so the work a
window does depends on the seed only through the order.
"""

from __future__ import annotations

import math
import pickle
from typing import List, Sequence

import numpy as np
import torch


def strata(n: int, lo: float, hi: float) -> np.ndarray:
    """n values spread evenly over [lo, hi]: the midpoints of n strata."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def cycle_order(seed: int, stream: int, cycle: int, n: int) -> np.ndarray:
    """The seeded permutation of a pool of n for one cycle through it."""
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, stream, cycle]).permutation(n)


def voiced_waves(lengths_s: Sequence[float], sr: int, seed: int, device,
                 silence_s=(0.1, 0.3), n_harmonics: int = 20) -> List[np.ndarray]:
    """One voiced utterance per length, made on ``device`` in one batch and
    returned as f32 host arrays: a harmonic series (amplitudes 1/k, under
    the Nyquist frequency) over a pitch contour (a base of 90-260 Hz, a
    slow vibrato and a glide), a 3-6 Hz syllable envelope, noise at -40 dB,
    and 0.1-0.3 s of near-silence (-60 dB) at each end, which the
    featurizer's trim at 15 dB removes."""
    gen = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    n = len(lengths_s)
    lens = [int(round(s * sr)) for s in lengths_s]
    t_max = max(lens)
    u = torch.rand(n, 8, generator=gen, device=device)
    t = torch.arange(t_max, device=device, dtype=torch.float32)[None, :] / sr
    f0 = (90.0 + 170.0 * u[:, :1]) * (
        1.0 + 0.03 * torch.sin(2 * math.pi * (4.0 + 3.0 * u[:, 1:2]) * t)
        + 0.15 * (u[:, 2:3] - 0.5) * t / (t_max / sr))
    phase = torch.cumsum(2 * math.pi * f0 / sr, dim=1)
    y = torch.zeros(n, t_max, device=device)
    for k in range(1, n_harmonics + 1):
        y += torch.where(k * f0 < sr / 2, torch.sin(k * phase) / k, torch.zeros((), device=device))
    env = 0.55 + 0.45 * torch.sin(2 * math.pi * (3.0 + 3.0 * u[:, 3:4]) * t + 6.28 * u[:, 4:5])
    y = 0.3 * env * y / y.abs().amax(dim=1, keepdim=True)
    y += 0.003 * torch.randn(n, t_max, generator=gen, device=device)
    lead = silence_s[0] + (silence_s[1] - silence_s[0]) * u[:, 5]
    tail = silence_s[0] + (silence_s[1] - silence_s[0]) * u[:, 6]
    length = torch.tensor(lens, device=device, dtype=torch.float32)[:, None]
    quiet = (t < lead[:, None]) | (t * sr >= length - tail[:, None] * sr)
    y = torch.where(quiet, y * 1e-3, y)
    host = y.cpu().numpy()
    return [np.ascontiguousarray(host[i, : lens[i]]) for i in range(n)]


def normal_mels(n: int, frames: int, n_mels: int, seed: int, device) -> np.ndarray:
    """n normalised mels (frames, n_mels), unit normal, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    return torch.randn(n, frames, n_mels, generator=gen, device=device).cpu().numpy()


def write_attr(path: str, n_mels: int, seed: int) -> dict:
    """The Inferencer's attribute file: per-channel mean and std of the
    normalised dB mel, drawn around a corpus' typical 0.45-0.55 and
    0.12-0.17."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 99])
    attr = {"mean": (0.45 + 0.1 * rng.random(n_mels)).astype(np.float32),
            "std": (0.12 + 0.05 * rng.random(n_mels)).astype(np.float32)}
    with open(path, "wb") as f:
        pickle.dump(attr, f)
    return attr


def kept(seed: int, among: int, count: int) -> np.ndarray:
    """Which units a run keeps for the check: ``count`` of the first
    ``among``, drawn from the seed."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    out = np.zeros(among, dtype=bool)
    out[rng.choice(among, size=count, replace=False)] = True
    return out
