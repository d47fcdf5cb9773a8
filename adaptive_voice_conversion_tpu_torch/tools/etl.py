"""Shared ETL machinery for the dataset builders.

The preprocessing semantics of the JAX package's ``tools/etl.py``:
- featurize every wav with the tacotron-style mel chain
- attr.pkl = per-bin mean/std over the first ``n_utts_attr`` TRAIN utterances
- z-normalize EVERY split with the train statistics
- reduce: keep utterances strictly longer than segment_size
- sample: N random (utt_id, t) pairs with t <= len - segment_size

Featurization runs on the host in numpy (``host=True``, equal bit for bit to
the JAX package's default path) or batched on a torch device: waves are
loaded, trimmed and pre-emphasized on the host, grouped into 1-second length
buckets, and ``batch`` waves at a time go through
``dsp.features.mel_from_wave_batched`` (``torch.fft`` STFT and one f32 mel
product on the card).
"""

from __future__ import annotations

import json
import os
import pickle
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.config import SignalConfig
from ..core.device import DeviceLike, resolve_device
from ..dsp.audio import load_wav, preemphasis, trim_silence
from ..dsp.features import mel_from_wave, mel_from_wave_batched
from ..dsp.stft import frame_count

Wave = Tuple[str, np.ndarray]


def load_wave(path: str, cfg: SignalConfig) -> np.ndarray:
    """wav file -> trimmed, pre-emphasized wave at ``cfg.sr`` (host numpy)."""
    y = load_wav(path, cfg.sr)
    y, _ = trim_silence(y, cfg.top_db)
    return preemphasis(y, cfg.preemphasis)


def bucket_batches(
    waves: Sequence[Wave], cfg: SignalConfig, batch: int
) -> List[Tuple[int, List[Wave]]]:
    """(padded length, up to ``batch`` waves) per device call: waves grouped
    by the 1-second bucket their reflect-padded length (len + n_fft) falls
    in, buckets in ascending order, the input order kept inside a bucket."""
    ext = 2 * (cfg.n_fft // 2)
    by_bucket: Dict[int, List[Wave]] = {}
    for name, y in waves:
        by_bucket.setdefault(-(-(len(y) + ext) // cfg.sr), []).append((name, y))
    return [
        (b * cfg.sr, items[s : s + batch])
        for b, items in sorted(by_bucket.items())
        for s in range(0, len(items), batch)
    ]


def pad_batch(chunk: Sequence[Wave], pad_len: int, cfg: SignalConfig) -> np.ndarray:
    """The waves of one bucket as a (len(chunk), pad_len) f32 batch.

    Each wave is reflect-padded by n_fft//2 at its own two ends (the host
    featurizer's center=True padding) before it is zero-filled to
    ``pad_len``, so that no frame of its true length reads the fill. The
    JAX package's batched path differs there: it zero-fills first and
    reflects at the bucket's end, so the frames whose window crosses a
    wave's end read zeros and their reflection (on a 1.37 s wav its last 2
    frames are 0.154 and 0.315 away from the host featurizer's, on the
    [0, 1] mel scale)."""
    pad = cfg.n_fft // 2
    wav_b = np.zeros((len(chunk), pad_len), np.float32)
    for r, (_, y) in enumerate(chunk):
        wav_b[r, : len(y) + 2 * pad] = np.pad(y, pad, mode="reflect")
    return wav_b


def featurize_batch(
    chunk: Sequence[Wave], pad_len: int, cfg: SignalConfig, device: torch.device
) -> Dict[str, np.ndarray]:
    """One device call: the waves of one bucket -> mel (T, n_mels) each,
    framed from ``pad_batch`` without further padding."""
    x = torch.from_numpy(pad_batch(chunk, pad_len, cfg)).to(device)
    with torch.no_grad():
        mel, _ = mel_from_wave_batched(x, cfg, centered=False)
    mel = mel.cpu().numpy()
    return {
        name: mel[r, : frame_count(len(y), cfg.n_fft, cfg.hop_length)]
        for r, (name, y) in enumerate(chunk)
    }


def _progress(i: int, n: int, log_every: int, what: str) -> None:
    if i % log_every == 0 or i == n - 1:
        print(f"{what} {i} files", flush=True)


def featurize_paths(
    paths: Sequence[str],
    cfg: SignalConfig,
    device: DeviceLike = None,
    host: bool = False,
    batch: int = 16,
    log_every: int = 500,
) -> Dict[str, np.ndarray]:
    """path -> mel (T, n_mels) for every wav, keyed by basename, in the order
    of ``paths``.

    ``host=True`` is the numpy featurizer (the JAX package's
    ``use_tpu=False``). Otherwise the batched featurizer on ``device``
    (``cuda`` unless the caller asks for the CPU), ``batch`` waves a call.
    Unlike the JAX package's batched path, which returns its mels in bucket
    order, the result keeps the order of ``paths`` on both paths, so the
    first ``n_utts_attr`` utterances of ``compute_attr`` are the same."""
    out: Dict[str, np.ndarray] = {}
    if host:
        for i, path in enumerate(paths):
            _progress(i, len(paths), log_every, "processing")
            mel, _ = mel_from_wave(load_wave(path, cfg), cfg)
            out[os.path.basename(path)] = mel
        return out

    dev = resolve_device(device)
    waves: List[Wave] = []
    for i, path in enumerate(paths):
        _progress(i, len(paths), log_every, "loading")
        waves.append((os.path.basename(path), load_wave(path, cfg)))
    for pad_len, chunk in bucket_batches(waves, cfg, batch):
        out.update(featurize_batch(chunk, pad_len, cfg, dev))
    return {name: out[name] for name, _ in waves}


def compute_attr(
    data: Dict[str, np.ndarray], order: Sequence[str], n_utts_attr: int
) -> Dict[str, np.ndarray]:
    """Mean/std over the first ``n_utts_attr`` train utterances."""
    stack = np.concatenate([data[k] for k in list(order)[:n_utts_attr]], axis=0)
    return {"mean": stack.mean(axis=0), "std": stack.std(axis=0)}


def normalize_split(
    data: Dict[str, np.ndarray], attr: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    m, s = attr["mean"], attr["std"]
    return {k: ((v - m) / s).astype(np.float32) for k, v in data.items()}


def reduce_dataset(data: Dict[str, np.ndarray], segment_size: int) -> Dict:
    """Keep utts with length > segment_size."""
    return {k: v for k, v in data.items() if v.shape[0] > segment_size}


def sample_single_segments(
    data: Dict[str, np.ndarray], n_samples: int, segment_size: int, seed=None
) -> List[Tuple[str, int]]:
    """N random (utt_id, t) pairs, drawn by ``random.Random(seed)``."""
    rng = random.Random(seed)
    utt_list = sorted(u for u in data if len(data[u]) > segment_size)
    print(f"{len(utt_list)} utterances", flush=True)
    samples = []
    for _ in range(n_samples):
        u = utt_list[rng.randrange(len(utt_list))]
        t = rng.randint(0, len(data[u]) - segment_size)
        samples.append((u, t))
    return samples


def dump_pickle(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def split_flags(argv: Sequence[str]) -> Tuple[List[str], dict]:
    """The dataset builders' flags out of their positional argv:
    ``--host`` (the numpy featurizer), ``--tpu`` (the JAX package's name for
    the batched path, the default here), ``--device D`` and ``--seed N``.
    Returns (positional args, {"host", "device", "seed"}); ``host`` and
    ``device`` are ``featurize_paths``'s keywords."""
    rest, opts = [], {"host": False, "device": "cuda", "seed": None}
    batched = False
    it = iter(argv)
    for a in it:
        if a == "--host":
            opts["host"] = True
        elif a == "--tpu":
            batched = True
        elif a in ("--device", "--seed"):
            v = next(it, None)
            if v is None:
                raise SystemExit(f"{a} needs a value")
            opts[a[2:]] = int(v) if a == "--seed" else v
        else:
            rest.append(a)
    if batched and opts["host"]:
        raise SystemExit("--host and --tpu select different featurizers; give one")
    return rest, opts

