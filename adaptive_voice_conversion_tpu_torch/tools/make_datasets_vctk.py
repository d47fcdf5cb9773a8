"""VCTK dataset builder, stage 0 (the JAX package's
``tools/make_datasets_vctk.py``, same argv):

    python -m adaptive_voice_conversion_tpu_torch.tools.make_datasets_vctk \
        <wav48_dir> <speaker-info.txt> <output_dir> <n_out_speakers> \
        <test_prop> <sample_rate> <n_utts_attr> [--seed N] \
        [--device cuda | --host | --tpu]

Splits: ``n_out_speakers`` whole speakers held out (out_test), ``test_prop``
per-speaker utterances held in (in_test); attr.pkl over the first
``n_utts_attr`` train utts; all splits z-normalized with TRAIN stats. Writes
train.pkl, in_test.pkl, out_test.pkl, attr.pkl, in_test_files.txt and
out_test_files.txt.

Featurizes batched on ``--device`` (default ``cuda``); ``--host`` runs the
numpy featurizer (the JAX package's default) and ``--tpu``, the JAX
package's name for its batched path, selects the batched one.
"""

from __future__ import annotations

import glob
import os
import random
import re
import sys
from collections import defaultdict

from ..core.config import SignalConfig
from .etl import (
    compute_attr,
    dump_pickle,
    featurize_paths,
    normalize_split,
    split_flags,
)


def read_speaker_info(path: str):
    """speaker-info.txt: first column, header skipped."""
    ids = []
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 0 or not line.strip():
                continue
            ids.append(line.strip().split()[0])
    return ids


def read_filenames(root_dir: str):
    """wav48/<spk>/<file>.wav with p<spk>_<utt>.wav names."""
    speaker2paths = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(root_dir, "*/*"))):
        m = re.match(r"p(\d+)_(\d+)\.wav", os.path.basename(path))
        if m:
            speaker2paths[m.group(1)].append(path)
    return speaker2paths


def main(argv=None) -> None:
    argv, opts = split_flags(sys.argv[1:] if argv is None else argv)
    (data_dir, speaker_info_path, output_dir, test_speakers, test_prop,
     sample_rate, n_utts_attr) = argv[:7]
    test_speakers, n_utts_attr = int(test_speakers), int(n_utts_attr)
    test_prop, sample_rate = float(test_prop), int(sample_rate)
    cfg = SignalConfig(sr=sample_rate)
    rng = random.Random(opts["seed"])

    speaker_ids = read_speaker_info(speaker_info_path)
    rng.shuffle(speaker_ids)
    train_speakers = speaker_ids[:-test_speakers]
    out_speakers = speaker_ids[-test_speakers:]
    speaker2paths = read_filenames(data_dir)

    train_paths, in_test_paths, out_test_paths = [], [], []
    for spk in train_speakers:
        paths = list(speaker2paths[spk])
        rng.shuffle(paths)
        n_test = int(len(paths) * test_prop)
        train_paths += paths[: len(paths) - n_test]
        in_test_paths += paths[len(paths) - n_test :] if n_test else []
    for spk in out_speakers:
        out_test_paths += speaker2paths[spk]

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "in_test_files.txt"), "w") as f:
        f.writelines(p + "\n" for p in in_test_paths)
    with open(os.path.join(output_dir, "out_test_files.txt"), "w") as f:
        f.writelines(p + "\n" for p in out_test_paths)

    attr = None
    for dset, paths in (
        ("train", train_paths),
        ("in_test", in_test_paths),
        ("out_test", out_test_paths),
    ):
        print(f"processing {dset} set, {len(paths)} files", flush=True)
        data = featurize_paths(sorted(paths), cfg, host=opts["host"], device=opts["device"])
        if dset == "train":
            attr = compute_attr(data, list(data.keys()), n_utts_attr)
            dump_pickle(attr, os.path.join(output_dir, "attr.pkl"))
        dump_pickle(
            normalize_split(data, attr), os.path.join(output_dir, f"{dset}.pkl")
        )


if __name__ == "__main__":
    main()
