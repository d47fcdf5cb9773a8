"""LibriTTS dataset builder, stage 0 (the JAX package's
``tools/make_datasets_libri.py``, same argv):

    python -m adaptive_voice_conversion_tpu_torch.tools.make_datasets_libri \
        <libritts_root> <output_dir> <dev_proportion> <n_utts_attr> \
        <train_set> <test_set> [--seed N] [--device cuda | --host | --tpu]

Utterance-level train/dev split of ``train_set`` (e.g. train-clean-100);
``test_set`` (e.g. dev-clean) is the test split. attr + train-stat
normalization as in the VCTK builder; writes train.pkl, dev.pkl, test.pkl,
attr.pkl and the three file lists. The featurizer flags are the VCTK
builder's.
"""

from __future__ import annotations

import glob
import os
import random
import sys

from ..core.config import SignalConfig
from .etl import (
    compute_attr,
    dump_pickle,
    featurize_paths,
    normalize_split,
    split_flags,
)


def read_paths(root_dir: str, dset: str):
    """<root>/<set>/<spk>/<chapter>/*.wav"""
    return sorted(glob.glob(os.path.join(root_dir, dset, "*/*/*.wav")))


def main(argv=None) -> None:
    argv, opts = split_flags(sys.argv[1:] if argv is None else argv)
    data_dir, output_dir, dev_proportion, n_utts_attr, train_set, test_set = argv[:6]
    dev_proportion, n_utts_attr = float(dev_proportion), int(n_utts_attr)
    cfg = SignalConfig()
    rng = random.Random(opts["seed"])

    paths = read_paths(data_dir, train_set)
    rng.shuffle(paths)
    n_dev = int(len(paths) * dev_proportion)
    train_paths, dev_paths = paths[: len(paths) - n_dev], paths[len(paths) - n_dev :]
    test_paths = read_paths(data_dir, test_set)
    print(
        f"{len(train_paths)} training data, {len(dev_paths)} dev data, "
        f"{len(test_paths)} test data",
        flush=True,
    )

    os.makedirs(output_dir, exist_ok=True)
    for name, ps in (
        ("train_files.txt", train_paths),
        ("dev_files.txt", dev_paths),
        ("test_files.txt", test_paths),
    ):
        with open(os.path.join(output_dir, name), "w") as f:
            f.writelines(os.path.basename(p) + "\n" for p in sorted(ps))

    attr = None
    for dset, ps in (("train", train_paths), ("dev", dev_paths), ("test", test_paths)):
        print(f"processing {dset} set, {len(ps)} files", flush=True)
        data = featurize_paths(ps, cfg, host=opts["host"], device=opts["device"])
        if dset == "train":
            attr = compute_attr(data, list(data.keys()), n_utts_attr)
            dump_pickle(attr, os.path.join(output_dir, "attr.pkl"))
        dump_pickle(
            normalize_split(data, attr), os.path.join(output_dir, f"{dset}.pkl")
        )


if __name__ == "__main__":
    main()
