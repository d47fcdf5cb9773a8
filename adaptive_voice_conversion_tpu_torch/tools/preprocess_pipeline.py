"""Staged preprocess pipeline runner (the JAX package's
``tools/preprocess_pipeline.py``: stages 0-3 as one Python CLI):

    python -m adaptive_voice_conversion_tpu_torch.tools.preprocess_pipeline vctk \
        --raw_data_dir <VCTK-Corpus> --data_dir <out> [--stage 0] \
        [--segment_size 128] [--n_out_speakers 20] [--test_prop 0.1] \
        [--sample_rate 24000] [--training_samples 10000000] \
        [--testing_samples 10000] [--n_utts_attr 5000] [--seed N] \
        [--device cuda | --host | --tpu]

    python -m ....preprocess_pipeline libri --raw_data_dir <LibriTTS> ...

Stage 0 builds the featurized, normalized splits (make_datasets_vctk /
make_datasets_libri; ``--device`` and ``--host`` pass through to them, and
``--tpu`` selects the batched featurizer, which is the default here),
stage 1 keeps the train utterances longer than a segment
(train_<seg>.pkl), stages 2-3 draw the segment indexes of the train and
test splits (<split>_samples_<seg>.json).
"""

import os
from argparse import ArgumentParser

from . import make_datasets_libri, make_datasets_vctk, reduce_dataset, sample_single_segments


def main(argv=None) -> None:
    p = ArgumentParser()
    p.add_argument("corpus", choices=["vctk", "libri"])
    p.add_argument("--raw_data_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--segment_size", type=int, default=128)
    p.add_argument("--n_out_speakers", type=int, default=20)
    p.add_argument("--test_prop", type=float, default=0.1)
    p.add_argument("--dev_prop", type=float, default=0.05)
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--training_samples", type=int, default=10_000_000)
    p.add_argument("--testing_samples", type=int, default=10_000)
    p.add_argument("--n_utts_attr", type=int, default=5000)
    p.add_argument("--train_set", default="train-clean-100")
    p.add_argument("--test_set", default="dev-clean")
    p.add_argument("--tpu", action="store_true",
                   help="the JAX package's name for the batched featurizer (the default)")
    p.add_argument("--host", action="store_true", help="featurize with host numpy")
    p.add_argument("--device", default="cuda", help="torch device of the batched featurizer")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    if args.tpu and args.host:
        p.error("--host and --tpu select different featurizers; give one")

    d, seg = args.data_dir, args.segment_size
    feat = ["--host"] if args.host else ["--device", args.device]
    seed = ["--seed", str(args.seed)] if args.seed is not None else []

    if args.stage <= 0:
        if args.corpus == "vctk":
            make_datasets_vctk.main(
                [
                    os.path.join(args.raw_data_dir, "wav48"),
                    os.path.join(args.raw_data_dir, "speaker-info.txt"),
                    d, str(args.n_out_speakers), str(args.test_prop),
                    str(args.sample_rate), str(args.n_utts_attr),
                ] + feat + seed
            )
        else:
            make_datasets_libri.main(
                [
                    args.raw_data_dir, d, str(args.dev_prop),
                    str(args.n_utts_attr), args.train_set, args.test_set,
                ] + feat + seed
            )
    if args.stage <= 1:
        reduce_dataset.main(
            [os.path.join(d, "train.pkl"), os.path.join(d, f"train_{seg}.pkl"), str(seg)]
        )
    if args.stage <= 2:
        sample_single_segments.main(
            [
                os.path.join(d, "train.pkl"),
                os.path.join(d, f"train_samples_{seg}.json"),
                str(args.training_samples), str(seg),
            ] + seed
        )
    if args.stage <= 3:
        splits = (
            ["in_test", "out_test"] if args.corpus == "vctk" else ["dev", "test"]
        )
        for split in splits:
            sample_single_segments.main(
                [
                    os.path.join(d, f"{split}.pkl"),
                    os.path.join(d, f"{split}_samples_{seg}.json"),
                    str(args.testing_samples), str(seg),
                ] + seed
            )


if __name__ == "__main__":
    main()
