"""Stages 2-3: sample random (utt_id, t) segment offsets (the JAX package's
``tools/sample_single_segments.py``, same argv):

    python -m adaptive_voice_conversion_tpu_torch.tools.sample_single_segments \
        <in.pkl> <out.json> <n_samples> <segment_size> [--seed N]
"""

import pickle
import sys

from .etl import dump_json, sample_single_segments


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    seed = None
    if "--seed" in argv:
        i = argv.index("--seed")
        seed = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]
    pickle_path, sample_path = argv[0], argv[1]
    n_samples, segment_size = int(argv[2]), int(argv[3])
    with open(pickle_path, "rb") as f:
        data = pickle.load(f)
    samples = sample_single_segments(data, n_samples, segment_size, seed=seed)
    dump_json(samples, sample_path)


if __name__ == "__main__":
    main()
