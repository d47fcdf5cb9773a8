"""Stage 1: keep the utterances longer than segment_size (the JAX package's
``tools/reduce_dataset.py``, same argv):

    python -m adaptive_voice_conversion_tpu_torch.tools.reduce_dataset \
        <in.pkl> <out.pkl> [<segment_size>]

segment_size defaults to 128, the shipped config's value.
"""

import pickle
import sys

from .etl import reduce_dataset


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    in_path, out_path = argv[0], argv[1]
    segment_size = int(argv[2]) if len(argv) > 2 else 128
    with open(in_path, "rb") as f:
        data = pickle.load(f)
    reduced = reduce_dataset(data, segment_size)
    with open(out_path, "wb") as f:
        pickle.dump(reduced, f)
    print(f"{len(reduced)}/{len(data)} utterances kept (> {segment_size} frames)")


if __name__ == "__main__":
    main()
