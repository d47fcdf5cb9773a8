"""Batched cross-conversion CLI: the serving configuration as a command.

Converts every source against every target in one padded batch through the
model and one batched Griffin-Lim call (infer/inferencer.py convert_grid:
length-masked, so mixed-length wavs convert as one-at-a-time conversion
would convert them).

    python -m adaptive_voice_conversion_tpu_torch.cli.convert_grid \
        -a attr.pkl -c config.yaml -m vctk_model.ckpt \
        -s src1.wav src2.wav -t tgtA.wav tgtB.wav -o out_dir --gl_method fused

Writes ``out_dir/<source-stem>__to__<target-stem>.wav`` for each pair.
``-m`` is a reference-format torch ``.ckpt``, or a path whose
``<path>.ckpts`` directory holds the port's training checkpoints. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

import os
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("-attr", "-a", help="attr file path", required=True)
    parser.add_argument("-config", "-c", help="config file path", required=True)
    parser.add_argument("-model", "-m", help="model path (.ckpt, or the -store_model_path of a training run)", required=True)
    parser.add_argument("-sources", "-s", nargs="+", required=True,
                        help="source wav paths (content)")
    parser.add_argument("-targets", "-t", nargs="+", required=True,
                        help="target wav paths (speaker)")
    parser.add_argument("-output_dir", "-o", required=True)
    parser.add_argument("--gl_method", default="exact", choices=["exact", "fused", "pallas"],
                        help="Griffin-Lim: per-sample-exact masked iterations, "
                        "or the fused CUDA kernel between masked exact "
                        "warm-start and polish iterations (pallas: the JAX "
                        "package's name for fused)")
    parser.add_argument("--gl_iters", type=int, default=None,
                        help="Griffin-Lim iterations (default: config n_iter)")
    parser.add_argument("--len_bucket", type=int, default=1,
                        help="round padded shapes up to this many frames "
                        "(results unchanged: the masked path is exact under "
                        "any padding)")
    parser.add_argument("--precision", default=None,
                        choices=["default", "high", "highest"],
                        help="TF32 switches: default leaves PyTorch's, "
                        "highest turns TF32 off, high turns it on")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the model and vocoder")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..core.config import load_config
    from ..dsp.audio import save_wav
    from ..dsp.features import get_spectrograms
    from ..infer.inferencer import Inferencer

    config = load_config(args.config)
    inferencer = Inferencer.from_model_path(
        config, args.model, args.attr, device=args.device,
        gl_method=args.gl_method, precision=args.precision,
    )

    def featurize(paths):
        return [
            inferencer.normalize(get_spectrograms(p, config.signal)[0]) for p in paths
        ]

    wavs = inferencer.convert_grid(
        featurize(args.sources), featurize(args.targets),
        gl_iters=args.gl_iters, len_bucket=args.len_bucket,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    stem = lambda p: os.path.splitext(os.path.basename(p))[0]
    n_t = len(args.targets)
    for i, sp in enumerate(args.sources):
        for j, tp in enumerate(args.targets):
            out = os.path.join(args.output_dir, f"{stem(sp)}__to__{stem(tp)}.wav")
            save_wav(out, wavs[i * n_t + j], config.signal.sr)
    print(f"wrote {len(wavs)} conversions to {args.output_dir}", flush=True)


if __name__ == "__main__":
    main()
