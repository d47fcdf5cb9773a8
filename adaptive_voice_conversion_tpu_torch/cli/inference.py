"""One-shot conversion CLI (the reference's flags).

    python -m adaptive_voice_conversion_tpu_torch.cli.inference \
        -a attr.pkl -c config.yaml -m vctk_model.ckpt \
        -s source.wav -t target.wav -o output.wav --gl_method fused

``-m`` is a reference-format torch ``.ckpt``, or a path whose
``<path>.ckpts`` directory holds the port's training checkpoints. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("-attr", "-a", help="attr file path", required=True)
    parser.add_argument("-config", "-c", help="config file path", required=True)
    parser.add_argument("-model", "-m", help="model path (.ckpt, or the -store_model_path of a training run)", required=True)
    parser.add_argument("-source", "-s", help="source wav path", required=True)
    parser.add_argument("-target", "-t", help="target wav path", required=True)
    parser.add_argument("-output", "-o", help="output wav path", required=True)
    parser.add_argument("-sample_rate", "-sr", default=24000, type=int)
    parser.add_argument("--cpu_vocoder", action="store_true",
                        help="vocode on the host with the numpy oracle "
                        "(exact, n_iter from the config), whatever --gl_method is")
    parser.add_argument("--gl_method", default="exact", choices=["exact", "fused", "pallas"],
                        help="Griffin-Lim: the exact torch.fft loop, or the "
                        "fused CUDA kernel's hybrid schedule (pallas: the JAX "
                        "package's name for fused)")
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
    from ..infer.inferencer import Inferencer

    config = load_config(args.config)
    inferencer = Inferencer.from_model_path(
        config, args.model, args.attr, device=args.device,
        gl_method=args.gl_method, precision=args.precision,
        gpu_vocoder=not args.cpu_vocoder,
    )
    inferencer.inference_from_path(args.source, args.target, args.output)


if __name__ == "__main__":
    main()
