"""Training the HiFi-GAN V1 vocoder on this system's features
(train/vocoder.py): the generator that a config's ``vocoder: {kind:
hifigan}`` section serves with, against its discriminators.

    python -m adaptive_voice_conversion_tpu_torch.cli.train_vocoder \
        -c config.yaml -a attr.pkl -w wavs/ -o vocoder.pkl --steps 2500000

``-c`` needs a ``vocoder`` section of kind hifigan and a ``vocoder_train``
section. ``-w`` takes wav files and directories (their ``*.wav``, sorted,
recursively); each is read and trimmed as preprocessing reads it
(``dsp/audio.py`` ``load_wav`` at the config's rate, then ``trim_silence``
at its ``top_db``); the pre-emphasis is the featurizer's, inside the
step. ``-a`` is the attribute file of the model's training data, whose mean
and std normalise the generator's input mels as serving does. The
checkpoint (ParallelWaveGAN's layout) is written to ``-o`` every
``--save_steps`` steps and at the end; ``--resume`` continues from it.
Serve it with ``--vocoder_ckpt`` on ``cli.inference`` or ``cli.convert_grid``.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

import glob
import os
import pickle
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("-config", "-c", required=True)
    parser.add_argument("-attr", "-a", required=True, help="attr.pkl: the mels' mean and std")
    parser.add_argument("-wavs", "-w", nargs="+", required=True, help="wav files and directories")
    parser.add_argument("-output", "-o", required=True, help="the training checkpoint's path")
    parser.add_argument("--steps", type=int, required=True, help="steps to train (more, when resuming)")
    parser.add_argument("--resume", action="store_true", help="continue from the checkpoint at -o")
    parser.add_argument("--save_steps", type=int, default=10000)
    parser.add_argument("--log_steps", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    return parser


def wav_paths(items) -> list:
    out = []
    for item in items:
        if os.path.isdir(item):
            out += sorted(glob.glob(os.path.join(item, "**", "*.wav"), recursive=True))
        else:
            out.append(item)
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..core.config import load_config
    from ..dsp.audio import load_wav, trim_silence
    from ..train.vocoder import VocoderTrainer

    config = load_config(args.config)
    paths = wav_paths(args.wavs)
    waves = [trim_silence(load_wav(p, config.signal.sr), config.signal.top_db)[0] for p in paths]
    with open(args.attr, "rb") as f:
        attr = pickle.load(f)
    trainer = VocoderTrainer(config, waves, attr, seed=args.seed, device=args.device)
    print(f"{trainer.corpus.n_utterances} of {len(paths)} utterances hold a segment; "
          f"{trainer.steps_per_epoch} steps an epoch", flush=True)
    if args.resume:
        trainer.load(args.output)
        print(f"resumed at step {trainer.steps}", flush=True)
    end = trainer.steps + args.steps
    while trainer.steps < end:
        n = min(args.save_steps - trainer.steps % args.save_steps, end - trainer.steps)
        trainer.train(n, log_every=args.log_steps, log=lambda s: print(s, flush=True))
        trainer.save(args.output)
    print(f"saved step {trainer.steps} to {args.output}", flush=True)


if __name__ == "__main__":
    main()
