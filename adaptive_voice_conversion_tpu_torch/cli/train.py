"""Training CLI (the reference's flag surface, same names).

    python -m adaptive_voice_conversion_tpu_torch.cli.train \
        -config config.yaml -data_dir <dir> -train_set train_128 \
        -train_index_file train_samples_128.json -iters 500000

Runs on ``cuda`` unless ``--device cpu`` is given. ``--compute_dtype
bfloat16`` overrides the config's.

Data-parallel: one process per GPU, started by torchrun, each a rank of the
data axis (core/mesh.py):

    torchrun --standalone --nproc_per_node 8 \
        -m adaptive_voice_conversion_tpu_torch.cli.train --multihost ...

``--multihost``, or torchrun's ``WORLD_SIZE`` in the environment, starts
the process group: NCCL on GPUs, gloo with ``--device cpu``.
``--n_data`` defaults to the world size and must equal it: the CLI has no
model axis, as the JAX package's has none. Tensor parallelism runs
through ``entry.py`` and ``parallel/``.
"""

import dataclasses
import json
import os
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("-config", "-c", default="config.yaml")
    parser.add_argument("-data_dir", "-d", default=".")
    parser.add_argument("-train_set", default="train")
    parser.add_argument("-train_index_file", default="train_samples_64.json")
    parser.add_argument("-logdir", default="log/")
    parser.add_argument("--load_model", action="store_true")
    # accepted for flag parity; like the reference, resume always restores
    # both model and optimizer
    parser.add_argument("--load_opt", action="store_true")
    parser.add_argument("-store_model_path", default="model")
    parser.add_argument("-load_model_path", default="")
    parser.add_argument("-summary_steps", default=100, type=int)
    parser.add_argument("-save_steps", default=5000, type=int)
    parser.add_argument("-tag", "-t", default="init")
    parser.add_argument("-iters", default=0, type=int)
    parser.add_argument("-seed", default=0, type=int)
    # evaluation on held-out splits
    parser.add_argument("-eval_set", default="",
                        help="e.g. in_test: evaluated after training, and "
                        "during training every -eval_steps when set")
    parser.add_argument("-eval_index_file", default="",
                        help="defaults to {eval_set}_samples_{segment_size}"
                        ".json (the preprocess pipeline's convention)")
    parser.add_argument("-eval_steps", default=0, type=int,
                        help="in-training eval cadence: every N steps log "
                        "held-out losses + one converted audio sample from "
                        "a fixed eval pair (0 = only post-training eval)")
    parser.add_argument("--n_data", type=int, default=0,
                        help="data-parallel size (0 = the world size; one "
                        "rank per process)")
    parser.add_argument("--profile_dir", default="",
                        help="capture a torch.profiler trace of the first "
                             "training steps into this dir")
    parser.add_argument("--debug_nans", action="store_true")
    parser.add_argument("--multihost", action="store_true",
                        help="start the process group from torchrun's "
                        "environment (implied when WORLD_SIZE is set)")
    parser.add_argument("--compute_dtype", default="",
                        choices=["", "float32", "bfloat16"])
    parser.add_argument("--device", default="cuda",
                        help="torch device for the model and the step")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..core.config import load_config
    from ..core.mesh import init_multihost, make_mesh
    from ..train.solver import SolverArgs

    mesh = None
    if args.multihost or "WORLD_SIZE" in os.environ:
        backend = init_multihost(device=args.device)
        mesh = make_mesh(n_data=args.n_data or None)
        if mesh.rank == 0:
            print(f"[mesh] {backend}: {mesh.world_size} ranks, data x model = "
                  f"{mesh.n_data} x {mesh.n_model}", flush=True)
    elif args.n_data > 1:
        raise ValueError(
            f"--n_data {args.n_data}: a process is one rank; start "
            f"{args.n_data} processes with torchrun"
        )

    config = load_config(args.config)
    if args.compute_dtype:
        config = dataclasses.replace(config, compute_dtype=args.compute_dtype)

    solver_args = SolverArgs(
        data_dir=args.data_dir,
        train_set=args.train_set,
        train_index_file=args.train_index_file,
        logdir=args.logdir,
        store_model_path=args.store_model_path,
        load_model_path=args.load_model_path,
        load_model=args.load_model,
        summary_steps=args.summary_steps,
        save_steps=args.save_steps,
        tag=args.tag,
        seed=args.seed,
        eval_steps=args.eval_steps,
        eval_set=args.eval_set,
        eval_index_file=args.eval_index_file,
    )
    if args.debug_nans:
        from ..utils import enable_nan_debugging

        enable_nan_debugging(True)

    try:
        _run(args, config, solver_args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, config, solver_args, mesh) -> None:
    from ..train.solver import Solver

    solver = Solver(config, solver_args, device=args.device, mesh=mesh)
    if args.iters > 0:
        if args.profile_dir:
            from ..utils import profile_trace

            traced = min(args.iters, 3 * config.inner_steps)
            with profile_trace(args.profile_dir):
                solver.train(n_iterations=traced)
            if args.iters - traced > 0:
                solver.train(n_iterations=args.iters - traced)
        else:
            solver.train(n_iterations=args.iters)
    # post-training eval: skipped when an in-training cadence ran, since
    # its last arm already evaluated the final weights
    if args.eval_set and not (args.eval_steps and args.iters > 0):
        idx = args.eval_index_file or f"{args.eval_set}_samples_{config.data_loader.segment_size}.json"
        metrics = solver.evaluate(args.eval_set, idx)
        if solver.is_main:
            print("\neval", args.eval_set, json.dumps(metrics))


if __name__ == "__main__":
    main()
