"""Data-parallel weak-scaling sweep.

Measures training audio-seconds/s at data-parallel widths 1 -> N, the
fused multi-step trainer (train/step.py ``make_device_data_train_step``) on
a synthetic corpus that every rank holds whole, with the global batch
``batch_size * n`` at width ``n`` (constant work per rank), and reports the
efficiency against linear scaling. Each width starts its own ranks
(parallel/ranks.py). On GPUs a width needs one GPU per rank under NCCL, and
the sweep stops at the first width the host cannot hold: ranks that shared
a GPU would measure the sharing, not scaling. On the CPU (gloo) the sweep
validates the data-parallel program at each width and its rows carry
``validation_only`` in place of an efficiency.

Run:  python -m adaptive_voice_conversion_tpu_torch.parallel.scaling [--sizes 1,2,4,8]
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import DeviceLike, resolve_device
from .ranks import run_ranks


def _sweep_rank(device: torch.device, a: dict) -> dict:
    """One rank of one width: warm-up, then ``chunks`` timed calls of the
    multi-step; returns the seconds per step."""
    from ..core.mesh import make_mesh
    from ..models.ae import AE
    from ..models.modules import init_parameters
    from ..train.optim import make_optimizer
    from ..train.step import make_device_data_train_step

    cfg, n = a["cfg"], a["n"]
    mesh = make_mesh(n_data=n) if n > 1 else None
    rng = np.random.default_rng(a["seed"])
    seg = cfg.data_loader.segment_size
    packed = torch.from_numpy(
        rng.standard_normal((a["n_frames"], cfg.model.speaker_encoder.c_in)).astype(np.float32)
    ).to(device)
    starts = torch.from_numpy(rng.integers(0, a["n_frames"] - seg, size=20_000)).to(device)
    model = AE(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(a["seed"]))
    model.to(device)
    opt = make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)
    mstep = make_device_data_train_step(cfg, model, opt, inner_steps=cfg.inner_steps, mesh=mesh)
    ms = mstep(packed, starts, a["seed"] + 1, 0).cpu()  # warm-up
    t0 = time.perf_counter()
    for i in range(a["chunks"]):
        ms = mstep(packed, starts, a["seed"] + 1, (i + 1) * cfg.inner_steps).cpu()
    dt = (time.perf_counter() - t0) / (a["chunks"] * cfg.inner_steps)
    return {"s_per_step": dt, "last": ms[-1].tolist()}


def scaling_sweep(
    cfg: TrainConfig,
    sizes: Sequence[int],
    n_frames: int = 40_000,
    chunks: int = 5,
    seed: int = 0,
    device: DeviceLike = None,
) -> List[dict]:
    """One row per width ``n`` of ``sizes`` (in order, up to the first the
    host cannot hold): the global batch, audio-s/s (the slowest rank's
    time per step) and, with one GPU per rank, ``efficiency_vs_linear``
    against the first row."""
    dev = resolve_device(device)
    results, base = [], None
    for n in sizes:
        if dev.type == "cuda" and n > torch.cuda.device_count():
            break
        scfg = dataclasses.replace(cfg, data_loader=dataclasses.replace(
            cfg.data_loader, batch_size=cfg.data_loader.batch_size * n))
        outs = run_ranks(f"{__name__}:_sweep_rank", n, dev.type, None,
                         {"cfg": scfg, "n": n, "n_frames": n_frames, "chunks": chunks, "seed": seed})
        dt = max(o["s_per_step"] for o in outs)
        audio_s = (scfg.data_loader.batch_size * scfg.data_loader.segment_size
                   * scfg.signal.hop_length / scfg.signal.sr)
        thr = audio_s / dt
        if base is None:
            base = thr
        row = {"devices": n, "global_batch": scfg.data_loader.batch_size,
               "audio_s_per_s": round(thr, 1)}
        # ranks on the CPU share its cores: the time measures that sharing
        if dev.type == "cpu":
            row["validation_only"] = True
        else:
            row["efficiency_vs_linear"] = round(thr / (base * n), 3)
        results.append(row)
    return results


def tiny_config(cfg: TrainConfig) -> TrainConfig:
    """The JAX CLI's ``--tiny`` model and batch."""
    from ..core.config import (
        AEConfig,
        ContentEncoderConfig,
        DataLoaderConfig,
        DecoderConfig,
        SpeakerEncoderConfig,
    )

    return dataclasses.replace(
        cfg,
        model=AEConfig(
            speaker_encoder=SpeakerEncoderConfig(
                c_in=16, c_h=16, c_out=16, kernel_size=5, bank_size=4,
                bank_scale=1, c_bank=8, n_conv_blocks=2,
                n_dense_blocks=1, subsample=(1, 2),
            ),
            content_encoder=ContentEncoderConfig(
                c_in=16, c_h=16, c_out=16, kernel_size=5, bank_size=4,
                bank_scale=1, c_bank=8, n_conv_blocks=2, subsample=(1, 2),
            ),
            decoder=DecoderConfig(
                c_in=16, c_cond=16, c_h=16, c_out=16, kernel_size=5,
                n_conv_blocks=2, upsample=(2, 1),
            ),
        ),
        data_loader=DataLoaderConfig(segment_size=32, batch_size=16),
        inner_steps=4,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="1,2,4,8")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="reduced model and batch, for validating the program on the CPU")
    p.add_argument("--out", default=None, help="also write a JSON artifact")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = TrainConfig()
    if args.bf16:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    if args.tiny:
        cfg = tiny_config(cfg)
    sizes = [int(s) for s in args.sizes.split(",")]
    dev = resolve_device(args.device)
    rows = scaling_sweep(cfg, sizes, device=dev)
    for row in rows:
        print(json.dumps(row))
    if len(rows) < len(sizes):
        print(f"stopped at {sizes[len(rows)]} ranks: this host has "
              f"{torch.cuda.device_count()} GPU(s), one per rank")
    if args.out:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        artifact = {
            "backend": "nccl" if dev.type == "cuda" else "gloo",
            "n_devices": n_dev,
            "virtual_devices": dev.type == "cpu",
            "tiny_config": bool(args.tiny),
            "note": (
                "weak-scaling sweep; on the CPU this validates the data-parallel "
                "program at each width — efficiency numbers need one GPU per rank"
            ),
            "rows": rows,
        }
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)


if __name__ == "__main__":
    main()
