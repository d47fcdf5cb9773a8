"""Entry points: a forward step of the full model, and a multi-rank dry run.

``entry`` is the port's counterpart of ``__graft_entry__.entry`` beside the
JAX package: the full ``TrainConfig()`` model on seeded weights and a
seeded batch. The port runs eagerly, so nothing is compiled or cached
ahead.

``dryrun_multichip(n)`` runs what the JAX package's dry run runs, on ``n``
ranks of this host (parallel/ranks.py): one tensor-parallel training step
at a reduced depth and one at the full depth on a ``(dp=n/2, tp=2)`` mesh
(pure data parallelism for odd ``n``), then two steps of the
``device_sharded`` multi-step (each rank drawing from its own shard of the
corpus) on an ``n``-rank data-parallel mesh. On GPUs NCCL puts one rank on
each GPU; ``backend="gloo"`` lets the ranks share the host's GPUs, staging
their collectives through the host. Nothing picks gloo on its own.

Run:  python -m adaptive_voice_conversion_tpu_torch.entry
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core.config import TrainConfig
from .core.device import DeviceLike, resolve_device
from .models.ae import AE
from .models.modules import init_parameters


def _seeded_model(cfg, seed: int, device) -> AE:
    model = AE(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def _batch(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def entry(device: DeviceLike = None):
    """``(fn, (model, x, generator))``: ``fn(model, x, generator)`` is the
    training forward of the full model on x (8, 128, 512), its VAE draw
    from ``generator``, and returns the decoder's output."""
    dev = resolve_device(device)
    cfg = TrainConfig()
    model = _seeded_model(cfg.model, 0, dev)
    x = _batch(0, (8, 128, 512)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(1)

    def fn(model, x, generator):
        return model(x, generator=generator)[3]

    return fn, (model, x, generator)


def reduced_depth(base: TrainConfig) -> TrainConfig:
    """The JAX dry run's reduced depth: every structural feature of the
    model (conv bank, instance norm, AdaIN, pixel-shuffle upsampling,
    subsampled residual blocks, dense blocks) at full width."""
    m = base.model
    return dataclasses.replace(base, model=dataclasses.replace(
        m,
        speaker_encoder=dataclasses.replace(
            m.speaker_encoder, bank_size=4, n_conv_blocks=2, n_dense_blocks=2, subsample=(1, 2)),
        content_encoder=dataclasses.replace(
            m.content_encoder, bank_size=4, n_conv_blocks=2, subsample=(1, 2)),
        decoder=dataclasses.replace(m.decoder, n_conv_blocks=2, upsample=(2, 1)),
    ))


def _tp_step(cfg: TrainConfig, mesh, device, x_full: np.ndarray, seed: int) -> dict:
    """One step of the seeded model on ``mesh``: split over its model axis,
    this rank's rows of ``x_full``, the draws from a generator seeded
    ``seed``."""
    from .core.mesh import put_global_from_full
    from .parallel.tp import make_tp_train_step, shard_params_tp
    from .train.optim import make_optimizer

    model = shard_params_tp(_seeded_model(cfg.model, 0, device), mesh)
    opt = make_optimizer(cfg.optimizer, model.parameters(), state_dtype=cfg.opt_state_dtype)
    step = make_tp_train_step(cfg, model, opt, mesh)
    x = put_global_from_full(torch.from_numpy(x_full), mesh).to(device)
    m = step(x, 0.5, generator=torch.Generator(device=device).manual_seed(seed))
    m = {k: float(v) for k, v in m.items()}
    if not np.isfinite(m["loss"]):
        raise RuntimeError(f"dryrun_multichip: the step's loss is not finite: {m}")
    return m


def _dryrun_rank(device: torch.device, _args) -> dict:
    from .core.mesh import make_mesh
    from .train.optim import make_optimizer
    from .train.step import make_device_data_train_step

    n = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    n_model = 2 if (n % 2 == 0 and n > 1) else 1
    mesh = make_mesh(n_data=n // n_model, n_model=n_model)
    base = TrainConfig()
    tiny = _tp_step(reduced_depth(base), mesh, device, _batch(0, (n, 64, 512)).numpy(), 1)
    full = _tp_step(base, mesh, device, _batch(1, (n, 128, 512)).numpy(), 2)

    # the production data path at full depth: each rank's own shard of a
    # packed corpus, two fused steps drawing from it
    dp_mesh = make_mesh(n_data=n, n_model=1)
    seg = base.data_loader.segment_size
    ds_cfg = dataclasses.replace(base, inner_steps=2, data_loader=dataclasses.replace(
        base.data_loader, batch_size=n))
    r_rows, n_starts = 4 * seg, 16
    rng = np.random.default_rng(2)
    packed = rng.standard_normal((n, r_rows, 512)).astype(np.float32)
    starts = rng.integers(0, r_rows - seg, size=(n, n_starts))
    model = _seeded_model(base.model, 0, device)
    opt = make_optimizer(base.optimizer, model.parameters(), state_dtype=base.opt_state_dtype)
    multi = make_device_data_train_step(ds_cfg, model, opt, inner_steps=2, sharded_data=True,
                                        mesh=dp_mesh)
    ms = multi(torch.from_numpy(packed[rank]).to(device),
               torch.from_numpy(starts[rank]).to(device), 3, 0).cpu().numpy()
    if ms.shape[0] != 2 or not np.isfinite(ms).all():
        raise RuntimeError(f"dryrun_multichip: the sharded multi-step returned {ms}")
    return {"mesh": (mesh.n_data, mesh.n_model), "tiny": tiny, "full": full, "multi": ms}


def dryrun_multichip(n_devices: int, device: DeviceLike = None, backend: Optional[str] = None) -> dict:
    """Run the dry run on ``n_devices`` ranks (module docstring), print its
    line and return rank 0's results. On ``cuda`` without ``backend="gloo"``
    it needs ``n_devices`` GPUs and raises, naming the shortfall, on a host
    with fewer."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and backend != "gloo":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): NCCL runs one rank per GPU and needs "
                f"{n_devices} GPUs; this host has {have}. backend='gloo' runs the "
                f"{n_devices} ranks sharing the host's GPUs"
            )
    dev = resolve_device(dev)
    from .parallel.ranks import run_ranks

    out = run_ranks(f"{__name__}:_dryrun_rank", n_devices, dev.type, backend)[0]
    (dp, tp), full = out["mesh"], out["full"]
    print(
        f"dryrun_multichip({n_devices}): mesh=(dp={dp},tp={tp}) tiny loss={out['tiny']['loss']:.4f} "
        f"| full-config executed: loss={full['loss']:.4f} grad_norm={full['grad_norm']:.4f} "
        f"| full-config sharded-data multi-step executed: loss={out['multi'][-1][0]:.4f} "
        f"(dp{n_devices})",
        flush=True,
    )
    return out


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry:", tuple(out.shape), out.dtype)
