"""Ranks of the port's multi-process CPU tests (gloo), and their spawner.

The tests in tests/test_torch_dist_*.py write a case's inputs with
``torch.save`` to ``<work_dir>/in_<case>.pt`` and start a ``RankGroup`` (or
call ``run_ranks``), one process per rank:

    python tests/torch_dist_worker.py <case> <rank> <world> <init_method> <work_dir>

Each rank joins a gloo process group through a ``file://`` init method
under the test's temporary directory (no port can race), runs the case and
writes what it saw to ``<work_dir>/out_<case>_<rank>.pt`` (a case run
twice, at two world sizes, is read between the runs); the test holds
the ranks' outputs against the JAX package and against one process of the
port. A spec with ``n_model`` runs the case on a ``(world / n_model,
n_model)`` mesh with the model split over its model axis
(parallel/tp.py). This module imports no JAX, so the ranks run the port as
a torch-only host would.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


class RankGroup:
    """``world`` rank processes of one case, started at construction."""

    def __init__(self, case: str, work_dir: Path, world: int = 2):
        self.case, self.work_dir, self.world = case, Path(work_dir), world
        n = len(list(self.work_dir.glob(f"rendezvous_{case}_*")))
        init = f"file://{self.work_dir / f'rendezvous_{case}_{n}'}"
        env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{HERE}", OMP_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen(
                [sys.executable, str(HERE / "torch_dist_worker.py"), case, str(r), str(world),
                 init, str(self.work_dir)],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]

    def results(self, timeout: int = 240) -> list:
        """Each rank's output dict, in rank order. A rank that fails fails
        the test with its output; none is left running."""
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            assert p.returncode == 0, f"rank {r} of {self.case!r} exited {p.returncode}:\n{log[-4000:]}"
        return [torch.load(self.work_dir / f"out_{self.case}_{r}.pt", weights_only=False)
                for r in range(self.world)]


def run_ranks(case: str, work_dir: Path, world: int = 2, timeout: int = 240) -> list:
    """Run ``case`` on ``world`` gloo ranks and return their outputs."""
    return RankGroup(case, work_dir, world).results(timeout)


# -- the cases ------------------------------------------------------------------


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _split(model, mesh):
    """The model split over the mesh's model axis (a no-op at n_model 1)."""
    from adaptive_voice_conversion_tpu_torch.parallel.tp import shard_params_tp

    return shard_params_tp(model, mesh)


def _whole(model, mesh) -> dict:
    """Every parameter whole (gathered over the model axis), and this
    rank's own tensors."""
    from adaptive_voice_conversion_tpu_torch.parallel.tp import gather_params_tp

    return gather_params_tp(model, mesh), _params(model)


def case_mesh(spec, mesh, rank):
    """The mesh's layout and helpers, and what must raise."""
    from adaptive_voice_conversion_tpu_torch.core import mesh as m

    out = {
        "fields": (mesh.n_data, mesh.n_model, mesh.rank, mesh.world_size, mesh.data_index,
                   mesh.model_index, str(mesh.comm_device)),
        "again": m.init_multihost(device="cpu"),  # a no-op that names the backend
        "local_batch": m.local_batch_size(8, mesh),
        "rows": m.put_global_from_full(np.arange(8), mesh).tolist(),
        "window": m.row_window(mesh, 4),
        "max": m.all_reduce_max(mesh, 10 * rank + 3),
        "mean": m.all_reduce_mean(mesh, torch.full((3,), float(rank))).tolist(),
        "gathered": m.all_gather_rows(mesh, torch.full((2, 3), float(rank))).tolist(),
        "gathered_bf16": m.all_gather_rows(
            mesh, torch.full((1, 2), 1.5 + rank, dtype=torch.bfloat16)).float().tolist(),
        "errors": {},
    }
    replicated = {"w": torch.full((4,), float(rank)), "b": [torch.tensor([rank], dtype=torch.bfloat16)]}
    m.replicate_pytree(replicated, mesh)
    out["replicated"] = [replicated["w"].tolist(), replicated["b"][0].float().tolist()]
    for name, call in (
        ("uncovered", lambda: m.make_mesh(n_data=3)),
        ("n_model", lambda: m.make_mesh(n_data=2, n_model=2)),
        ("indivisible", lambda: m.local_batch_size(7, mesh)),
    ):
        try:
            call()
            out["errors"][name] = None
        except Exception as exc:  # recorded for the test to assert on
            out["errors"][name] = (type(exc).__name__, str(exc))
    return out


def case_step(spec, mesh, rank):
    """One data-parallel step per variant from given weights, this rank's
    rows of the global batch and of the given eps."""
    from adaptive_voice_conversion_tpu_torch.core.mesh import row_window
    from adaptive_voice_conversion_tpu_torch.models.ae import AE
    from adaptive_voice_conversion_tpu_torch.parallel.tp import gather_tp
    from adaptive_voice_conversion_tpu_torch.train.optim import make_optimizer
    from adaptive_voice_conversion_tpu_torch.train.step import make_train_step

    out = {}
    for v in spec["variants"]:
        cfg = v["cfg"]
        model = AE(cfg.model)
        model.load_state_dict(v["state_dict"], strict=True)
        _split(model, mesh)
        opt = make_optimizer(cfg.optimizer, model.parameters())
        step = make_train_step(cfg, model, opt, mesh)
        b = v["x"].shape[0] // mesh.n_data
        lo, hi, _ = row_window(mesh, b)
        m = step(torch.from_numpy(v["x"][lo:hi]), v["lam"], eps=torch.from_numpy(v["eps"][lo:hi]))
        params, local = _whole(model, mesh)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        out[v["name"]] = {
            "metrics": {k: float(x) for k, x in m.items()},
            "grads": grads,
            "grads_whole": gather_tp(model, grads),
            "params": params,
            "local": local,
        }
    return out


def case_draws(spec, mesh, rank):
    """Steps with every draw from the step generator (positions are given,
    eps and dropout drawn at the global shape), then the mesh eval step;
    the optimiser is the one the variant's config asks for (``opt_fused``
    included)."""
    from adaptive_voice_conversion_tpu_torch.core.mesh import row_window
    from adaptive_voice_conversion_tpu_torch.models.ae import AE
    from adaptive_voice_conversion_tpu_torch.models.modules import init_parameters
    from adaptive_voice_conversion_tpu_torch.train.optim import kl_lambda, make_train_optimizer
    from adaptive_voice_conversion_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
        step_seed,
    )

    out = {}
    for v in spec["variants"]:
        cfg = v["cfg"]
        model = AE(cfg.model)
        init_parameters(model, torch.Generator().manual_seed(v["seed"]))
        _split(model, mesh)
        opt = make_train_optimizer(cfg, model.parameters())
        step = make_train_step(cfg, model, opt, mesh)
        gen = torch.Generator()
        rows = []
        for it, x in enumerate(v["batches"]):
            lo, hi, _ = row_window(mesh, x.shape[0] // mesh.n_data)
            gen.manual_seed(step_seed(v["seed"], it))
            m = step(torch.from_numpy(x[lo:hi]), kl_lambda(it, 1.0, 4), generator=gen)
            rows.append([float(m[k]) for k in ("loss", "loss_rec", "loss_kl", "grad_norm")])
        x = v["eval_batch"]
        lo, hi, _ = row_window(mesh, x.shape[0] // mesh.n_data)
        ev = make_eval_step(cfg, model, mesh)(torch.from_numpy(x[lo:hi]), 0.5)
        params, local = _whole(model, mesh)
        out[v["name"]] = {
            "rows": rows,
            "eval": {k: float(t) for k, t in ev.items()},
            "params": params,
            "local": local,
        }
    return out


def _solver_args(spec, name, **kw):
    from adaptive_voice_conversion_tpu_torch.train.solver import SolverArgs

    work = Path(spec["work_dir"])
    base = dict(spec["args"], logdir=str(work / f"log_{name}"),
                store_model_path=str(work / name))
    base.update(kw)
    return SolverArgs(**base)


def _solver_out(solver, m) -> dict:
    out = {"data_mode": solver.data_mode, "metrics": m, "params": _params(solver.model)}
    if solver.chunked is not None:
        out["h2d_rows"], out["R"] = solver.chunked.last_h2d_rows, solver.chunked.R
    if solver.data_mode == "device_sharded":
        dd = solver.device_data
        out["shard"] = (dd.shard, dd.packed.clone(), dd.starts.clone(), dd.dropped_segments)
    return out


def case_solver(spec, mesh, rank):
    """The Solver for ``n_steps`` in each configuration of ``runs`` (one per
    input mode), then the first half of a device-mode run that ``resume``
    restarts."""
    from adaptive_voice_conversion_tpu_torch.data.dataset import SegmentDataset
    from adaptive_voice_conversion_tpu_torch.data.sharded import ShardedDeviceDataset
    from adaptive_voice_conversion_tpu_torch.train.solver import Solver

    out = {}
    for name, cfg in spec["runs"].items():
        solver = Solver(cfg, _solver_args(spec, name), device="cpu", mesh=mesh)
        out[name] = _solver_out(solver, solver.train(spec["n_steps"], log_every_print=False))
    a = spec["args"]
    ds = SegmentDataset(os.path.join(a["data_dir"], f"{a['train_set']}.pkl"),
                        os.path.join(a["data_dir"], a["train_index_file"]),
                        spec["runs"]["device"].data_loader.segment_size)
    bf16 = ShardedDeviceDataset(ds, mesh, torch.device("cpu"), dtype="bfloat16")
    out["shard_bf16"] = bf16.packed.view(torch.int16).clone()
    first = Solver(spec["runs"]["device"],
                   _solver_args(spec, "resume", save_steps=spec["n_steps"] // 2),
                   device="cpu", mesh=mesh)
    first.train(spec["n_steps"] // 2, log_every_print=False)
    return out


def case_resume(spec, mesh, rank):
    """The second half, in new processes, from the first half's checkpoint."""
    from adaptive_voice_conversion_tpu_torch.train.solver import Solver

    args = _solver_args(spec, "resumed", load_model=True,
                        load_model_path=str(Path(spec["work_dir"]) / "resume"))
    solver = Solver(spec["runs"]["device"], args, device="cpu", mesh=mesh)
    start = solver.iteration
    m = solver.train(spec["n_steps"] - start, log_every_print=False)
    return {"start": start, **_solver_out(solver, m)}


def case_serve(spec, mesh, rank):
    """convert_grid and convert_pairs over the mesh, every pair on every rank."""
    from adaptive_voice_conversion_tpu_torch.infer.inferencer import Inferencer
    from adaptive_voice_conversion_tpu_torch.models.ae import AE

    model = AE(spec["cfg"].model)
    model.load_state_dict(spec["state_dict"], strict=True)
    inf = Inferencer(spec["cfg"], model, spec["attr"], device="cpu", mesh=mesh)
    out = {}
    for method in ("exact", "fused", "pallas"):
        out[method] = inf.convert_grid(spec["srcs"], spec["tars"], gl_iters=2, gl_method=method,
                                       trim=False, return_mels=True)
    out["pairs"] = inf.convert_pairs(spec["pairs"], gl_iters=2, trim=False, return_mels=True)
    return out


def case_tp_ops(spec, mesh, rank):
    """Megatron's four operators forward and backward on this rank's inputs
    (rank r's of the spec's), a split of the spec's model and its
    gathered state_dict, and the mesh's errors."""
    from adaptive_voice_conversion_tpu_torch.core import mesh as m
    from adaptive_voice_conversion_tpu_torch.models.ae import AE
    from adaptive_voice_conversion_tpu_torch.parallel.tp import ModelAxis

    axis = ModelAxis(mesh)
    out = {"fields": (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index)}
    for op in ("copy", "reduce", "gather", "gather2", "scatter"):
        x = spec["x"][op][rank].clone().requires_grad_(True)
        y = axis.gather(x, 2) if op == "gather2" else getattr(axis, op)(x)
        (y * spec["w"][op][rank]).sum().backward()
        out[op] = (y.detach(), x.grad)
    model = AE(spec["cfg"].model)
    model.load_state_dict(spec["state_dict"])
    _split(model, mesh)
    params, local = _whole(model, mesh)
    out["gathered"], out["local"] = params, local
    out["errors"] = {}
    for name, call in (("uncovered", lambda: m.make_mesh(n_model=3)),
                       ("scatter", lambda: axis.scatter(torch.zeros(1, 3)))):
        try:
            call()
            out["errors"][name] = None
        except Exception as exc:  # recorded for the test to assert on
            out["errors"][name] = (type(exc).__name__, str(exc))
    return out


def case_bank_out(spec, mesh, rank):
    """``case_draws``, then an encoder split over the model axis given a
    ``bank_out``, which must raise."""
    from adaptive_voice_conversion_tpu_torch.models.ae import AE

    out = case_draws(spec, mesh, rank)
    m = spec["variants"][0]["cfg"].model.speaker_encoder
    enc = _split(AE(spec["variants"][0]["cfg"].model), mesh).speaker_encoder
    bank = torch.zeros(2, m.c_bank * len(enc.kernel_sizes) + m.c_in, 16)
    try:
        enc(torch.zeros(2, m.c_in, 16), bank_out=bank)
        out["bank_out_error"] = None
    except ValueError as exc:  # recorded for the test to assert on
        out["bank_out_error"] = str(exc)
    return out


CASES = {
    "mesh": case_mesh,
    "step": case_step,
    "draws": case_draws,
    "solver": case_solver,
    "resume": case_resume,
    "serve": case_serve,
    "tp_ops": case_tp_ops,
    "bank_out": case_bank_out,
}


def main() -> None:
    case, rank, world, init, work_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from adaptive_voice_conversion_tpu_torch.core.mesh import init_multihost, make_mesh

    init_multihost(device="cpu", init_method=init, world_size=world, rank=rank)
    try:
        spec = torch.load(Path(work_dir) / f"in_{case}.pt", weights_only=False)
        mesh = make_mesh(n_model=spec.get("n_model", 1))
        spec["work_dir"] = work_dir
        out = CASES[case](spec, mesh, rank)
        torch.save(out, Path(work_dir) / f"out_{case}_{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
