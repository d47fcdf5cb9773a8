"""The rank mesh: one process per GPU, launched by ``torchrun``.

The JAX package runs one process with many devices and lets GSPMD place the
work on a ``(data, model)`` device mesh. The port runs one process per
device instead, and a rank is one device: the mesh ``(n_data, n_model)`` is
a grid of ranks, rank ``r`` at data index ``r // n_model`` and model index
``r % n_model`` (the order of the JAX ``make_mesh``'s
``reshape(n_data, n_model)``). Each data index holds a contiguous block of
rows of every global batch, and every rank of one data index (one model
group) holds the same rows. The gradients are averaged over the data axis
by one all-reduce a step (train/step.py), within each data group: the ranks
that share a model index. Along the model axis the parameters are either
replicated or, after ``parallel/tp.py``'s ``shard_params_tp``, split over
the model group's ranks (tensor parallelism).

The collectives go through the helpers at the end of this module, on
``Mesh.comm_device``: the rank's GPU under NCCL, the CPU under gloo. So two
gloo ranks that share one GPU stage their tensors through the host, and
nothing relies on gloo's CUDA support.

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for
``cpu``. A process group that fails to start raises; nothing falls back to
another backend or to one process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the grid of ranks."""

    n_data: int
    n_model: int
    rank: int
    world_size: int
    group: Any  # the data axis's process group: this rank's data group
    comm_device: torch.device  # where the collectives run
    model_group: Any = None  # this rank's model group (n_model > 1)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def init_multihost(
    device: DeviceLike = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> str:
    """Start the process group of a multi-process run; returns its backend.

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``); the arguments override it (the tests
    give a ``file://`` ``init_method``). ``backend`` defaults to ``nccl``
    when ``device`` (default ``cuda``) is a GPU and ``gloo`` on the CPU; on
    a GPU the rank's device, ``cuda:LOCAL_RANK`` unless ``device`` names
    one, becomes the current device. Calling it again is a no-op, as with
    the JAX function; a group that cannot start raises.
    """
    if dist.is_initialized():
        return dist.get_backend()
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    env = {k: os.environ.get(k) for k in ("MASTER_PORT", "WORLD_SIZE", "RANK")}
    missing = [k for k, v in env.items() if v is None]
    if missing and (init_method is None or world_size is None or rank is None):
        raise RuntimeError(
            f"init_multihost: {', '.join(missing)} not set; start the processes "
            "with torchrun, or pass init_method, world_size and rank"
        )
    if init_method is None:
        init_method = f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=int(env["WORLD_SIZE"]) if world_size is None else world_size,
        rank=int(env["RANK"]) if rank is None else rank,
    )
    return backend


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``(n_data, n_model)`` grid over the started process group.

    Raises unless ``n_data * n_model`` is the world size. With ``n_model``
    > 1 every rank creates, in the same order, one data group per model
    index (the ranks that share it: ``Mesh.group``) and one model group per
    data index (``Mesh.model_group``); with ``n_model`` 1 the data group is
    the world."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_multihost first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover {world} ranks")
    rank = dist.get_rank()
    comm = (
        torch.device("cuda", torch.cuda.current_device())
        if dist.get_backend() == "nccl" else torch.device("cpu")
    )
    if n_model == 1:
        return Mesh(n_data, 1, rank, world, dist.group.WORLD, comm)
    # dist.new_group is collective: every rank creates every group
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    return Mesh(n_data, n_model, rank, world, data_groups[rank % n_model], comm,
                model_groups[rank // n_model])


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    """This rank's share of the global batch."""
    if global_batch_size % mesh.n_data:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by data axis {mesh.n_data}"
        )
    return global_batch_size // mesh.n_data


def shard_rows_for_process(mesh: Mesh) -> int:
    """The index along the data axis whose rows this rank owns."""
    return mesh.data_index


def row_window(mesh: Mesh, local_rows: int) -> tuple:
    """``(lo, hi, global_rows)``: where this rank's ``local_rows`` rows sit
    in the global batch."""
    lo = mesh.data_index * local_rows
    return lo, lo + local_rows, local_rows * mesh.n_data


def put_global_from_full(full, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous row block of an array every rank holds in
    full (numpy or a tensor), on the array's device."""
    t = torch.as_tensor(full)
    b = local_batch_size(t.shape[0], mesh)
    lo = mesh.data_index * b
    return t[lo : lo + b]


_BYTES = (torch.bfloat16, torch.float16, torch.uint16, torch.int16)


def _as_wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of a 16-bit type as its bytes (uint8, the last
    axis doubled), a dtype gloo's collectives take (they refuse int16);
    others as they are."""
    return t.view(torch.uint8) if t.dtype in _BYTES else t


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate_pytree(tree, mesh: Mesh):
    """Broadcast every tensor of a nested dict / list / tuple (a model's
    ``state_dict()``, an optimiser's ``state``) from rank 0 to every rank of
    the mesh, in place, so that every rank starts from rank 0's values.
    Returns ``tree``."""
    for t in _tensors(tree):
        flat = t.detach().view(-1)  # state tensors are contiguous
        buf = _as_wire(flat).to(mesh.comm_device)
        dist.broadcast(buf, src=0)
        _as_wire(flat).copy_(buf)
    return tree


def all_reduce_mean(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis of one flat buffer, on ``flat``'s
    device. ``flat`` is reduced in place when it already lies on
    ``comm_device``."""
    buf = flat.to(mesh.comm_device)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.div_(mesh.n_data).to(flat.device)


def all_reduce_max(mesh: Mesh, value: int) -> int:
    """The largest of every rank's host integer."""
    buf = torch.tensor([int(value)], dtype=torch.int64, device=mesh.comm_device)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(buf.item())


def all_gather_rows(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """Every rank's equal-shaped row block, concatenated in data-index
    order along the first axis, on ``rows``' device."""
    buf = _as_wire(rows.contiguous()).to(mesh.comm_device)
    parts = [torch.empty_like(buf) for _ in range(mesh.n_data)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(rows.device).view(rows.dtype)


def barrier(mesh: Mesh) -> None:
    dist.barrier(group=mesh.group)

