"""Data parallelism on torch.distributed (counterpart of
tpu_breath/parallel/mesh.py).

One process per device, one rank per process: the JAX package's 1-D
("data",) mesh becomes the default process group. Parameters and optimizer
state are replicated on every rank; each rank computes its rows of the
global batch, and the collectives below make the step compute what the
single process computes over the whole batch (BatchNorm statistics and
gradients reduced over the ranks, augmentation partners gathered).

The launcher (torchrun, or any process that sets the same variables) gives
each process RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR
and MASTER_PORT. Rank r runs on cuda:(LOCAL_RANK % device_count), or on the
CPU when the caller asks for it. The backend is NCCL when every local rank
has a card of its own, and gloo for CPU ranks and for ranks that share a
card (NCCL refuses two ranks on one card in a communicator); the mesh line
names the choice.

The backend decides how a mesh's programs run (replays). NCCL's
collectives can be captured into a CUDA graph, so on an NCCL mesh fit's
streamed step and an evaluation batch replay as graphs, collectives
included, and precompute queues its chunk replays and gathers with one
host wait. Gloo's cannot (a CUDA tensor goes through a host copy), so a
gloo mesh runs the same programs eagerly. Collectives outside the graphs
(describe, barrier, broadcast_object, the epoch means) are issued between
replays, in one order on every rank.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from tpu_breath_torch import graphs


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group."""
    rank: int
    world: int
    device: torch.device
    backend: str
    group: object = None  # the process group; None is the default one


def launcher_world() -> int:
    """WORLD_SIZE as the launcher set it, 1 without a launcher."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK % device_count), or the CPU
    when device is 'cpu'."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device) -> str:
    """nccl when every local rank has a card of its own, else gloo (CPU
    ranks, or ranks sharing a card)."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device="cuda") -> None:
    """Join the launcher's process group (env:// from RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT). A no-op when a group exists already or
    no launcher set WORLD_SIZE."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(choose_backend(dev), init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def make_mesh(device="cuda") -> Mesh:
    """The mesh of this process over every rank of the launcher's group
    (joined first if need be); raises without a launcher."""
    initialize_distributed(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with torchrun "
                           "or set RANK, WORLD_SIZE, MASTER_ADDR and "
                           "MASTER_PORT")
    dev = rank_device(device)
    return Mesh(dist.get_rank(), dist.get_world_size(), dev,
                dist.get_backend())


def describe(mesh: Mesh) -> str:
    """'data-parallel mesh: N ranks, backend, devices' (a collective: every
    rank must call it)."""
    devices = [None] * mesh.world
    dist.all_gather_object(devices, str(mesh.device), group=mesh.group)
    return (f"data-parallel mesh: {mesh.world} ranks, {mesh.backend}, "
            f"devices {devices}")


def replays(mesh: Mesh) -> bool:
    """Whether this mesh's programs replay as CUDA graphs: the backend is
    NCCL (a gloo collective cannot be captured), the device is a card and
    the call is outside graphs.eager()."""
    return mesh.backend == "nccl" and graphs.replays(mesh.device)


def is_primary(mesh: Mesh | None) -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return mesh is None or mesh.rank == 0


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    # gloo's CUDA support differs by collective (all_gather has none)
    return mesh.backend == "gloo" and t.device.type == "cuda"


def all_reduce_sum_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t <- the sum of t over the ranks, in place; every rank gets the same
    bits. On a gloo mesh a CUDA tensor is reduced through a host copy."""
    if _staged(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, group=mesh.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_mean_(mesh: Mesh, tensors: list[torch.Tensor]) -> None:
    """Each tensor <- its mean over the ranks, in place, by one all-reduce
    of their concatenation (one collective however many tensors)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum_(mesh, flat).div_(mesh.world)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def all_gather_into(mesh: Mesh, out: torch.Tensor, t: torch.Tensor
                    ) -> torch.Tensor:
    """out <- the ranks' t concatenated along dim 0, rank 0's rows first,
    out [world * t.shape[0], ...] given; on an NCCL mesh (one collective
    on the current stream, no host wait, capturable)."""
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
    return out


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors of one shape concatenated along dim 0, rank 0's
    rows first (the global batch from the local ones). On an NCCL mesh one
    gather into a new tensor (all_gather_into); on a gloo mesh a CUDA
    tensor is gathered through a host copy."""
    if mesh.backend == "nccl":
        return all_gather_into(mesh, t.new_empty(
            (mesh.world * t.shape[0],) + tuple(t.shape[1:])), t)
    src = t.cpu() if _staged(mesh, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Rank src's picklable obj on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.group)
    return box[0]


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (no-op without a mesh)."""
    if mesh is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)
