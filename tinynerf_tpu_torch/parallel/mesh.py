"""Data-parallel process group and its collectives.

Counterpart of `tinynerf_tpu/parallel/mesh.py`.  The JAX package runs one
process over a 1-D mesh of devices and reduces inside `shard_map` bodies;
PyTorch's idiom is one process per device in a `torch.distributed` group.
A `DataGroup` names this process's rank, the world size, its device and the
group, and carries the only collectives of the port (every other module
calls these, so the math around them is testable in one process):
`all_reduce_sum` (the JAX `psum`), `reduce_scatter_sum` (`psum_scatter`,
tiled over dim 0), `all_gather` (`all_gather`, tiled over dim 0),
`broadcast_object` and `barrier`.  A group without a process group
(`pg=None`: one rank, nothing initialized) makes each an identity.

Ray arrays are sharded as the JAX package shards them over the mesh: the
pool is padded to a multiple of the world size by repeating its head
(`tinynerf_tpu/train/loop.py:_pad_pool`) and each rank keeps its contiguous
1/N on its device (`shard_rays`).

The backend is NCCL for CUDA devices and gloo for the CPU.  Two ranks on one
card (the smoke's only way to run two ranks on a one-card machine) need
gloo on CUDA tensors, a host transport: torch 2.11's gloo takes every
collective used here on CUDA tensors (probed on an H100: all-reduce,
reduce-scatter, all-gather, broadcast, barrier), so none is staged through
a host copy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataGroup:
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None  # "nccl" or "gloo"; None without a group
    pg: Any = None  # the torch.distributed process group, or None

    @property
    def grouped(self) -> bool:
        """True when collectives go through a process group (any size)."""
        return self.pg is not None

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over ranks, in place (in a contiguous copy of a
        `t` that is not contiguous); returns it."""
        if self.pg is not None:
            t = t.contiguous()
            dist.all_reduce(t, group=self.pg)
        return t

    def reduce_scatter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Rows [rank * n / world, (rank + 1) * n / world) of the sum of `t`
        [n, ...] over ranks (n must divide)."""
        if self.pg is None:
            return t
        if t.shape[0] % self.world:
            raise ValueError(f"{t.shape[0]} rows do not split over {self.world} ranks")
        out = t.new_empty((t.shape[0] // self.world,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.pg)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` [m, ...] stacked in rank order: [world * m, ...]."""
        if self.pg is None:
            return t
        out = t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.pg)
        return out

    def broadcast_object(self, obj):
        """Rank 0's `obj` (any picklable value) on every rank."""
        if self.pg is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.pg)
        return box[0]

    def barrier(self) -> None:
        if self.pg is not None:
            dist.barrier(group=self.pg)


def single(device="cuda") -> DataGroup:
    """One rank, no process group: every collective is an identity."""
    return DataGroup(rank=0, world=1, device=torch.device(device))


def wrap_default_group(device) -> DataGroup:
    """The initialized default process group, with this rank's device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return DataGroup(rank=dist.get_rank(), world=dist.get_world_size(), device=device,
                     backend=str(dist.get_backend()), pg=dist.group.WORLD)


def make_group(device: Optional[str] = None) -> DataGroup:
    """This process's data-parallel group, from the variables `torchrun` sets
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

    Without them (world size 1) and with no group initialized it is
    `single(device)`: today's one-device run.  Otherwise the default process
    group is initialized if it is not yet (NCCL on CUDA, gloo on the CPU);
    the device is `device` when it names an index or the CPU, else
    cuda:LOCAL_RANK."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world <= 1:
        return single(device or "cuda")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=world)
    return wrap_default_group(dev)


def pad_rows(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """`t` padded to a multiple of `multiple` rows by repeating its head."""
    pad = (-t.shape[0]) % multiple
    return torch.cat([t, t[:pad]]) if pad else t


def shard_rays(group: DataGroup, *arrays: torch.Tensor):
    """This rank's contiguous 1/N of each ray array (padded to a multiple of
    N by repeating its head), on the group's device."""
    out = []
    for a in arrays:
        a = pad_rows(a, group.world)
        n = a.shape[0] // group.world
        out.append(a[group.rank * n : (group.rank + 1) * n].to(group.device).contiguous())
    return tuple(out) if len(out) > 1 else out[0]
