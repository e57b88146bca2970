"""The data-parallel layout (counterpart of ``pbrl_tpu/parallel/mesh.py``).

pbrl_tpu builds a 1-D ``jax.sharding.Mesh`` over every device, shards the
env batch on its ``data`` axis and replicates the learner; XLA inserts the
collectives. Here a :class:`Mesh` is one process's place in the run: the
number of ranks, this rank, its device and the process group. Rank ``r``
of ``n`` holds the contiguous rows ``[r*B/n, (r+1)*B/n)`` of every batch
of ``B`` envs (:func:`shard_batch`), as a ``P("data")`` sharding lays
them out. The learner is replicated by construction: every rank seeds the
same generator and applies the same all-reduced gradient, so pbrl_tpu's
``replicated`` and ``sharded_batch_spec`` have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from pbrl_tpu_torch.parallel import distributed
from pbrl_tpu_torch.utils.tree import map_states

DATA_AXIS = "data"  # pbrl_tpu's name of the mesh axis the env batch is split on


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``world`` ranks along :data:`DATA_AXIS`, this process ``rank``, its
    ``device``; ``group`` is the process group of the collectives (None
    with one rank)."""

    world: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[object] = None

    def local(self, batch: int) -> int:
        """Rows of a ``batch``-env batch on each rank."""
        if batch % self.world:
            raise ValueError(f"num_envs {batch} not divisible by {self.world} devices")
        return batch // self.world

    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``x``, whose axis ``dim`` is the whole batch."""
        if self.world == 1:
            return x
        n = self.local(x.shape[dim])
        return x.narrow(dim, self.rank * n, n)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over the ranks, in place (a no-op with one rank)."""
        if self.world > 1:
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch of which ``x`` holds this rank's rows: each rank
        writes its rows into zeros and the ranks sum them, exactly."""
        if self.world == 1:
            return x
        n = x.shape[0]
        out = torch.zeros((n * self.world,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[self.rank * n:(self.rank + 1) * n] = x
        return self.all_reduce(out)


SINGLE = Mesh()


def make_mesh(device="cuda") -> Mesh:
    """This process's mesh: the group's size and rank (one rank with no
    group), and its device: the CPU when ``device`` is the CPU, else the
    card ``LOCAL_RANK`` (modulo the host's cards, which processes then
    share)."""
    world, rank = distributed.process_count(), distributed.process_index()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", distributed.local_rank() % max(torch.cuda.device_count(), 1))
    return Mesh(world=world, rank=rank, device=device,
                group=dist.group.WORLD if world > 1 else None)


def mesh_of(env) -> Mesh:
    """The mesh an env was built on (one rank for an env built without)."""
    return getattr(env, "mesh", None) or SINGLE


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a batched tree (a tensor, or a dataclass or dict
    of them, nested)."""
    return map_states(mesh.rows, tree)
