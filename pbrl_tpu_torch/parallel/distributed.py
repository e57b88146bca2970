"""Multi-process initialisation (counterpart of
``pbrl_tpu/parallel/distributed.py``).

pbrl_tpu runs one SPMD program over every device of every host after
``jax.distributed.initialize``. The port runs one process per card, as
``torchrun`` starts them, joined in one ``torch.distributed`` process
group; the trainers (:mod:`pbrl_tpu_torch.train.ppo`,
:mod:`pbrl_tpu_torch.train.apg`) compute pbrl_tpu's global step across
the ranks, and only the primary process writes checkpoints and progress.

Which collective backend a run uses is a fixed rule (:func:`backend_for`),
not something tried and then given up on: NCCL when every process of a
host has a card of its own, gloo when processes share a card or run on the
CPU (NCCL refuses two ranks on one device; gloo's ``all_reduce`` takes
CUDA tensors). A failure to join the group raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# a rank that never joins (or dies) fails the run after this long instead of hanging it
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Where the ranks meet. All ``None``: torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); else
    ``coordinator_address`` (host:port, served by process 0), the number of
    processes and this one's id."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    ``LOCAL_RANK``, else the process id (one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def local_world_size(num_processes: int) -> int:
    """The processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else
    all of them (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def backend_for(device, num_processes: int) -> str:
    """``nccl`` when every process on this host has a card of its own,
    ``gloo`` when processes share a card or run on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world_size(num_processes) <= torch.cuda.device_count() else "gloo"


def initialize_distributed(config: DistributedConfig = DistributedConfig(),
                           device="cuda", timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group of a ``device`` run; returns True if this
    call initialised it, False (and does nothing) when one already is, so
    library code may call it unconditionally. Joining, and every
    collective after it, raises after ``timeout``."""
    if is_initialized():
        return False
    if config.coordinator_address is None:
        world = int(os.environ["WORLD_SIZE"]) if config.num_processes is None \
            else config.num_processes
        rank = int(os.environ["RANK"]) if config.process_id is None else config.process_id
        init = "env://"
    else:
        if config.num_processes is None or config.process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        world, rank = config.num_processes, config.process_id
        init = f"tcp://{config.coordinator_address}"
    dist.init_process_group(backend_for(device, world), init_method=init, world_size=world,
                            rank=rank, timeout=timeout)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def is_primary_host() -> bool:
    """True on the process that owns the side effects (run config,
    checkpoints, progress lines); always True with no group."""
    return process_index() == 0


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The group's collective backend, None with no group."""
    return dist.get_backend() if is_initialized() else None
