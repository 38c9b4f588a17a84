"""The multi-process runtime (port of ``predictionio_tpu/parallel/distributed.py``).

The same CLI command runs once per rank; :func:`maybe_initialize_distributed`
joins them with ``torch.distributed.init_process_group`` at the
coordinator's address. Environment contract (set by :mod:`launcher`):

  PIO_COORDINATOR        host:port of rank 0
  PIO_NUM_PROCESSES      the number of ranks
  PIO_PROCESS_ID         this rank
  PIO_LOCAL_RANK         this rank's index among the ranks of its machine
                         (default: PIO_PROCESS_ID)
  PIO_LOCAL_WORLD_SIZE   the ranks on its machine (default: PIO_NUM_PROCESSES)

Absent coordinator: one process, and every call here is a no-op.

The backend is decided once, at init, and logged: NCCL when every rank of
a machine has a card of its own (local ranks no more than the visible
cards), gloo on the CPU or when local ranks outnumber the cards (two ranks
sharing one card). A rank's device is ``cuda:(local_rank % device_count)``.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """What the process joined: its backend ("" alone), rank and device."""

    backend: str
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    device: torch.device


_runtime: Runtime | None = None


def choose_backend(device: torch.device, local_world_size: int) -> str:
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Join the job when the environment contract is present; returns True
    when running as one of several ranks. ``device`` is the entry point's
    ("cuda" or "cpu"): on CUDA the rank takes its own card index."""
    global _runtime
    if _runtime is not None:
        return _runtime.world_size > 1
    coordinator = os.environ.get("PIO_COORDINATOR")
    if not coordinator:
        return False
    world = int(os.environ.get("PIO_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("PIO_PROCESS_ID", "0"))
    local_rank = int(os.environ.get("PIO_LOCAL_RANK", rank))
    local_world = int(os.environ.get("PIO_LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world, rank=rank
    )
    _runtime = Runtime(backend, rank, world, local_rank, local_world, dev)
    logger.info(
        "joined distributed job: rank %d/%d via %s, backend %s, device %s",
        rank, world, coordinator, backend, dev,
    )
    return world > 1


def runtime() -> Runtime | None:
    """The joined job, or None in a single process."""
    return _runtime


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: the joined job's, else ``device`` resolved."""
    return _runtime.device if _runtime is not None else resolve_device(device)


def process_info() -> dict:
    r = _runtime
    if r is None:
        return {"process_index": 0, "process_count": 1, "local_device_count": 1,
                "global_device_count": 1, "backend": ""}
    return {"process_index": r.rank, "process_count": r.world_size,
            "local_device_count": 1, "global_device_count": r.world_size,
            "backend": r.backend, "device": str(r.device)}


def is_coordinator() -> bool:
    return _runtime is None or _runtime.rank == 0


def shutdown() -> None:
    """Leave the job, on every rank together: a barrier, then the process
    group's teardown. A rank that exits with its group still up can abort
    in the group's destructor while another rank still works."""
    global _runtime
    if _runtime is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
        _runtime = None
