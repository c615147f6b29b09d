"""Multi-process data parallelism (counterpart of
``sdfa_tpu/parallel/multihost.py``).

One process per card joins a ``torch.distributed`` process group, either from
a launcher's environment (``python -m torch.distributed.run``: ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or from an explicit
coordinator address, count and id. Every process feeds its own rows of the
global batch (``parallel/mesh.py::shard_batch`` says which); the training step
reduces what the global batch needs (``parallel/mesh.py``).

Unlike the JAX function, ``maybe_initialize_distributed`` does not fall back
to a single-process run when a launcher environment is present and the group
cannot be joined: each rank would then train alone on its share of the batch,
a silently different result. It raises.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (or, without one named, when a card is visible),
    gloo for the CPU."""
    if device is not None:
        return "nccl" if torch.device(device).type == "cuda" else "gloo"
    return "nccl" if torch.cuda.is_available() else "gloo"


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group when launched across processes.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group starts at ``tcp://coordinator_address``; else
    from a launcher's environment (``env://``). Returns True when a group of
    more than one process is up, also one that the caller or the launcher
    started first; False when neither arguments nor a launcher environment are
    present. A failed init raises (see the module's docstring)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address, num_processes, process_id)
    kwargs: Dict[str, Any] = {}
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("coordinator_address, num_processes and process_id go together")
        kwargs = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                      rank=int(process_id))
    elif any(k in os.environ for k in LAUNCHER_ENV):
        kwargs = dict(init_method="env://")  # a missing variable raises in init
    else:
        return False
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(backend or default_backend(), **kwargs)
    log.info("process group: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
             dist.get_backend())
    return dist.get_world_size() > 1


def shutdown():
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_batch_from_local(batch: Dict[str, Any], device,
                            put: Optional[Callable[[Dict[str, Any], torch.device],
                                                   Dict[str, torch.Tensor]]] = None):
    """This rank's rows of the global batch onto its device. There is no
    global array object in torch: the batch stays the rank's rows, and the
    step reduces across ranks what the global batch needs. ``put`` is the
    upload (``Experiment.put_batch`` passes its pinned buffers); by default a
    plain copy."""
    device = torch.device(device)
    if put is None:
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    return put(batch, device)


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of the global batch (an even split is required)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not split over {n} processes")
    return global_batch_size // n
