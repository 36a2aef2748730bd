"""Several processes, one mesh: torch.distributed for the port.

Counterpart of aniso_tpu/parallel/distributed.py (jax.distributed).  After
init(), each process holds the shards of the mesh that name its rank
(parallel.api.make_mesh), on its own device: NCCL between cards, gloo
between CPU processes.  Halo slabs between shards of different ranks travel
by P2P (batch_isend_irecv), gathered levels by all_gather, and GMRES's sums
by all_reduce (parallel.halo); the kernels only ever read local memory.

Driven from the CLI: `python -m aniso_torch run data.cfg --distributed
[--coordinator host:port --num-processes N --process-id K]`.  Without a
coordinator (argument or ANISO_COORDINATOR), torch's own environment is
read (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import log


def init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """torch.distributed.init_process_group across processes.

    coordinator "host:port" (rank 0 listens there); values may also come
    from ANISO_COORDINATOR, ANISO_NUM_PROCESSES, ANISO_PROCESS_ID.  backend:
    "nccl" unless the caller names another; under NCCL each process takes
    the card local_device() names, and without CUDA it raises before any
    group forms: a group on the CPU is asked for by name (backend="gloo",
    the CLI's --device cpu).  timeout: seconds for the rendezvous and each
    collective (torch's default when None).
    """
    coordinator = coordinator or os.environ.get("ANISO_COORDINATOR")
    if num_processes is None and "ANISO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ANISO_NUM_PROCESSES"])
    if process_id is None and "ANISO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ANISO_PROCESS_ID"])
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "distributed.init: NCCL needs CUDA, which is not available; "
            "for a process group on the CPU pass backend=\"gloo\" (the "
            "CLI's --device cpu)")
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    init_method = f"tcp://{coordinator}" if coordinator else "env://"
    if backend == "nccl":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, **kw)
    log.info(
        f"torch.distributed up ({backend}): process {process_index()}/"
        f"{process_count()}, device {local_device()}"
    )


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def local_device() -> torch.device:
    """This process's device in a process group: its card under NCCL, the
    CPU under gloo."""
    if is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
