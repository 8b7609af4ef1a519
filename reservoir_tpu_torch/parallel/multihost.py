"""Multi-process scale-out: joining a ``torch.distributed`` process group.

The port of the JAX package's ``parallel/multihost.py``.  The reference
joins the JAX distributed runtime, after which its meshes span every
process's chips; the port joins a ``torch.distributed`` process group.  A
mesh that spans processes is not ported (ROADMAP.md, L4):
:func:`~.sharded.make_mesh` raises in a group of more than one process.

Typical use::

    from reservoir_tpu_torch.parallel import multihost
    multihost.initialize()     # False, with a RuntimeWarning, single-process
    devices = multihost.spread_devices(4)

The rules of :func:`initialize` are the reference's: already joined gives
True; explicit arguments join (through ``tcp://``) and let errors surface;
with none, a detected cluster environment (torchrun's ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR``, SLURM, Open MPI) joins through
``env://`` and re-raises a failure; with nothing detected it warns and
returns False.  The backend is ``"nccl"``, which needs a card, unless the
caller passes ``backend="gloo"``.  Every join is bounded by ``timeout``
seconds, so a rendezvous that cannot complete fails in seconds, not in
torch's default half hour.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import List, Optional

import torch

from ..convert import resolve_device

__all__ = ["initialize", "is_initialized", "spread_devices", "group_size"]

#: the reference's cluster markers (``multihost.py:52-60``), with torchrun's
_MARKERS = (
    "SLURM_JOB_ID",
    "OMPI_COMM_WORLD_SIZE",
    "TPU_WORKER_HOSTNAMES",
    "CLOUD_TPU_TASK_ID",
    "MEGASCALE_COORDINATOR_ADDRESS",
)
_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
#: where each launcher puts this process's rank and the group's size
_RANK_ENV = (("RANK", "WORLD_SIZE"), ("SLURM_PROCID", "SLURM_NTASKS"),
             ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"))


def _cluster_env_detected() -> bool:
    """Whether a launcher's environment is present (torchrun, SLURM, Open
    MPI or the reference's other markers)."""
    return all(v in os.environ for v in _TORCHRUN) or any(m in os.environ for m in _MARKERS)


def spread_devices(n: int) -> List[torch.device]:
    """Deal this process's visible cards round robin over ``n`` slots:
    consecutive slots land on distinct cards when there are enough, and
    share fairly when there are not.  Raises without a card."""
    if n < 1:
        raise ValueError(f"spread_devices: n must be >= 1, got {n}")
    resolve_device(None)
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(int(n))]


def is_initialized() -> bool:
    """Whether this process has joined a ``torch.distributed`` group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def group_size() -> int:
    """The number of processes in this process's group (1 when it has
    joined none)."""
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def _check_backend(backend: str) -> None:
    import torch.distributed as dist

    if backend == "nccl" and not (dist.is_nccl_available() and torch.cuda.is_available()):
        raise RuntimeError(
            "backend 'nccl' needs a CUDA card and a torch built with NCCL; pass "
            "backend='gloo' to join on the CPU"
        )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
    timeout: float = 30.0,
    **kwargs,
) -> bool:
    """Join the process group; safe to call unconditionally.

    - already joined -> True (never joins twice);
    - explicit ``coordinator_address`` (``host:port``), ``num_processes``
      and ``process_id`` -> joins through ``tcp://`` (errors surface: the
      caller meant it; a partial set raises ``ValueError``);
    - no arguments -> a detected launcher environment joins through
      ``env://`` (a failure is re-raised: degrading to one process would
      hand back per-process results); nothing detected warns
      ``RuntimeWarning`` and returns False.

    ``timeout`` (seconds) bounds the rendezvous and every later collective
    of the group; extra ``kwargs`` pass through to
    ``torch.distributed.init_process_group``.
    """
    import torch.distributed as dist

    if is_initialized():
        return True
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    wait = datetime.timedelta(seconds=float(timeout))
    explicit = coordinator_address is not None or num_processes is not None or process_id is not None
    if explicit or kwargs:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "an explicit join needs coordinator_address, num_processes and process_id, got "
                f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
            )
        _check_backend(backend)
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
            rank=int(process_id), timeout=wait, **kwargs,
        )
        return True
    if not _cluster_env_detected():
        warnings.warn(
            "multihost.initialize(): no cluster environment detected; running single-process",
            RuntimeWarning,
            stacklevel=2,
        )
        return False
    _check_backend(backend)
    rank_world = {}
    for rank_var, world_var in _RANK_ENV:
        if rank_var in os.environ and world_var in os.environ:
            rank_world = {"rank": int(os.environ[rank_var]), "world_size": int(os.environ[world_var])}
            break
    dist.init_process_group(backend, init_method="env://", timeout=wait, **rank_world)
    return True
