"""Fleets of independent fits across processes (counterpart of
``isochrones_tpu/parallel/multihost.py``).

The reference's multi-node story is ``scripts/batch_starfit``: a SLURM job
array that shards a folder list across nodes with awk/xargs, embarrassingly
parallel, with no communication between the nodes. The same shape here: each
process owns a contiguous shard of the work list and runs its fits on its own
device. ``torch.distributed`` with the gloo backend only links the processes
into a fleet; its one collective is the end-of-fleet barrier, which waits on
the fleet's key-value store with an explicit timeout. A device mesh inside one
process is :mod:`isochrones_torch.parallel`.

The settings come from the explicit arguments first, then from the
``ISOCHRONES_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}`` variables, the
JAX package's, so that one launcher drives either package. The coordinator
address is ``host:port``; process 0 serves the fleet's store there.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

__all__ = [
    "initialize_distributed",
    "process_shard",
    "fleet_map",
]

#: the fleet's key-value store (a ``torch.distributed.TCPStore``), set by
#: :func:`initialize_distributed`
_STORE = None
#: barriers this process has entered: every process enters them in the same
#: order, so the count keys each barrier's entries in the store
_BARRIERS = 0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
):
    """Join this process to a fleet: a gloo process group over a TCP store
    that process 0 serves at ``coordinator_address``. Keywords go to
    ``torch.distributed.init_process_group`` (``timeout``, a
    ``datetime.timedelta``, bounds the setup).

    Returns ``(process_id, num_processes)``. With no coordinator and no
    process count set anywhere, or a fleet of one process, it returns
    ``(0, 1)`` without touching ``torch.distributed``; in a process already
    joined, the fleet's own rank and size.
    """
    import torch.distributed as dist

    global _STORE
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator_address = coordinator_address or os.getenv("ISOCHRONES_TPU_COORDINATOR")
    if num_processes is None and os.getenv("ISOCHRONES_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["ISOCHRONES_TPU_NUM_PROCESSES"])
    if process_id is None and os.getenv("ISOCHRONES_TPU_PROCESS_ID"):
        process_id = int(os.environ["ISOCHRONES_TPU_PROCESS_ID"])

    if num_processes is None or int(num_processes) == 1:
        if coordinator_address is not None and num_processes is None:
            raise ValueError("a fleet with a coordinator needs its number of processes")
        if process_id not in (None, 0):
            raise ValueError(f"process_id {process_id} in a fleet of one process")
        return 0, 1
    num_processes = int(num_processes)
    if coordinator_address is None or process_id is None:
        raise ValueError("a fleet of several processes needs the coordinator address and this process's id")
    process_id = int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside a fleet of {num_processes}")
    host, _, port = str(coordinator_address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {coordinator_address!r}")
    timeout = kwargs.pop("timeout", datetime.timedelta(seconds=300))
    _STORE = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0, timeout=timeout)
    dist.init_process_group("gloo", store=_STORE, rank=process_id, world_size=num_processes, timeout=timeout,
                            **kwargs)
    return dist.get_rank(), dist.get_world_size()


def process_shard(
    items: Sequence,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> list:
    """This process's contiguous shard of a work list (folders, catalog rows).

    Deterministic, disjoint, and complete across processes — the awk/xargs
    split of ``scripts/batch_starfit`` without the temp files. Defaults to the
    fleet's live rank and size (``(0, 1)`` outside a fleet).
    """
    if process_id is None or num_processes is None:
        import torch.distributed as dist

        joined = dist.is_available() and dist.is_initialized()
        if process_id is None:
            process_id = dist.get_rank() if joined else 0
        if num_processes is None:
            num_processes = dist.get_world_size() if joined else 1
    items = list(items)
    n = len(items)
    base, extra = divmod(n, num_processes)
    start = process_id * base + min(process_id, extra)
    stop = start + base + (1 if process_id < extra else 0)
    return items[start:stop]


def fleet_map(fn, items: Sequence, barrier: bool = True, timeout_s: float = 86400.0, **dist_kwargs) -> list:
    """Run ``fn(item)`` over this process's shard of ``items``.

    The whole-fleet pattern for independent fits: call on every process with
    the same ``items``; each process handles only its shard. With
    ``barrier=True`` all processes wait for each other at the end (so a later
    step can gather outputs from a shared filesystem); ``timeout_s``
    bounds the wait for stragglers.
    """
    pid, nproc = initialize_distributed(**dist_kwargs)
    results = [fn(item) for item in process_shard(items, pid, nproc)]
    if barrier and nproc > 1:
        _fleet_barrier("isochrones_torch_fleet_map_end", timeout_s=timeout_s)
    return results


def _fleet_barrier(name: str, timeout_s: float = 86400.0):
    """Cross-process barrier on the fleet's TCP store.

    Deliberately not a device or gloo collective: shards of independent fits
    routinely finish minutes apart, and the store's wait takes an explicit
    timeout with no data-plane setup. Each process counts itself in, the
    last one in opens the barrier, and process 0 (which serves the store)
    leaves only after every process has seen it open. Returns at once
    outside a fleet.
    """
    import torch.distributed as dist

    global _BARRIERS
    if _STORE is None or not dist.is_initialized():
        return
    _BARRIERS += 1
    name = f"{name}/{_BARRIERS}"
    n = dist.get_world_size()
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if _STORE.add(f"{name}/in", 1) == n:
        _STORE.set(f"{name}/open", "1")
    _STORE.wait([f"{name}/open"], timeout)
    if _STORE.add(f"{name}/out", 1) == n:
        _STORE.set(f"{name}/done", "1")
    if dist.get_rank() == 0:
        _STORE.wait([f"{name}/done"], timeout)
