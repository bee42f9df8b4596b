"""One run across several processes: the process group and its devices.

Counterpart of ``gcm_tpu/parallel/multihost.py``. A run that spans
processes is the same program started once per process, one process a card
(or several on one card), with :func:`initialize` called first. It joins a
``torch.distributed`` process group; ``parallel.sharding.domain_mesh`` then
lays its mesh over every rank's devices in rank order, as ``jax.devices()``
lists every chip of a slice, and the halo and slab exchanges move the slabs
between ranks through ``parallel.p2p``.

Start N ranks with an explicit coordinator::

    initialize("127.0.0.1:29500", num_processes=N, process_id=rank)

or with ``torchrun --nproc-per-node N``, whose environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) is detected. A single-process run needs no call:
``initialize()`` is then a no-op.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

#: how long joining the group, and every exchange, waits for a missing rank
TIMEOUT_S = 300.0


def in_group() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if in_group() else 0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: float = TIMEOUT_S) -> bool:
    """Join the process group of a run that spans processes.

    ``coordinator`` is ``host:port`` of rank 0's store. Without it the
    environment is read: ``COORDINATOR_ADDRESS`` (as JAX reads it), or
    torchrun's ``MASTER_ADDR``/``MASTER_PORT`` when ``WORLD_SIZE`` > 1;
    the world size and rank then come from ``WORLD_SIZE``/``RANK`` (or
    ``NUM_PROCESSES``/``PROCESS_ID``) unless given. With neither, this is a
    single-process run and nothing happens: returns False.

    ``backend=None`` is ``"nccl"`` when torch sees a card and raises
    otherwise; ``"gloo"`` must be asked for (CPU shards, or several ranks
    on one card). Every wait of the group is bounded by ``timeout``
    seconds, so a rank that never comes fails the run instead of hanging
    it. A rank with a card drives ``cuda:(LOCAL_RANK % device_count)``.
    Returns True once the group is joined.
    """
    if coordinator is None:
        if "COORDINATOR_ADDRESS" in os.environ:
            coordinator = os.environ["COORDINATOR_ADDRESS"]
        elif "MASTER_ADDR" in os.environ and (_env_int("WORLD_SIZE")
                                              or 1) > 1:
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
        else:
            return False
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator} given without the world "
                         "size and rank: pass num_processes and process_id, "
                         "or set WORLD_SIZE and RANK")
    if in_group():
        raise RuntimeError("initialize: this process already joined a "
                           "process group")
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: torch sees no CUDA device for "
                               "the default backend 'nccl'; pass "
                               "backend='gloo' to run on the CPU")
        backend = "nccl"
    kw = {}
    if torch.cuda.is_available():
        dev = torch.device("cuda", _local_rank(process_id)
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":   # the communicator is bound to the card now
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    atexit.register(shutdown)
    return True


def shutdown() -> None:
    """Leave the process group (nothing outside one). :func:`initialize`
    registers it to run at exit, as ``jax.distributed.initialize`` does its
    shutdown: a process that ends with its gloo group still up aborts now
    and then (SIGABRT, "terminate called without an active exception") as
    the group's threads are torn down."""
    if in_group():
        dist.destroy_process_group()


def _local_rank(process_id: int) -> int:
    local = _env_int("LOCAL_RANK")
    return process_id if local is None else local


def local_devices() -> List[torch.device]:
    """The devices this process drives: in a process group its one card
    (``cuda:(LOCAL_RANK % device_count)``, the CPU without one); alone,
    every visible card (the CPU without one)."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    if in_group():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def all_gather_object(obj) -> list:
    """``obj`` of every rank, in rank order (``[obj]`` outside a group)."""
    if not in_group():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    """Wait for every rank of the group (nothing outside a group)."""
    if in_group():
        dist.barrier()


def spans(mesh) -> bool:
    """Whether ``mesh`` (None: one device) spans processes."""
    return mesh is not None and mesh.spans_processes


def writes_files(mesh) -> bool:
    """Whether this process writes a run's files: on a mesh that spans
    processes only the rank of its first shard does (rank 0 as
    ``domain_mesh`` lays a mesh out), else every process."""
    return not spans(mesh) or mesh.is_local(0)


def files_written(mesh) -> None:
    """On a mesh that spans processes, wait until the writing rank has
    written what it writes at this point (every rank calls it there): no
    rank reads a half-written file."""
    if spans(mesh):
        barrier()


def process_info() -> Dict[str, int]:
    """This process's index and the group's size, with the devices this
    process drives and the devices of every rank together."""
    local = len(local_devices())
    return {"process_index": rank(),
            "process_count": dist.get_world_size() if in_group() else 1,
            "local_devices": local,
            "global_devices": sum(all_gather_object(local))}
