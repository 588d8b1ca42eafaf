"""The process group, and the control-plane and gradient collectives.

``initialize`` joins this process to the job's ``torch.distributed``
process group, one process per replica, with the address, port, rank
and world size given explicitly. ``broadcast`` and ``allreduce_async``
carry small Python objects (the dataloader's batch-size decision and its
exit-flag agreement); ``allreduce_mean`` is the trainer's one gradient
all-reduce point. With one replica (no process group) they are the
identity; otherwise they go over the group. Every replica must call
every collective in the same order.
"""

from __future__ import annotations

import logging
from concurrent.futures import Future
from typing import Any, Callable

import torch
import torch.distributed as dist

LOG = logging.getLogger(__name__)


def backend_for(device: torch.device, local_world_size: int) -> str:
    """The process group's backend, from the topology alone: ``nccl``
    when the replicas are on CUDA and every local rank has a card of its
    own, ``gloo`` on the CPU and where local ranks outnumber the cards
    (NCCL refuses two ranks on one device; gloo stages CUDA tensors
    through the host)."""
    if device.type != "cuda":
        return "gloo"
    if local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(
    addr: str,
    port: int,
    rank: int,
    world_size: int,
    device: torch.device,
    local_world_size: int,
) -> str:
    """Join the job's process group (rank 0 serves the rendezvous at
    ``addr:port``); returns the backend chosen by :func:`backend_for`."""
    backend = backend_for(device, local_world_size)
    LOG.info(
        "process group: rank %d of %d on %s, %d local rank(s), backend %s",
        rank, world_size, device, local_world_size, backend,
    )
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(
        backend,
        init_method=f"tcp://{addr}:{port}",
        rank=rank,
        world_size=world_size,
        **kwargs,
    )
    return backend


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def teardown() -> None:
    """Leave the process group (a no-op without one)."""
    if initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Replicas in the process group; 1 without one."""
    return dist.get_world_size() if initialized() else 1


def allreduce(obj: Any, reduce_fn: Callable[[list], Any]) -> Any:
    """Reduce ``obj`` across replicas; every rank receives the result."""
    if not initialized():
        return reduce_fn([obj])
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, obj)
    return reduce_fn(gathered)


def allreduce_async(obj: Any, reduce_fn: Callable[[list], Any]) -> Future:
    """``allreduce`` as a future, ``.result()`` to join. Completed on
    return: the object collectives are small and the step they would
    overlap already runs asynchronously on the device."""
    future: Future = Future()
    future.set_result(allreduce(obj, reduce_fn))
    return future


def broadcast(obj: Any, src: int = 0) -> Any:
    """Every rank receives rank ``src``'s object."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier() -> None:
    """Return once every replica has reached this point."""
    if initialized():
        dist.barrier()


def pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """One contiguous float32 buffer holding every tensor, in order."""
    return torch.cat([t.reshape(-1).float() for t in tensors])


def unpack(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    """Copy ``flat`` (as :func:`pack` laid it out) back into ``tensors``."""
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view(t.shape))
        offset += t.numel()


def allreduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Average each tensor across replicas, in place: the tensors are
    packed into one float32 buffer, reduced by one all-reduce, divided
    once and unpacked. The identity with one replica."""
    if not initialized():
        return tensors
    flat = pack(tensors)
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    unpack(flat, tensors)
    return tensors
