"""Control-plane and gradient collectives.

``broadcast`` and ``allreduce_async`` carry small Python objects (the
dataloader's batch-size decision and its exit-flag agreement);
``allreduce_mean`` is the trainer's one gradient all-reduce point. With
one replica they are the identity; with a ``torch.distributed`` process
group initialised they go over it. Every replica must call every
collective in the same order.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Callable

import torch
import torch.distributed as dist


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def allreduce(obj: Any, reduce_fn: Callable[[list], Any]) -> Any:
    """Reduce ``obj`` across replicas; every rank receives the result."""
    if not _distributed():
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
    if not _distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def allreduce_mean(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Average each tensor across replicas (in place when distributed)."""
    if not _distributed():
        return tensors
    world = dist.get_world_size()
    for t in tensors:
        dist.all_reduce(t)
        t.div_(world)
    return tensors
