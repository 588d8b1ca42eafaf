"""The process group, and the control-plane and gradient collectives.

``initialize`` joins this process to the job's ``torch.distributed``
process group, one process per replica, with the address, port, rank
and world size given explicitly. ``broadcast`` and ``allreduce_async``
carry small Python objects (the dataloader's batch-size decision and its
exit-flag agreement); ``allreduce_mean`` is the trainer's one gradient
all-reduce point, and ``reduce_scatter_sum`` / ``all_gather_rows`` move
the flat float32 rows of the ZeRO storage modes. With one replica they
are the identity; otherwise they go over the group. Every replica must
call every collective in the same order.

The sequence axis adds collectives over a subgroup of the job
(``group``, from :class:`adaptdl_tpu_torch.parallel.mesh.ProcessMesh`;
``None`` is the whole job): ``all_to_all`` (tiled, on a chosen split
and concat dim: ulysses' head exchange) and ``ppermute`` (each rank
sends to the next of its group and receives from the one before: ring
attention's K/V rotation), and ``allreduce_mean`` takes a group too.
Under NCCL they run on the device tensors; under gloo (two ranks on one
card) they stage through pinned host buffers kept per group and size.

Under the model and expert axes :func:`allreduce_sum` takes a group
(the Megatron region operators' and the expert region's sums), and the
ZeRO collectives take the group their rows are split over (the data
group under a seq axis). :data:`SOLO` stands for the group of this process
alone (an axis of size 1): every collective over it is the identity.

``allreduce_async`` returns before the peers answer, as the JAX
``Reducer`` does: its collective runs on one single-thread executor,
over a gloo group of its own (made once), so that it never shares the
default group's ordering with the training thread's all-reduce.
``teardown`` shuts the executor down with the groups.

``TRAFFIC`` counts the bytes of the tensor collectives this rank joins
(the full buffer of each all-reduce, all-gather, reduce-scatter and
all-to-all, and the bytes each ppermute sends, at more than one rank),
by kind: ``examples/profile_step.py`` and
``chip_smoke.py`` read it per step.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
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
    _ensure_async_group()
    return backend


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


# The background object collective: one worker thread and the gloo
# group it runs on, both made on first use and dropped by teardown.
_async_lock = threading.Lock()
_async_executor: ThreadPoolExecutor | None = None  # guarded-by: _async_lock
_async_group = None  # guarded-by: _async_lock


def teardown() -> None:
    """Leave the process group (a no-op without one), after the
    background collective's executor has finished its work."""
    global _async_executor, _async_group
    with _async_lock:
        executor, _async_executor, _async_group = _async_executor, None, None
    if executor is not None:
        executor.shutdown(wait=True)
    from adaptdl_tpu_torch.parallel import mesh

    mesh._reset()
    _staging.clear()
    if initialized():
        dist.destroy_process_group()


class _Solo:
    """The group of this process alone."""

    def __repr__(self) -> str:
        return "SOLO"


SOLO = _Solo()


def world_size() -> int:
    """Replicas in the process group; 1 without one."""
    return dist.get_world_size() if initialized() else 1


def allreduce(obj: Any, reduce_fn: Callable[[list], Any], group=None) -> Any:
    """Reduce ``obj`` across replicas; every rank receives the result."""
    if not initialized():
        return reduce_fn([obj])
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, obj, group=group)
    return reduce_fn(gathered)


def allreduce_async(obj: Any, reduce_fn: Callable[[list], Any]) -> Future:
    """``allreduce`` as a future, ``.result()`` to join. With one replica
    it completes inline; otherwise it runs on the background executor
    over its own gloo group and returns at once. Every rank issues these
    in the same order, and one worker thread keeps that order."""
    if not initialized() or dist.get_world_size() == 1:
        future: Future = Future()
        future.set_result(allreduce(obj, reduce_fn))
        return future
    executor, group = _ensure_async_group()
    return executor.submit(allreduce, obj, reduce_fn, group)


TRAFFIC = {
    "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0, "all_to_all": 0,
    "ppermute": 0,
}


def reset_traffic() -> None:
    for kind in TRAFFIC:
        TRAFFIC[kind] = 0


def _ensure_async_group():
    """The background collective's executor and gloo group, made once.
    ``new_group`` is itself a collective: ``initialize`` makes the group
    on every rank; a group joined elsewhere gets it at the first
    ``allreduce_async``, which every rank reaches at the same point."""
    global _async_executor, _async_group
    with _async_lock:
        if _async_group is None and dist.get_world_size() > 1:
            _async_group = dist.new_group(backend="gloo")
        if _async_executor is None:
            _async_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="adaptdl-torch-allreduce"
            )
        return _async_executor, _async_group


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


def allreduce_mean(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """Average each tensor across the ranks of ``group`` (default: every
    replica), in place: the tensors are packed into one float32 buffer,
    reduced by one all-reduce, divided once and unpacked. The identity
    with one rank."""
    if initialized() and group is not SOLO:
        allreduce_mean_packed(tensors, group)
    return tensors


def allreduce_mean_packed(tensors: list[torch.Tensor], group=None) -> torch.Tensor:
    """:func:`allreduce_mean`, returning the averaged flat buffer as
    :func:`pack` laid it out (the ZeRO modes slice their row of the
    gradient from it)."""
    flat = pack(tensors)
    if initialized() and group is not SOLO:
        dist.all_reduce(flat, group=group)
        size = dist.get_world_size(group)
        flat.div_(size)
        if size > 1:
            TRAFFIC["all_reduce"] += flat.numel() * flat.element_size()
    unpack(flat, tensors)
    return flat


def allreduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum a small tensor across the ranks of ``group`` (default: every
    replica), in place; the identity with one rank."""
    if group_size(group) > 1:
        dist.all_reduce(tensor, group=group)
        TRAFFIC["all_reduce"] += tensor.numel() * tensor.element_size()
    return tensor


def _staged() -> bool:
    """Whether collectives on a CUDA tensor go through a host buffer:
    under gloo, the backend :func:`backend_for` picks when ranks share
    a card."""
    return dist.get_backend() == "gloo"


def reduce_scatter_sum(flat: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's row of the sum over the ranks of ``group`` (default:
    every replica) of ``flat`` (float32, ``[dp * shard]``): ``[shard]``,
    row ``rank`` of the group. The identity with one rank. Under gloo
    the sum is one all-reduce of the host copy followed by a slice (a
    call every PyTorch version's gloo has); under NCCL it is
    ``reduce_scatter_tensor``."""
    dp = group_size(group)
    if dp == 1:
        return flat
    shard = flat.numel() // dp
    rank = group_rank(group)
    TRAFFIC["reduce_scatter"] += flat.numel() * flat.element_size()
    if _staged():
        host = flat.detach().to("cpu", copy=True)
        dist.all_reduce(host, group=group)
        return host[rank * shard : (rank + 1) * shard].to(flat.device)
    out = torch.empty(shard, dtype=flat.dtype, device=flat.device)
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out


def all_gather_rows(
    row: torch.Tensor, out: torch.Tensor | None = None, group=None
) -> torch.Tensor:
    """Every rank's ``row`` (float32, ``[shard]``) concatenated in the
    rank order of ``group`` (default: every replica): ``[dp * shard]``,
    written into ``out`` when given (``row`` may be ``out``'s own slice
    for this rank). The identity with one rank (``row`` itself, or
    copied into ``out``). Under gloo the gather runs on host copies,
    into a list of views of one host buffer; under NCCL it is
    ``all_gather_into_tensor``."""
    dp = group_size(group)
    if out is None and dp == 1:
        return row
    if out is None:
        out = torch.empty(dp * row.numel(), dtype=row.dtype, device=row.device)
    if dp == 1:
        if out.data_ptr() != row.data_ptr():
            out.copy_(row.reshape(-1))
        return out
    TRAFFIC["all_gather"] += out.numel() * out.element_size()
    if _staged():
        host_row = row.detach().reshape(-1).to("cpu", copy=True)
        host = torch.empty(out.numel(), dtype=row.dtype)
        dist.all_gather(list(host.chunk(dp)), host_row, group=group)
        out.copy_(host)
        return out
    dist.all_gather_into_tensor(out, row.detach().reshape(-1).contiguous(), group=group)
    return out


# Pinned host buffers of the staged (gloo) exchanges, per group and size:
# (group id, role, bytes) -> uint8 buffer. Every exchange copies in and
# out synchronously, so one pair per shape serves every call.
_staging: dict = {}


def _host_buffer(group, role: str, nbytes: int) -> torch.Tensor:
    key = (id(group), role, nbytes)
    buf = _staging.get(key)
    if buf is None:
        buf = _staging[key] = torch.empty(
            nbytes, dtype=torch.uint8, pin_memory=torch.cuda.is_available()
        )
    return buf


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return x.reshape(-1).view(torch.uint8)


def _exchange_bytes(send: torch.Tensor, group, run) -> torch.Tensor:
    """``run(out, inp)`` on uint8 buffers of ``send``'s size: on the
    device tensors under NCCL, on pinned host copies under gloo when
    ``send`` lies on a card. Returns the received bytes on ``send``'s
    device."""
    out = torch.empty_like(send)
    if send.is_cuda and _staged():
        host_in = _host_buffer(group, "in", send.numel())
        host_out = _host_buffer(group, "out", send.numel())
        host_in.copy_(send)
        run(host_out, host_in)
        out.copy_(host_out)
        return out
    run(out, send)
    return out


def group_size(group=None) -> int:
    """Ranks in ``group`` (default: the job); 1 for :data:`SOLO` and
    without a process group."""
    if group is SOLO or not initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This rank's index in ``group``; 0 for :data:`SOLO` and without a
    process group."""
    if group is SOLO or not initialized():
        return 0
    return dist.get_rank(group)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all over ``group`` (``lax.all_to_all(..., tiled=True)``):
    ``x`` splits into ``n`` chunks along ``split_dim``, chunk ``j`` goes
    to rank ``j`` of the group, and the chunks received are concatenated
    along ``concat_dim`` in source-rank order. The identity with one
    rank. One ``all_to_all_single`` on the bytes of the chunks laid out
    source-major."""
    n = group_size(group)
    if n == 1:
        return x
    shape = list(x.shape)
    if shape[split_dim] % n:
        raise ValueError(
            f"all_to_all: dim {split_dim} of {tuple(shape)} does not split "
            f"into {n} chunks"
        )
    chunk = shape[:]
    chunk[split_dim] //= n
    chunks = x.reshape(shape[:split_dim] + [n, chunk[split_dim]] + shape[split_dim + 1 :])
    chunks = chunks.movedim(split_dim, 0).contiguous()
    TRAFFIC["all_to_all"] += chunks.numel() * chunks.element_size()
    received = _exchange_bytes(
        _as_bytes(chunks), group,
        lambda out, inp: dist.all_to_all_single(out, inp, group=group),
    ).view(x.dtype).view(chunks.shape)
    merged = chunk[:]
    merged[concat_dim] *= n
    return received.movedim(0, concat_dim).reshape(merged)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank ``i`` of ``group`` sends ``x`` to rank ``(i + shift) % n`` and
    returns what rank ``(i - shift) % n`` sent (``lax.ppermute`` over the
    ring permutation): one send and one receive in one
    ``batch_isend_irecv``. The identity with one rank."""
    n = group_size(group)
    if n == 1:
        return x
    me = group_rank(group)

    def global_rank(r):
        return r if group is None else dist.get_global_rank(group, r)

    dst, src = global_rank((me + shift) % n), global_rank((me - shift) % n)
    x = x.contiguous()
    TRAFFIC["ppermute"] += x.numel() * x.element_size()

    def run(out, inp):
        ops = [
            dist.P2POp(dist.isend, inp, dst, group=group),
            dist.P2POp(dist.irecv, out, src, group=group),
        ]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    return _exchange_bytes(_as_bytes(x), group, run).view(x.dtype).view(x.shape)
