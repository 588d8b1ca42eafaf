"""The job's processes laid out on named axes: the port of
``adaptdl_tpu.parallel.mesh``.

The JAX package lays its devices out in a ``jax.sharding.Mesh`` and names
the axes its collectives run over (``lax.pmean(x, "data")``). The port
runs one process per chip, so its mesh is a layout of process ranks:
:class:`ProcessMesh` gives each rank its coordinates on every axis and
holds one ``torch.distributed`` subgroup per row of each axis, the ranks
that differ only in that axis's coordinate. Data is the outermost axis,
as in the JAX package's device order: with a data and a seq axis, rank
``r`` sits at ``data = r // sp``, ``seq = r % sp``.

The port runs every axis of the JAX package, in its order: data
outermost, then seq, model, stage, expert. The stage and expert axes
shard parameters (:data:`PARAM_SHARDED_AXES`): a pipeline stage owns
its layers (:mod:`adaptdl_tpu_torch.parallel.pipeline`), an expert rank
its experts; the data and seq axes replicate them, and the model axis
splits each block by the Megatron table. Any other axis name raises.

:func:`create_mesh` makes the mesh current: code that names an axis
(the sequence-parallel attention, the transformer's RoPE positions)
resolves it through :func:`axis_group` / :func:`axis_index` /
:func:`axis_size`, as JAX code resolves an axis name inside
``shard_map``.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from adaptdl_tpu_torch import collective, env

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"
PORTED_AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS, STAGE_AXIS, EXPERT_AXIS)

# Axes whose parameters are sharded, not replicated: pipeline stages own
# their layers, expert ranks their experts. Their gradients stay local;
# the noise statistics sum each shard's squared norm over the axis.
PARAM_SHARDED_AXES = (STAGE_AXIS, EXPERT_AXIS)


def stack_params(per_shard: list) -> dict:
    """Stack per-shard parameter trees (name -> tensor, one per pipeline
    stage or expert) into one tree whose tensors carry a leading shard
    axis, the JAX package's ``stack_params`` layout."""
    import torch

    return {name: torch.stack([tree[name] for tree in per_shard]) for name in per_shard[0]}


def topology_axes(
    data_shards: int,
    seq_shards: int = 1,
    model_shards: int = 1,
    stage_shards: int = 1,
    expert_shards: int = 1,
) -> dict[str, int]:
    """Mesh axes for a scheduler-assigned ``(dp, sp, tp, ss, ep)``
    factorization, in the canonical order (data outermost). Axes of size
    1 are omitted, so a pure data-parallel topology builds the default
    one-"data"-axis mesh."""
    axes = {DATA_AXIS: max(int(data_shards), 1)}
    if seq_shards > 1:
        axes[SEQ_AXIS] = int(seq_shards)
    if model_shards > 1:
        axes[MODEL_AXIS] = int(model_shards)
    if stage_shards > 1:
        axes[STAGE_AXIS] = int(stage_shards)
    if expert_shards > 1:
        axes[EXPERT_AXIS] = int(expert_shards)
    return axes


class ProcessMesh:
    """The job's processes on named axes, row-major in ``axes`` order.

    ``shape`` maps axis -> size; :meth:`index` is this rank's coordinate
    on an axis; :meth:`group` is the process group of this rank's row of
    an axis: ``None`` (the default group, every process) when the row
    is the whole job, :data:`collective.SOLO` when it has size 1 in a
    job of several processes, else a subgroup. Every rank builds every subgroup, in one order
    (``new_group`` is a collective of the default group)."""

    def __init__(self, axes: dict[str, int], rank: int, groups: dict):
        self.shape = dict(axes)
        self.rank = rank
        self._groups = groups
        self._strides = _strides(axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an absent axis)."""
        if axis not in self.shape:
            return 0
        return (self.rank // self._strides[axis]) % self.shape[axis]

    def group(self, axis: str):
        """The process group of this rank's row of ``axis``:
        :data:`collective.SOLO` on an axis of size 1 or an absent one of
        a mesh of several processes (no peers: every collective over it is
        the identity); the default group when the row is the whole job."""
        if self.size == 1:
            return None
        if self.axis_size(axis) == 1:
            return collective.SOLO
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank})"


_current: ProcessMesh | None = None
# (axes, default group) -> mesh: a second trainer of the same job reuses
# the subgroups instead of making new ones.
_cache: dict = {}


def _strides(axes: dict[str, int]) -> dict[str, int]:
    """Each axis's rank stride, row-major (the last axis fastest)."""
    strides, stride = {}, 1
    for name in reversed(list(axes)):
        strides[name] = stride
        stride *= axes[name]
    return strides


def _row_ranks(axes: dict[str, int], axis: str) -> list[list[int]]:
    """Every row of ``axis``: the lists of ranks that differ only in
    their ``axis`` coordinate, in a fixed order."""
    stride = _strides(axes)[axis]
    rows = {}
    for rank in range(math.prod(axes.values())):
        base = rank - ((rank // stride) % axes[axis]) * stride
        rows.setdefault(base, []).append(rank)
    return [rows[b] for b in sorted(rows)]


def create_mesh(axes: dict[str, int] | None = None) -> ProcessMesh:
    """The mesh over the job's processes, made current.

    ``axes`` maps axis name -> size in mesh order, data first, e.g.
    ``{"data": 2, "seq": 2}``. Default: one ``"data"`` axis over every
    process. The
    sizes must multiply to the process count (one process per chip), and
    with more than one process the process group must exist
    (``initialize_job``). Every rank calls it, in the same order."""
    global _current
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    procs = env.num_processes()
    sizes = {DATA_AXIS: procs} if axes is None else dict(axes)
    unknown = sorted(k for k, s in sizes.items() if k not in PORTED_AXES and s > 1)
    if unknown:
        raise ValueError(
            f"unknown mesh axes {unknown}: the axes are {list(PORTED_AXES)}"
        )
    total = math.prod(sizes.values())
    if total != procs:
        raise NotImplementedError(
            "multi-replica data parallelism runs one process per replica (one "
            f"per chip under a seq axis): the mesh {sizes} needs {total} "
            f"processes, ADAPTDL_NUM_PROCESSES={procs}"
        )
    if world != total:
        raise RuntimeError(
            f"the mesh {sizes} spans {total} process(es) but the process "
            f"group holds {world}; call initialize_job() first"
        )
    rank = dist.get_rank() if world > 1 else 0
    key = (tuple(sizes.items()), id(dist.group.WORLD) if world > 1 else None)
    mesh = _cache.get(key)
    if mesh is None:
        groups = {}
        for axis, size in sizes.items():
            if size in (1, total):
                groups[axis] = None
                continue
            for ranks in _row_ranks(sizes, axis):
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
        mesh = _cache[key] = ProcessMesh(sizes, rank, groups)
    _current = mesh
    return mesh


def create_mesh_from_topology() -> ProcessMesh:
    """The mesh the scheduler's published topology asks for: the seq,
    model, stage and expert shards from the environment, the data axis
    over :func:`env.data_parallel_replicas`."""
    axes = topology_axes(
        env.data_parallel_replicas(), env.seq_shards(), env.model_shards(),
        env.stage_shards(), env.expert_shards(),
    )
    return create_mesh(axes)


def current_mesh() -> ProcessMesh | None:
    return _current


def _mesh_for(axis: str) -> ProcessMesh:
    if _current is None:
        raise RuntimeError(
            f"no process mesh names the axis {axis!r}: create_mesh() (the "
            "trainer makes one) before running code that collects over it"
        )
    return _current


def axis_size(axis: str) -> int:
    """Processes on ``axis`` of the current mesh (1 when absent)."""
    return _mesh_for(axis).axis_size(axis)


def axis_index(axis: str) -> int:
    """This process's coordinate on ``axis`` of the current mesh."""
    return _mesh_for(axis).index(axis)


def axis_group(axis: str):
    """The process group of this process's row of ``axis``."""
    return _mesh_for(axis).group(axis)


def data_group():
    """The group of this process's data-parallel row, over which the
    ZeRO modes split their rows: the current mesh's data axis, the whole
    job when no mesh is current."""
    return None if _current is None else _current.group(DATA_AXIS)


def _reset() -> None:
    """Forget the current mesh and the cached subgroups (tests, after
    the process group is torn down)."""
    global _current
    _current = None
    _cache.clear()
