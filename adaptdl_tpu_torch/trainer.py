"""ElasticTrainer: the elastic data-parallel training step, in PyTorch.

The port of the data-parallel branch of ``adaptdl_tpu.trainer``. One
optimizer step at a given (atomic_bsz, accum_steps):

- every microbatch runs forward and backward into its own local
  gradients, and its per-group squared norm -- preconditioned by
  ``sqrt(max(nu, 0)) + 1e-8`` of Adam's second moments read *before*
  this step's update when ``precondition="adam"`` -- is taken before the
  gradients are summed;
- one all-reduce then averages the gradients, the squared-norm
  scalars and the loss across the replicas, packed into one flat
  buffer (the identity with one replica); under a seq axis each
  microbatch's gradients and loss are first averaged over its seq group
  (one replica of several processes), and this all-reduce runs over the
  data group;
- under a model or expert axis a replica's parameters are split over
  its group (the Megatron table, the experts): each rank steps its own
  shards, the replicated leaves' gradients are equal across the group
  by the model's region operators, and the noise statistics and norms
  count each element once (a shard's squared norm summed over its
  group, a replicated leaf once);
- under a stage axis a replica is a pipeline (:mod:`adaptdl_tpu_torch.
  models.pipeline_lm`): each rank holds and steps its stage's blocks,
  the replicated leaves (embedding, tied head, final LayerNorm) get a
  partial gradient on each stage (the input path on the first, the head
  on the last) that each microbatch sums over the stage group before
  its noise statistics, and the blocks' squared norms are summed over
  the stage group;
- the gradient-noise statistics update, the scaling rule turns them
  into per-group LR factors, the optimizer applies them, and progress
  advances by the statistical gain.

This is deliberately not DDP: DDP averages gradients inside backward,
before the noise statistics can see each replica's own gradient.
Everything stays on the device; ``run_step`` reads the statistics back
to the host only every ``metrics_every`` steps, where the numeric-health
guard grades them (and may roll the job back to its last-known-good
checkpoint).

Each microbatch gets its own ``torch.Generator`` for dropout and masks,
as the JAX step folds the step and replica index into its key and splits
one key per microbatch: seeded from the trainer's seed, the step, the
microbatch index and the replica rank (and the seq index under a seq
axis, as the JAX step folds it in), so a restart (which restores the
step and the seed) draws the same numbers. The two packages' random
streams differ; only the port's own draws repeat.
"""

from __future__ import annotations

import functools
import json
import math
import time
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from adaptdl_tpu_torch import checkpoint, collective, env, gns, guard, metrics
from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.optim import SGD, AdamW
from adaptdl_tpu_torch.parallel import mesh as pmesh
from adaptdl_tpu_torch.parallel import zero3
from adaptdl_tpu_torch.scaling_rules import RuleContext, ScalingRule

# Profiler ranges of the step's three phases (examples/profile_step.py
# reads them); a range costs a few microseconds when no profiler runs.
RANGE_MICROBATCHES = "adaptdl.microbatches"
RANGE_STATISTICS = "adaptdl.statistics"
RANGE_OPTIMIZER = "adaptdl.optimizer"


@dataclass(frozen=True)
class TrainState:
    """The trainer's own state beside the model and optimizer it steps
    (which update in place)."""

    model: torch.nn.Module
    optimizer: SGD | AdamW
    gns: gns.GNSState
    progress: torch.Tensor  # scale-invariant steps (advanced by gain)
    step: torch.Tensor  # raw optimizer steps taken
    # The random draws' seed and ``step`` kept on the host, so that
    # seeding a microbatch's generator reads nothing from the device.
    seed: int = 0
    host_step: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# The step index of the generator calibration runs draw from: no real
# step has it, so a calibration repeats no training draw.
CALIBRATION_STEP = 2**62


def microbatch_generator(
    device: torch.device, seed: int, step: int, micro: int, rank: int,
    seq_index: int | None = None,
) -> torch.Generator:
    """The generator of microbatch ``micro`` of ``step`` on replica
    ``rank`` (and, under a seq axis, on its shard ``seq_index``): a fresh
    generator on ``device`` seeded by a hash of the integers."""
    entropy = np.random.SeedSequence(
        [seed, step, micro, rank] + ([] if seq_index is None else [seq_index])
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(int(entropy.generate_state(1, np.uint64)[0]))
    return generator


class RowLayout:
    """Where each rank's row of the parameters (and of every
    parameter-shaped mirror: moments, the differenced carry) sits in the
    flat canonical vector, the module's parameter order raveled.

    Flat layout (``spec`` None; zero1 and zero3): the vector padded to
    ``dp * shard`` and cut into ``dp`` rows. Block layout (``spec``, a
    :class:`~adaptdl_tpu_torch.parallel.zero3.BlockSpec`; zero3_blocks):
    a rank's ``[L, shard_b]`` block rows, then its ``[shard_o]`` row,
    laid end to end. :meth:`segments` says which canonical ranges a
    rank's row holds; the checkpoints gather and scatter by it."""

    def __init__(self, names, shapes, spec=None):
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.n = sum(self.numels)
        self.spec = spec

    def row_len(self, dp: int) -> int:
        if self.spec is None:
            return (self.n + (-self.n) % dp) // dp
        shard_b, shard_o = zero3.shard_sizes(self.spec, dp)
        return self.spec.num_blocks * shard_b + shard_o

    def segments(self, rank: int, dp: int) -> list:
        """``[(canonical_start, length, row_offset), ...]`` of rank
        ``rank``'s row at ``dp`` replicas."""
        if self.spec is not None:
            return zero3.row_segments(self.spec, rank, dp)
        shard = self.row_len(dp)
        start = rank * shard
        length = min(shard, self.n - start)
        return [(start, length, 0)] if length > 0 else []

    def gather(self, row: torch.Tensor, group=None) -> torch.Tensor:
        """Every rank's row -> the flat canonical ``[n]`` vector (a new
        tensor); a collective every rank of ``group`` (the data group;
        default every replica) joins."""
        dp = collective.group_size(group)
        width = self.row_len(dp)
        gathered = collective.all_gather_rows(
            row.detach().reshape(-1).float(), group=group
        )
        if self.spec is None:
            return gathered[: self.n].clone()
        flat = torch.empty(self.n, dtype=torch.float32, device=row.device)
        for r in range(dp):
            for start, length, offset in self.segments(r, dp):
                base = r * width + offset
                flat[start : start + length] = gathered[base : base + length]
        return flat

    def row_from_flat(self, flat: torch.Tensor, rank: int, dp: int) -> torch.Tensor:
        """This rank's row of a flat canonical vector (zeros in the
        padding)."""
        row = torch.zeros(self.row_len(dp), dtype=torch.float32, device=flat.device)
        for start, length, offset in self.segments(rank, dp):
            row[offset : offset + length] = flat[start : start + length]
        return row

    def tree(self, flat: torch.Tensor) -> dict:
        """A flat canonical vector -> name -> view."""
        out, off = {}, 0
        for name, shape, k in zip(self.names, self.shapes, self.numels):
            out[name] = flat[off : off + k].view(shape)
            off += k
        return out

    def ravel(self, tree: dict) -> torch.Tensor:
        """A tree with this layout's names -> the flat canonical vector."""
        return torch.cat(
            [torch.as_tensor(tree[name]).reshape(-1).float() for name in self.names]
        )


class ElasticTrainer:
    """Runs elastic data-parallel training steps.

    Args:
      loss_fn: ``loss_fn(model, batch, generator) -> scalar`` mean loss
        over the batch (a dict of tensors with a common leading dim);
        ``generator`` is the microbatch's ``torch.Generator`` for
        dropout and masks. With ``has_aux``, ``loss_fn(model, batch,
        generator, aux)``.
      model: the ``nn.Module`` to train, already on ``device``.
      optimizer: an :mod:`adaptdl_tpu_torch.optim` optimizer (``SGD``,
        ``Adam`` or ``AdamW``) over ``model.parameters()``, in the
        model's parameter order.
      init_batch_size: the batch size the LR was tuned for.
      scaling_rule: LR rule; default applies no scaling. AdaScale for
        SGD, AdamScale for the Adam family.
      precondition: None or "adam" (precondition the noise statistics
        by Adam's second moments; the optimizer must keep them).
      smoothing: GNS EMA retention per unit scale.
      seed: seeds every microbatch's generator (with the step, the
        microbatch index and the replica rank).
      has_aux: the step takes one more input, the same on every
        replica and not split into microbatches, forwarded to the loss
        (a GAN's generator, a teacher model).
      device: where the step runs; "cuda" (default) raises without CUDA.
      param_group_fn: ``(name, param) -> int`` over
        ``model.named_parameters()``, group ids 0..G-1 with none left
        out: the noise statistics and the scaling rule's LR factor are
        kept per group (the optimizer's param groups of the reference).
        None puts every parameter in group 0.

      zero1: shard the optimizer state over the replicas (flat rows).
      zero3: shard the parameter storage too (implies ``zero1``).
      zero3_blocks: the name of the layer-stacked family (``"blocks"``)
        for per-layer ZeRO-3; ``loss_fn`` then takes a ``Zero3View``.
        A storage mode of its own, with one parameter group.

    Under a ZeRO mode the optimizer, built over ``model.parameters()``
    as usual, is rebound to the mode's rows (:meth:`optim.
    _FactorOptimizer.rebind`); the parameters must be float32.

    mesh: a :class:`~adaptdl_tpu_torch.parallel.mesh.ProcessMesh` with a
      ``"data"`` and optionally ``"seq"``, ``"model"`` and ``"expert"``
      axes; None builds the one the environment's topology asks for
      (``create_mesh_from_topology``).

    Each of the mesh's processes (one per chip) is one rank of the job's
    process group (``initialize_job`` joins it). The data axis's
    replicas step on their own blocks of each global batch. Under a seq
    axis of ``sp`` ranks a replica is ``sp`` processes: each takes the
    ``seq_index``-th block of dim 1 of every batch leaf of two or more
    dims (:meth:`to_device`), the model's ``seq_axis`` attention crosses
    the blocks, and each microbatch's gradients and loss are averaged
    over the seq group before its noise statistics, so they see whole
    samples; ``ADAPTDL_NUM_REPLICAS`` must then count the replicas, not
    the chips. The ZeRO modes split their rows over the data group. Under
    a model (expert) axis the model must be built for it
    (``TransformerConfig.model_axis`` / ``moe_axis``: each rank holds its
    shards), every rank of the group reads its replica's whole block,
    and the checkpoint holds the full logical tensors (gathered over the
    group on save, cut on restore), so a job moves between tp (ep) 1
    and 2 across a restart. Under a stage axis the model is a
    :class:`~adaptdl_tpu_torch.models.pipeline_lm.PipelineLM` (with a
    model axis too, its blocks built for it): a stage group is one
    replica, every rank of it reads the replica's whole block, and the
    checkpoint holds the dense LM's full logical tensors under its names
    (gathered over the stage group on save, each stage's layers taken on
    restore), so a job moves between ss 1 and 2, and between GPipe and
    the interleaved schedule, across a restart. ``pipeline_micro`` is
    the M the pipelined loss was built with (default
    ``env.pipeline_micro()`` under a stage axis, else 1); the trainer
    registers it with the topology. The ZeRO modes refuse the model,
    stage and expert axes.
    """

    def __init__(
        self,
        loss_fn: Callable,
        model: torch.nn.Module,
        optimizer: SGD | AdamW,
        init_batch_size: int,
        scaling_rule: ScalingRule | None = None,
        precondition: str | None = None,
        smoothing: float = 0.999,
        seed: int = 0,
        has_aux: bool = False,
        device="cuda",
        param_group_fn: Callable | None = None,
        zero1: bool = False,
        zero3: bool = False,
        zero3_blocks: str | None = None,
        mesh=None,
        pipeline_micro: int | None = None,
    ):
        if mesh is None:
            mesh = pmesh.create_mesh_from_topology()
        elif not isinstance(mesh, pmesh.ProcessMesh):
            raise TypeError(
                "mesh takes the port's process meshes "
                "(adaptdl_tpu_torch.parallel.mesh.create_mesh), not "
                f"{type(mesh).__name__}"
            )
        self.mesh = mesh
        num_replicas = mesh.axis_size(pmesh.DATA_AXIS)
        self.seq_shards = mesh.axis_size(pmesh.SEQ_AXIS)
        self.model_shards = mesh.axis_size(pmesh.MODEL_AXIS)
        self.expert_shards = mesh.axis_size(pmesh.EXPERT_AXIS)
        self.stage_shards = mesh.axis_size(pmesh.STAGE_AXIS)
        self._data_group = mesh.group(pmesh.DATA_AXIS)
        if mesh.size != env.num_processes():
            raise NotImplementedError(
                "multi-replica data parallelism runs one process per replica "
                f"(one per chip under a seq axis): the mesh {mesh.shape} "
                f"over ADAPTDL_NUM_PROCESSES={env.num_processes()}"
            )
        if env.num_replicas() != num_replicas:
            raise RuntimeError(
                f"ADAPTDL_NUM_REPLICAS={env.num_replicas()} but the mesh "
                f"{mesh.shape} has {num_replicas} data-parallel replica(s): "
                "under a seq axis it counts the chips at launch; set it to "
                "env.data_parallel_replicas() before building the trainer, "
                "as examples/transformer_lm.py does"
            )
        if precondition not in (None, "adam"):
            raise ValueError(f"unknown precondition: {precondition!r}")
        if precondition == "adam" and not hasattr(optimizer, "second_moments"):
            raise ValueError(
                'precondition="adam" needs an optimizer with second moments '
                f"(Adam or AdamW), not {type(optimizer).__name__}"
            )
        self.device = resolve_device(device)
        named = list(model.named_parameters())
        self._params = [p for _, p in named]
        off_device = [n for n, p in named if p.device.type != self.device.type]
        if off_device:
            raise ValueError(
                f"model parameters {off_device[:3]} are not on {self.device}"
            )
        if [id(p) for p in optimizer.params()] != [id(p) for p in self._params]:
            raise ValueError(
                "the optimizer must hold model.parameters(), in order"
            )
        if param_group_fn is None:
            self._group_ids = [0] * len(named)
        else:
            self._group_ids = [int(param_group_fn(n, p)) for n, p in named]
        self.num_param_groups = max(self._group_ids, default=0) + 1
        if set(self._group_ids) != set(range(self.num_param_groups)):
            raise ValueError(
                "param_group_fn must assign contiguous group ids "
                f"0..G-1; got {sorted(set(self._group_ids))}"
            )
        self._names = [n for n, _ in named]
        self._shapes = [tuple(p.shape) for _, p in named]
        sharded_axes = (
            self.model_shards > 1 or self.expert_shards > 1 or self.stage_shards > 1
        )
        self.zero3_blocks = zero3_blocks
        if zero3_blocks is not None:
            if zero1 or zero3:
                raise ValueError(
                    "zero3_blocks is a storage mode of its own; do not "
                    "combine with zero1/zero3"
                )
            if sharded_axes:
                raise ValueError(
                    "zero3_blocks shards parameter storage over the "
                    "data axis and composes with data and sequence "
                    "parallelism only (model/stage/expert axes "
                    "manage their own layouts)"
                )
            if self.num_param_groups > 1:
                raise ValueError(
                    "zero3_blocks supports a single param group (the "
                    "row layout has no per-position group table yet)"
                )
        self.zero3 = bool(zero3)
        self.zero1 = bool(zero1) or self.zero3
        if self.zero1 and sharded_axes:
            raise ValueError(
                "zero1 shards optimizer state over the data axis "
                "and composes with data/seq parallelism only; "
                "stage/expert/model axes manage their own "
                "parameter and optimizer layouts"
            )
        self._shard_specs = self._leaf_shards(model, named)
        self._stage_leaves = self._stage_leaf_flags(model, named)
        self._param_group_fn = param_group_fn
        self.num_replicas = num_replicas
        self.layout = None
        if self.zero1 or zero3_blocks is not None:
            self._build_rows(model, optimizer, named)
        self.loss_fn = loss_fn
        self.model = model
        self.optimizer = optimizer
        self.init_batch_size = init_batch_size
        self.scaling_rule = scaling_rule or ScalingRule()
        self.precondition = precondition
        self.smoothing = smoothing
        self.seed = seed
        self.has_aux = has_aux
        if pipeline_micro is None:
            pipeline_micro = env.pipeline_micro() if self.stage_shards > 1 else 1
        self.pipeline_micro = max(int(pipeline_micro), 1)
        metrics.set_active_topology(
            self.seq_shards, self.model_shards, self.stage_shards,
            self.expert_shards, self.pipeline_micro,
        )
        self._calibrated: set[int] = set()
        # One warm-up run plus this many timed runs per calibration.
        self.calibrate_repeats = 3
        # How often run_step reads the statistics back to the host.
        self.metrics_every = 10
        self._steps_since_pull = self.metrics_every - 1  # pull early once
        # The state the last restore of a TrainerCheckpoint of this
        # trainer set (what run_step hands back after a rollback).
        self._restored_state: TrainState | None = None

    # ---- model and expert axes ----------------------------------------

    def _leaf_shards(self, model, named) -> list:
        """Per parameter, ``(axis, ShardSpec)`` where the mesh splits it
        over a model or expert axis of more than one rank, else None; the
        model must be built for those axes."""
        from adaptdl_tpu_torch.parallel import tensor_parallel

        active = {
            axis for axis, size in (
                (pmesh.MODEL_AXIS, self.model_shards),
                (pmesh.EXPERT_AXIS, self.expert_shards),
            ) if size > 1
        }
        if not active:
            return [None] * len(named)
        config = getattr(model, "config", None)
        wants = {pmesh.MODEL_AXIS: "model_axis", pmesh.EXPERT_AXIS: "moe_axis"}
        for axis in sorted(active):
            if getattr(config, wants[axis], None) != axis:
                raise ValueError(
                    f"the mesh {self.mesh.shape} splits the model over "
                    f"{axis!r}: build the transformer with "
                    f"TransformerConfig({wants[axis]}={axis!r}) so each rank "
                    "holds its shards"
                )
        specs = []
        for name, p in named:
            found = tensor_parallel.leaf_shard_spec(name, p)
            specs.append(found if found is not None and found[0] in active else None)
        return specs

    def _stage_leaf_flags(self, model, named) -> list:
        """Per parameter, whether it is one of this stage's blocks (its
        own, not replicated over the stage group); all False without a
        stage axis. The model must be the pipelined LM built for the
        mesh's stages."""
        if self.stage_shards == 1:
            return [False] * len(named)
        from adaptdl_tpu_torch.models.pipeline_lm import PipelineLM

        if not isinstance(model, PipelineLM) or model.num_stages != self.stage_shards:
            raise ValueError(
                f"the mesh {self.mesh.shape} runs {self.stage_shards} pipeline "
                "stages: train models.pipeline_lm.init_pipeline_lm's model, "
                "built for them after the mesh"
            )
        if model.stage != self.mesh.index(pmesh.STAGE_AXIS):
            raise ValueError(
                f"the model holds stage {model.stage}'s blocks, this rank runs "
                f"stage {self.mesh.index(pmesh.STAGE_AXIS)}"
            )
        if self.seq_shards > 1:
            raise ValueError(
                "the pipelined blocks run the whole sequence: the stage axis "
                "composes with the data and model axes, not the seq axis"
            )
        return [name.startswith("layers.") for name, _ in named]

    @property
    def sharded(self) -> bool:
        """Whether some parameter is split over a model, expert or stage
        axis."""
        return self.stage_shards > 1 or any(s is not None for s in self._shard_specs)

    def _sum_replicated_over_stages(self, grads) -> None:
        """Under a stage axis: sum the replicated leaves' partial
        gradients over the stage group, in place (one all-reduce), so
        every stage holds the whole gradient of the embedding, the tied
        head and the final LayerNorm (the sum the JAX step takes
        implicitly over a stage-invariant leaf)."""
        if self.stage_shards == 1:
            return
        shared = [g for g, own in zip(grads, self._stage_leaves) if not own]
        flat = collective.allreduce_sum(
            collective.pack(shared), group=self.mesh.group(pmesh.STAGE_AXIS)
        )
        collective.unpack(flat, shared)

    def _stat_normsqr(self, tensors, precond=None) -> torch.Tensor:
        """Per-group squared norms (G,) of a parameter-aligned gradient,
        each element once: a shard's terms summed over its axis's group,
        a replicated leaf's counted once (the JAX ``leaf_psum_axes``)."""
        if not self.sharded:
            return gns.group_normsqr(
                tensors, self._group_ids, self.num_param_groups, precond
            )
        tensors = list(tensors)
        pre = list(precond) if precond is not None else [None] * len(tensors)
        by_axis: dict = {}
        for i, (found, own) in enumerate(zip(self._shard_specs, self._stage_leaves)):
            by_axis.setdefault((None if found is None else found[0], own), []).append(i)
        total = torch.zeros(self.num_param_groups, device=self.device)
        staged = torch.zeros(self.num_param_groups, device=self.device)
        for (axis, own), idx in by_axis.items():
            part = gns.group_normsqr(
                [tensors[i] for i in idx], [self._group_ids[i] for i in idx],
                self.num_param_groups, [pre[i] for i in idx],
            )
            if axis is not None:
                part = collective.allreduce_sum(part, group=self.mesh.group(axis))
            if own:
                staged = staged + part
            else:
                total = total + part
        if self.stage_shards > 1:
            # Each stage's blocks once: their terms summed over the group.
            total = total + collective.allreduce_sum(
                staged, group=self.mesh.group(pmesh.STAGE_AXIS)
            )
        return total

    def logical_tensor(self, index: int, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``index``'s full tensor from this rank's shard ``t``
        (or a tensor of the shard's shape: a moment, the carry): the
        all-gather over its axis's group, every rank of which calls it;
        ``t`` itself for a replicated leaf."""
        found = self._shard_specs[index]
        if found is None:
            return t
        axis, spec = found
        group = self.mesh.group(axis)
        flat = collective.all_gather_rows(t.detach().float().reshape(-1), group=group)
        parts = flat.view(collective.group_size(group), *t.shape).unbind(0)
        return spec.gather(list(parts))

    def local_tensor(self, index: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of parameter ``index``'s full tensor (no
        collective); ``full`` itself for a replicated leaf."""
        found = self._shard_specs[index]
        if found is None:
            return full
        axis, spec = found
        return spec.shard(full, self.mesh.index(axis), self.mesh.axis_size(axis))

    def _map_payload(self, payload: dict, fn) -> dict:
        """A dense payload with ``fn(index, tensor)`` applied to each
        parameter-shaped tensor: the parameters, their optimizer
        entries (the step counts excepted) and the differenced carry."""
        index = {n: i for i, n in enumerate(self._names)}
        model = {
            k: fn(index[k], v) if k in index else v
            for k, v in payload["model"].items()
        }
        opt = dict(payload["optimizer"])
        opt["state"] = {
            i: {k: fn(i, v) if k != "step" else v for k, v in entry.items()}
            for i, entry in opt["state"].items()
        }
        prev = [fn(i, t) for i, t in enumerate(payload["prev_grad"])]
        return {**payload, "model": model, "optimizer": opt, "prev_grad": prev}

    def logical_payload(self, payload: dict) -> dict:
        """This rank's dense payload -> the full logical one, as a tp 1
        (ep 1, ss 1) trainer saves it: the shards gathered over their
        groups, and under a stage axis every stage's layers gathered under
        the dense LM's names (a collective every rank joins)."""
        payload = self._map_payload(payload, self.logical_tensor)
        if self.stage_shards > 1:
            payload = self._gather_stages(payload)
        return payload

    def local_payload(self, payload: dict) -> dict:
        """A full logical payload -> this rank's shards of it (no
        collective)."""
        if self.stage_shards > 1:
            payload = self._select_stage(payload)
        return self._map_payload(
            payload, lambda i, t: self.local_tensor(i, torch.as_tensor(t))
        )

    def _stage_dense(self, values: list) -> dict:
        """A family of this stage's tensors in parameter order (full
        logical tensors) -> name -> tensor of the dense LM over every
        stage: the block tensors packed and gathered over the stage
        group once (a collective every rank joins), each stage's share
        renamed to its layers; the replicated ones as they are."""
        model, stages = self.model, self.stage_shards
        own = [i for i, flag in enumerate(self._stage_leaves) if flag]
        mine = [values[i] for i in own]
        flat = collective.all_gather_rows(
            collective.pack(mine), group=self.mesh.group(pmesh.STAGE_AXIS)
        )
        rows = flat.view(stages, -1)
        out = {self._names[i]: v for i, v in enumerate(values) if not self._stage_leaves[i]}
        for d in range(stages):
            off = 0
            for i, t in zip(own, mine):
                part = rows[d, off : off + t.numel()].view(t.shape).to(t.dtype)
                out[model.peer_name(self._names[i], d)] = part
                off += t.numel()
        return out

    def _gather_stages(self, payload: dict) -> dict:
        """A stage's payload (full logical tensors, its own names) -> the
        dense LM's payload: each family (parameters, each moment, the
        carry) gathered over the stage group once."""
        names = self.model.dense_names()
        params = self._stage_dense([payload["model"][n] for n in self._names])
        opt = payload["optimizer"]
        entries = [opt["state"].get(i) for i in range(len(self._names))]
        keys = [k for k in (entries[0] or {}) if k != "step"]
        per_key = {k: self._stage_dense([e[k] for e in entries]) for k in keys}
        state = {}
        if keys:
            for j, name in enumerate(names):
                state[j] = {"step": entries[0]["step"], **{k: per_key[k][name] for k in keys}}
        groups = []
        for g in opt["param_groups"]:
            members = {
                self.model.peer_name(self._names[i], d)
                for i in g["params"] for d in range(self.stage_shards)
            }
            groups.append({**g, "params": [j for j, n in enumerate(names) if n in members]})
        prev = self._stage_dense(list(payload["prev_grad"]))
        if self._param_group_fn is None:
            group_ids = [0] * len(names)
        else:
            group_ids = [int(self._param_group_fn(n, params[n])) for n in names]
        return {
            **payload,
            "model": {n: params[n] for n in names},
            "optimizer": {"state": state, "param_groups": groups},
            "prev_grad": [prev[n] for n in names],
            "group_ids": group_ids,
            "param_names": names,
        }

    def _select_stage(self, payload: dict) -> dict:
        """The dense LM's payload -> this stage's (its replicated leaves
        and its layers, under its names; no collective)."""
        saved = payload.get("param_names") or list(payload["model"])
        where = {n: j for j, n in enumerate(saved)}
        missing = [n for n in self._names if n not in where]
        if missing:
            raise ValueError(
                f"the checkpoint lacks this stage's parameters {missing[:3]}: "
                "the pipelined LM restores the dense LM's layout"
            )
        index = [where[n] for n in self._names]
        opt = payload["optimizer"]
        state = {
            i: opt["state"][j] for i, j in enumerate(index) if j in opt["state"]
        }
        groups = []
        for g in opt["param_groups"]:
            members = set(g["params"])
            groups.append({**g, "params": [i for i, j in enumerate(index) if j in members]})
        ids = payload.get("group_ids")
        return {
            **payload,
            "model": {n: payload["model"][n] for n in self._names},
            "optimizer": {"state": state, "param_groups": groups},
            "prev_grad": [payload["prev_grad"][j] for j in index],
            "group_ids": None if ids is None else [ids[j] for j in index],
            "param_names": list(self._names),
        }

    # ---- ZeRO storage: rows ------------------------------------------

    def _build_rows(self, model, optimizer, named) -> None:
        """Lay the parameters out as this rank's rows and rebind the
        optimizer to them (zero1, zero3, zero3_blocks)."""
        not_f32 = [n for n, p in named if p.dtype != torch.float32]
        if not_f32:
            raise ValueError(
                f"the ZeRO storage modes keep float32 rows; {not_f32[:3]} "
                "are not float32"
            )
        dp, rank = self.num_replicas, self.mesh.index(pmesh.DATA_AXIS)
        self._rank = rank
        if self.zero3_blocks is not None:
            spec = zero3.block_spec(model, self.zero3_blocks)
            self._spec = spec
            self.layout = RowLayout(self._names, self._shapes, spec)
            with torch.no_grad():
                blocks_rows, other_rows = zero3.tree_to_rows(
                    dict(named), self.zero3_blocks, spec, dp
                )
                self._blocks_row = blocks_rows[:, rank].contiguous().requires_grad_()
                self._other_row = other_rows[rank].contiguous().requires_grad_()
            self._rows = [self._blocks_row, self._other_row]
            # The module's own parameters are never read again: only
            # their shapes stay.
            for _, p in named:
                p.detach().untyped_storage().resize_(0)
            self._params = self._rows
        else:
            self.layout = RowLayout(self._names, self._shapes)
            shard = self.layout.row_len(dp)
            full = torch.zeros(dp * shard, dtype=torch.float32, device=self.device)
            with torch.no_grad():
                off = 0
                for (_, p), k in zip(named, self.layout.numels):
                    full[off : off + k].copy_(p.detach().reshape(-1))
                    p.data = full[off : off + k].view(p.shape)
                    off += k
            self._full = full
            self._full_bytes = full.untyped_storage().nbytes()
            row = full[rank * shard : (rank + 1) * shard]
            self._row = row.clone() if self.zero3 else row
            self._rows = [self._row]
            # Per-position group ids, only where groups differ.
            self._row_gids = None
            if self.num_param_groups > 1:
                gids = torch.cat([
                    torch.full((k,), gid, dtype=torch.int64)
                    for gid, k in zip(self._group_ids, self.layout.numels)
                ] + [torch.zeros(dp * shard - self.layout.n, dtype=torch.int64)])
                self._row_gids = gids[rank * shard : (rank + 1) * shard].to(self.device)
            if self.zero3:
                self._release()
        optimizer.rebind(self._rows)

    def _assemble(self) -> None:
        """zero3: gather every rank's row into the parameter buffer the
        module's parameters view."""
        self._full.untyped_storage().resize_(self._full_bytes)
        collective.all_gather_rows(self._row, out=self._full, group=self._data_group)

    def _release(self) -> None:
        """zero3: free the parameter buffer's storage (the module's
        parameters keep their shapes)."""
        self._full.untyped_storage().resize_(0)

    def _row_vector(self, tensors) -> torch.Tensor:
        """Tensors aligned with the rows -> this rank's row as one
        vector."""
        tensors = list(tensors)
        if len(tensors) == 1:
            return tensors[0].detach().reshape(-1)
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    def _split_row_vector(self, vec: torch.Tensor) -> list:
        """Inverse of :meth:`_row_vector`: views shaped as the rows."""
        out, off = [], 0
        for row in self._rows:
            out.append(vec[off : off + row.numel()].view(row.shape))
            off += row.numel()
        return out

    @property
    def zero_mode(self) -> str | None:
        """The storage mode: "zero3_blocks", "zero3", "zero1", or None
        (dense)."""
        if self.zero3_blocks is not None:
            return "zero3_blocks"
        if self.zero3:
            return "zero3"
        return "zero1" if self.zero1 else None

    def init_state(self) -> TrainState:
        zero = torch.zeros((), device=self.device)
        # The differenced carry: in rows under zero3_blocks, the empty
        # placeholder under zero1/zero3 at more than one replica (where
        # count > 1 never reads it), else parameter-shaped.
        if self.zero3_blocks is not None:
            carry = self._rows
        elif self.zero1 and self.num_replicas > 1:
            carry = gns.empty_prev_grad(list(self.model.parameters()))
        else:
            carry = list(self.model.parameters())
        return TrainState(
            model=self.model,
            optimizer=self.optimizer,
            gns=gns.init(carry, self.num_param_groups),
            progress=zero.clone(),
            step=zero.to(torch.int64),
            seed=self.seed,
        )

    def _seq_block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of dim 1 of a batch leaf of two or more dims
        under a seq axis (the JAX trainer's ``P(data, seq)`` spec); other
        leaves whole."""
        if self.seq_shards == 1 or t.dim() < 2:
            return t
        if t.shape[1] % self.seq_shards:
            raise ValueError(
                f"a batch leaf of shape {tuple(t.shape)} does not split its "
                f"dim 1 into {self.seq_shards} seq blocks"
            )
        width = t.shape[1] // self.seq_shards
        return t.narrow(1, self.mesh.index(pmesh.SEQ_AXIS) * width, width)

    def to_device(self, batch: dict) -> dict:
        """Host (numpy) batch -> this process's tensors on the trainer's
        device: under a seq axis each leaf's seq block."""
        return {
            k: self._seq_block(torch.as_tensor(np.asarray(v))).to(self.device)
            for k, v in batch.items()
        }

    def _generator(self, seed: int, step: int, micro: int) -> torch.Generator:
        """Microbatch ``micro`` of ``step``'s generator on this process:
        keyed by its data rank, and by its seq index under a seq axis."""
        return microbatch_generator(
            self.device, seed, step, micro, self.mesh.index(pmesh.DATA_AXIS),
            self.mesh.index(pmesh.SEQ_AXIS) if self.seq_shards > 1 else None,
        )

    def _precond(self):
        """Adam's preconditioner, per parameter (dense), per row
        (zero3_blocks: this rank's ``nu`` rows precondition its row
        gradients), or per parameter from ``nu`` reassembled from its
        rows (zero1, zero3)."""
        if self.precondition != "adam":
            return None
        nus = self.optimizer.second_moments()
        if self.zero1:
            flat = collective.all_gather_rows(nus[0], group=self._data_group)[: self.layout.n]
            nus = list(self.layout.tree(flat).values())
        return [torch.sqrt(torch.clamp(nu, min=0.0)) + 1e-8 for nu in nus]

    def train_step(self, atomic_bsz: int, accum_steps: int = 0) -> Callable:
        """``(state, batch[, aux]) -> (state, metrics)`` for this
        replica's block (on the device) of ``(accum_steps + 1) *
        atomic_bsz`` rows of the global batch; microbatch ``i`` is its
        ``i``-th run of ``atomic_bsz`` rows. ``aux`` (with ``has_aux``)
        reaches every microbatch's loss whole."""

        def step(state: TrainState, batch: dict, aux: Any = None):
            if self.zero3_blocks is not None:
                return self._step_z3b(state, batch, atomic_bsz, accum_steps, aux)
            if not self.zero3:
                return self._step(state, batch, atomic_bsz, accum_steps, aux)
            self._assemble()
            try:
                return self._step(state, batch, atomic_bsz, accum_steps, aux)
            finally:
                self._release()

        return step

    def _loss(self, micro: dict, generator: torch.Generator, aux: Any):
        params = self.model
        if self.zero3_blocks is not None:
            params = zero3.build_view(self._blocks_row, self._other_row, self._spec)
        if self.has_aux:
            return self.loss_fn(params, micro, generator, aux)
        return self.loss_fn(params, micro, generator)

    def _microbatches(self, batch, atomic_bsz, num_micro, state, aux, on_grads):
        """Forward and backward of each microbatch in order; ``on_grads
        (grads, loss)`` takes each one's float32 gradients."""
        for i in range(num_micro):
            micro = {
                k: v[i * atomic_bsz : (i + 1) * atomic_bsz]
                for k, v in batch.items()
            }
            generator = self._generator(state.seed, state.host_step, i)
            loss = self._loss(micro, generator, aux)
            grads = [g.float() for g in torch.autograd.grad(loss, self._params)]
            on_grads(grads, loss)

    def _finish(self, state, new_gns, scale, batch_size, loss, step_gain, lr_factor):
        new_state = replace(
            state,
            gns=new_gns,
            progress=state.progress + step_gain,
            step=state.step + 1,
            host_step=state.host_step + 1,
        )
        return new_state, {
            "loss": loss,
            "gain": step_gain,
            "lr_factor": lr_factor,
            "grad_sqr": gns.sqr_avg(new_gns),
            "grad_var": gns.var_avg(new_gns),
            "progress": new_state.progress,
            "scale": torch.tensor(scale, device=self.device),
        }

    def _rule(self, state, new_gns, scale, batch_size):
        ctx = RuleContext(
            scale=scale,
            batch_size=batch_size,
            init_batch_size=self.init_batch_size,
            gns_state=new_gns,
            progress=state.progress,
        )
        return (
            gns.gain(new_gns, scale),
            self.scaling_rule.lr_factor(ctx),
            self.scaling_rule.lr_factor_groups(ctx),
        )

    def _step(self, state: TrainState, batch: dict, atomic_bsz: int,
              accum_steps: int, aux: Any = None):
        """The data-parallel step (dense, zero1 and zero3)."""
        num_micro = accum_steps + 1
        count = self.num_replicas * num_micro
        accum_scale = self.num_replicas * atomic_bsz / self.init_batch_size
        scale = accum_scale * num_micro
        batch_size = self.num_replicas * num_micro * atomic_bsz
        precond = self._precond()
        acc = {
            "grads": None,
            "lsqr": torch.zeros(self.num_param_groups, device=self.device),
            "loss": torch.zeros((), device=self.device),
        }

        def on_grads(grads, loss):
            loss = loss.detach().float().reshape(1)
            self._sum_replicated_over_stages(grads)
            if self.seq_shards > 1:
                # A seq group is one logical replica: average its shard
                # gradients and losses before the noise statistics, so
                # they see whole-sample gradients.
                collective.allreduce_mean(
                    grads + [loss], group=self.mesh.group(pmesh.SEQ_AXIS)
                )
            acc["lsqr"] = acc["lsqr"] + self._stat_normsqr(grads, precond)
            acc["loss"] = acc["loss"] + loss[0]
            if acc["grads"] is None:
                acc["grads"] = grads
            else:
                for total, g in zip(acc["grads"], grads):
                    total.add_(g)

        with record_function(RANGE_MICROBATCHES):
            self._microbatches(batch, atomic_bsz, num_micro, state, aux, on_grads)
        with record_function(RANGE_STATISTICS):
            grads = [g.div_(num_micro) for g in acc["grads"]]
            local_sqr_mean = acc["lsqr"] / num_micro
            loss = acc["loss"] / num_micro
            # The one all-reduce point: gradients, with the two noise
            # scalars and the loss riding along in one flat buffer
            # (under zero1/zero3 with the row's padding before them).
            # The data-parallel mean runs over this rank's data row: each
            # shard averages with the same shard of the other replicas.
            if self.zero1:
                pad = torch.zeros(
                    self.layout.row_len(self.num_replicas) * self.num_replicas
                    - self.layout.n, device=self.device,
                )
                flat = collective.allreduce_mean_packed(
                    grads + [pad, local_sqr_mean, loss], group=self._data_group
                )
            else:
                collective.allreduce_mean(
                    grads + [local_sqr_mean, loss], group=self._data_group
                )
            new_gns = gns.update(
                state.gns,
                grads,
                local_sqr_mean,
                count=count,
                accum_scale=accum_scale,
                num_microbatches=num_micro,
                smoothing=self.smoothing,
                precond=precond,
                group_ids=self._group_ids,
                num_groups=self.num_param_groups,
                normsqr_fn=self._stat_normsqr,
            )
            step_gain, lr_factor, group_factors = self._rule(
                state, new_gns, scale, batch_size
            )
        with record_function(RANGE_OPTIMIZER):
            if self.zero1:
                self._zero1_update(flat, group_factors)
            else:
                for p, g in zip(self._params, grads):
                    p.grad = g
                self.optimizer.step(
                    [group_factors[gid] for gid in self._group_ids]
                )
                for p in self._params:
                    p.grad = None
        return self._finish(
            state, new_gns, scale, batch_size, loss, step_gain, lr_factor
        )

    def _zero1_update(self, flat_grads: torch.Tensor, group_factors) -> None:
        """Step this rank's row of the averaged flat gradient against the
        row moments, each position by its group's factor; under zero1
        gather every rank's updated row back into the parameters (under
        zero3 the row is the stored parameter)."""
        shard = self.layout.row_len(self.num_replicas)
        start = self._rank * shard
        self._row.grad = flat_grads[start : start + shard]
        if self._row_gids is None:
            factor = group_factors[0]
        else:
            factor = group_factors[self._row_gids]
        self.optimizer.step([factor])
        self._row.grad = None
        if not self.zero3:
            collective.all_gather_rows(self._row, out=self._full, group=self._data_group)

    def _step_z3b(self, state: TrainState, batch: dict, atomic_bsz: int,
                  accum_steps: int, aux: Any = None):
        """The zero3_blocks step: the loss is differentiated with respect
        to this rank's rows; each row gradient arrives as the sum over
        the data group (under a seq axis averaged over the seq group
        first, with the loss) and divided by dp is the averaged
        gradient, so no gradient all-reduce follows. The noise
        statistics count microbatches."""
        dp = self.num_replicas
        num_micro = accum_steps + 1
        accum_scale = dp * atomic_bsz / self.init_batch_size
        scale = accum_scale * num_micro
        batch_size = dp * num_micro * atomic_bsz
        precond = self._precond()
        acc = {"grads": None, "lsqr": [], "loss": torch.zeros((), device=self.device)}

        def on_grads(grads, loss):
            loss = loss.detach().float().reshape(1)
            if self.seq_shards > 1:
                collective.allreduce_mean(
                    grads + [loss], group=self.mesh.group(pmesh.SEQ_AXIS)
                )
            grads = [g / dp for g in grads]
            acc["lsqr"].append(gns.group_normsqr(grads, [0] * len(grads), 1, precond))
            acc["loss"] = acc["loss"] + loss[0]
            if acc["grads"] is None:
                acc["grads"] = grads
            else:
                for total, g in zip(acc["grads"], grads):
                    total.add_(g)

        with record_function(RANGE_MICROBATCHES):
            self._microbatches(batch, atomic_bsz, num_micro, state, aux, on_grads)
        with record_function(RANGE_STATISTICS):
            # Each microbatch's global squared norm and the loss, in one
            # all-reduce.
            scalars = collective.allreduce_sum(
                torch.cat(acc["lsqr"] + [acc["loss"].reshape(1)]),
                group=self._data_group,
            )
            lsqr_sum = torch.zeros(1, device=self.device)
            for i in range(num_micro):
                lsqr_sum = lsqr_sum + scalars[i : i + 1]
            loss = scalars[num_micro] / dp / num_micro
            grads = [g / num_micro for g in acc["grads"]]
            new_gns = gns.update(
                state.gns,
                grads,
                lsqr_sum / num_micro,
                count=num_micro,
                accum_scale=accum_scale,
                num_microbatches=num_micro,
                smoothing=self.smoothing,
                precond=precond,
                group_ids=[0] * len(grads),
                num_groups=1,
                normsqr_fn=functools.partial(gns.rows_normsqr, group=self._data_group),
            )
            step_gain, lr_factor, group_factors = self._rule(
                state, new_gns, scale, batch_size
            )
        with record_function(RANGE_OPTIMIZER):
            for row, g in zip(self._rows, grads):
                row.grad = g
            self.optimizer.step([group_factors[0]] * len(self._rows))
            for row in self._rows:
                row.grad = None
        return self._finish(
            state, new_gns, scale, batch_size, loss, step_gain, lr_factor
        )

    def params_tree(self, state: TrainState | None = None) -> dict:
        """A copy of the parameters as the name -> tensor tree, whatever
        the storage layout: what evaluation, export and analysis should
        read instead of the module's parameters, which zero3 and
        zero3_blocks release between steps, and the full logical tensors
        under a model or expert axis. Under zero3, zero3_blocks and those
        axes a collective every rank joins."""
        if self.zero3_blocks is not None:
            tree = zero3.assemble_tree(
                self._blocks_row, self._other_row, self.zero3_blocks, self._spec
            )
        elif self.zero3:
            tree = self.layout.tree(self.layout.gather(self._row, self._data_group))
        elif self.sharded:
            tree = {
                name: self.logical_tensor(i, p)
                for i, (name, p) in enumerate(self.model.named_parameters())
            }
            if self.stage_shards > 1:
                dense = self._stage_dense([tree[n] for n in self._names])
                tree = {n: dense[n] for n in self.model.dense_names()}
        else:
            tree = dict(self.model.named_parameters())
        return {n: p.detach().clone() for n, p in tree.items()}

    def eval_step(self, metric_fn: Callable) -> Callable:
        """``(state, batch) -> totals``: ``metric_fn(params, local_batch)``
        runs without gradients on each replica's block, with what the
        loss receives (the model; a ``Zero3View`` under zero3_blocks;
        under zero3 the parameters assembled for the call), and returns
        partial sums (name -> number or tensor); they are summed over the
        replicas (a model or expert group counts once: only its rank 0's
        sums enter). Every rank calls it."""

        def run(state: TrainState, batch: dict) -> dict:
            with torch.no_grad():
                if self.zero3:
                    self._assemble()
                try:
                    if self.zero3_blocks is not None:
                        params = zero3.build_view(
                            self._blocks_row, self._other_row, self._spec
                        )
                    else:
                        params = self.model
                    out = metric_fn(params, batch)
                finally:
                    if self.zero3:
                        self._release()
            local = {k: torch.as_tensor(v).detach().cpu() for k, v in out.items()}
            if any(self.mesh.index(axis) for axis in (
                pmesh.MODEL_AXIS, pmesh.STAGE_AXIS, pmesh.EXPERT_AXIS,
            )):
                # A model, stage or expert group computes one replica's sums.
                local = {k: torch.zeros_like(v) for k, v in local.items()}
            totals = collective.allreduce(
                local, lambda parts: {k: sum(p[k] for p in parts) for k in parts[0]}
            )
            return totals

        return run

    # ---- the canonical checkpoint layout (ZeRO modes) ------------------

    def _moment_keys(self) -> list:
        """The optimizer's row-shaped state entries (``exp_avg``,
        ``exp_avg_sq``; ``momentum_buffer``), once it has stepped."""
        state = self.optimizer.state.get(self._rows[0]) or {}
        return [k for k in state if k != "step"]

    def row_families(self, state: TrainState) -> dict:
        """This rank's row, as one vector, of every parameter-shaped
        family the checkpoints keep: ``params``, each moment, and under
        zero3_blocks the differenced carry ``prev_grad``."""
        families = {"params": self._row_vector(self._rows)}
        for key in self._moment_keys():
            families[key] = self._row_vector(
                [self.optimizer.state[row][key] for row in self._rows]
            )
        if self.zero3_blocks is not None:
            families["prev_grad"] = self._row_vector(state.gns.prev_grad)
        return families

    def small_state(self, state: TrainState) -> dict:
        """What the checkpoints keep beside the families: the noise
        statistics, progress, step, seed, group ids and the optimizer's
        step count."""
        fields = state.gns.tensors()
        fields.pop("prev_grad")
        row_state = self.optimizer.state.get(self._rows[0]) or {}
        return {
            "gns": fields,
            "progress": state.progress,
            "step": state.step,
            "seed": state.seed,
            "group_ids": list(self._group_ids),
            "param_names": list(self._names),
            "layout": self.zero_mode or "dense",
            "optimizer_step": row_state.get("step"),
        }

    def canonical_payload(self, state: TrainState) -> dict:
        """The ZeRO modes' checkpoint payload in the canonical layout:
        parameters as the plain tree (with the module's buffers), moments
        as flat ``[n]`` vectors in parameter order, the carry empty
        (zero1, zero3) or flat (zero3_blocks). A collective every rank
        joins (one all-gather per family)."""
        flat = {
            key: self.layout.gather(row, self._data_group)
            for key, row in self.row_families(state).items()
        }
        tree = dict(self.layout.tree(flat.pop("params")))
        if self.zero3_blocks is None:
            names = set(self._names)
            tree.update(
                (k, v) for k, v in self.model.state_dict().items() if k not in names
            )
            carry = gns.empty_prev_grad(list(self.model.parameters()))
        else:
            carry = [flat.pop("prev_grad")]
        small = self.small_state(state)
        step = small.pop("optimizer_step")
        return {
            "model": tree,
            "optimizer": {
                "flat_state": flat,
                "scalar_state": {} if step is None else {"step": step},
            },
            "prev_grad": carry,
            **small,
        }

    def _adopt_tree(self, tree: dict) -> dict:
        """A checkpoint's parameter tree under this trainer's names: as
        is, or (zero3_blocks) a dense LM's separate layers stacked."""
        if set(tree) == set(self.layout.names):
            return tree
        if self.zero3_blocks is not None:
            stacked = zero3.stack_layers(tree, self._spec)
            if stacked is not None:
                return stacked
        raise ValueError(
            "the checkpoint's parameters differ from this trainer's: "
            f"{sorted(set(tree) ^ set(self.layout.names))[:4]}"
        )

    def install_rows(self, rows: dict, step) -> None:
        """Install this rank's rows of each moment (family -> row vector
        at this incarnation's replica count), the optimizer's step count
        and the parameters: this rank's row, or under zero1 the whole
        flat canonical vector (zero1 keeps every parameter). No
        collective: each rank restores on its own."""
        device = self.device
        with torch.no_grad():
            params = rows["params"].float().to(device)
            if self.zero1 and not self.zero3:
                self._full[: self.layout.n].copy_(params[: self.layout.n])
            else:
                for dst, src in zip(self._rows, self._split_row_vector(params)):
                    dst.copy_(src)
        for r in self._rows:
            self.optimizer.state[r] = {}
        moments = {k: v for k, v in rows.items() if k not in ("params", "prev_grad")}
        for key, vec in moments.items():
            parts = self._split_row_vector(vec.float().to(device))
            for r, part in zip(self._rows, parts):
                self.optimizer.state[r][key] = part.clone()
        if moments and step is not None:
            for r in self._rows:
                self.optimizer.state[r]["step"] = (
                    torch.as_tensor(step).float().to(device).clone()
                )

    def restored_carry(self, layout: str, prev_row, valid) -> tuple[list, torch.Tensor]:
        """The differenced carry after a restore: zero3_blocks takes a
        zero3_blocks checkpoint's carry (``prev_row``, this rank's row)
        and re-primes after any other; zero1 and zero3 keep the
        placeholder at more than one replica and re-prime at one."""
        device = self.device
        invalid = torch.zeros((), dtype=torch.bool, device=device)
        if self.zero3_blocks is not None:
            if layout == "zero3_blocks" and prev_row is not None:
                carry = self._split_row_vector(prev_row.float().to(device))
                return [c.clone() for c in carry], torch.as_tensor(valid).to(device)
            return [torch.zeros_like(r) for r in self._rows], invalid
        params = list(self.model.parameters())
        if self.num_replicas > 1:
            return gns.empty_prev_grad(params), torch.as_tensor(valid).to(device)
        return [torch.zeros(p.shape, device=device) for p in params], invalid

    def restore_payload(self, payload: dict) -> tuple[list, torch.Tensor]:
        """Restore a checkpoint payload (canonical, or a dense trainer's)
        into this ZeRO-mode trainer's rows and optimizer; returns the
        differenced carry and its validity for this mode and replica
        count."""
        saved_names = payload.get("param_names") or list(payload["model"])
        model_tree = payload["model"]
        shapes = [tuple(model_tree[n].shape) for n in saved_names]
        saved = RowLayout(saved_names, shapes)
        dp, rank = self.num_replicas, self._rank

        def row(values: dict) -> torch.Tensor:
            flat = self.layout.ravel(self._adopt_tree(values))
            return self.layout.row_from_flat(flat, rank, dp)

        params = {n: model_tree[n] for n in saved_names}
        rows = {"params": (
            self.layout.ravel(self._adopt_tree(params))
            if self.zero1 and not self.zero3 else row(params)
        )}
        opt = payload["optimizer"]
        if "flat_state" in opt:
            for key, flat in opt["flat_state"].items():
                rows[key] = row(saved.tree(flat))
            step = opt["scalar_state"].get("step")
        else:
            # A dense trainer's optimizer: one entry per parameter.
            per = opt.get("state", {})
            entries = [per[i] for i in sorted(per)]
            keys = [k for k in (entries[0] if entries else {}) if k != "step"]
            for key in keys:
                rows[key] = row({n: e[key] for n, e in zip(saved_names, entries)})
            step = entries[0].get("step") if entries else None
        self.install_rows(rows, step)
        layout = payload.get("layout") or "dense"
        prev, valid = payload["prev_grad"], payload["gns"]["prev_grad_valid"]
        if layout == "zero3_blocks":
            return self.restored_carry(
                layout, self.layout.row_from_flat(prev[0].float(), rank, dp), valid
            )
        if (
            self.zero3_blocks is None and dp == 1 and layout == "dense"
            and not gns.is_placeholder(prev, shapes)
        ):
            tree = self._adopt_tree(dict(zip(saved_names, prev)))
            return (
                [tree[n].float().to(self.device) for n in self.layout.names],
                torch.as_tensor(valid).to(self.device),
            )
        return self.restored_carry(layout, None, valid)

    def check_group_ids(self, saved_ids) -> None:
        if (
            saved_ids is not None
            and max(saved_ids, default=0) > 0
            and list(saved_ids) != self._group_ids
        ):
            raise ValueError(
                "the checkpoint's parameter groups differ from this "
                "trainer's param_group_fn"
            )

    def restored_state(self, state: TrainState, small: dict, carry, valid=None) -> TrainState:
        """The TrainState a restore lands on: ``small``'s noise
        statistics (one group seeds every group of this trainer),
        progress, step and seed, with the differenced ``carry`` (and its
        validity, when the restore decided it)."""
        device = self.device
        fields = {k: torch.as_tensor(v).to(device) for k, v in small["gns"].items()}
        if valid is not None:
            fields["prev_grad_valid"] = torch.as_tensor(valid).to(device)
        restored = gns.normalize_groups(
            gns.GNSState(**fields, prev_grad=carry), self.num_param_groups
        )
        step = torch.as_tensor(small["step"])
        return replace(
            state,
            gns=restored,
            progress=torch.as_tensor(small["progress"]).float().to(device),
            step=step.to(torch.int64).to(device),
            seed=small.get("seed", state.seed),
            host_step=int(step),
        )

    def calibrate_accum_time(
        self, host_batch: Any, atomic_bsz: int, aux: Any = None
    ) -> float:
        """Time one microbatch forward and backward with no gradient
        sync (the best of ``calibrate_repeats`` runs after a warm-up)
        and record it for the performance model. ``host_batch`` is this
        process's block; one microbatch takes its share of it. Under
        zero3 the parameters are assembled for the runs; under
        zero3_blocks the runs differentiate with respect to the rows,
        through the gathers the step runs."""
        micro = self.to_device(
            {k: v[:atomic_bsz] for k, v in host_batch.items()}
        )
        generator = self._generator(self.seed, CALIBRATION_STEP, 0)

        def run():
            loss = self._loss(micro, generator, aux)
            grads = torch.autograd.grad(loss, self._params)
            return gns.normsqr(grads) + loss.detach()

        if self.zero3:
            self._assemble()
        try:
            run()
            _sync(self.device)
            best = float("inf")
            for _ in range(self.calibrate_repeats):
                start = time.perf_counter()
                run()
                _sync(self.device)
                best = min(best, time.perf_counter() - start)
        finally:
            if self.zero3:
                self._release()
        metrics.profile_accum_time(atomic_bsz, best)
        return best

    def run_step(
        self, state: TrainState, host_batch: Any, dataloader, aux: Any = None
    ):
        """One elastic step wired to the dataloader's current config:
        calibrates new batch sizes, runs the step, and every
        ``metrics_every`` steps feeds the noise statistics and progress
        back to the metrics engine and lets the numeric-health guard
        grade the step. ``aux`` is forwarded to the loss when the
        trainer was built with ``has_aux=True``. After a guard rollback
        it returns the restored state (the one the trainer's checkpoint
        state just set). The trailing partial batch of a
        ``drop_last=False`` loader steps as one microbatch of the rows
        it holds, with no calibration."""
        if env.num_replicas() != self.num_replicas:
            raise RuntimeError(
                f"ADAPTDL_NUM_REPLICAS={env.num_replicas()} but the "
                f"trainer runs {self.num_replicas} replica(s)"
            )
        atomic_bsz = dataloader.current_atomic_bsz
        accum_steps = dataloader.current_accum_steps
        rows = len(next(iter(host_batch.values())))
        if rows < atomic_bsz * (accum_steps + 1):
            atomic_bsz, accum_steps = rows, 0
        elif atomic_bsz not in self._calibrated:
            self.calibrate_accum_time(host_batch, atomic_bsz, aux)
            self._calibrated.add(atomic_bsz)
        state, out = self.train_step(atomic_bsz, accum_steps)(
            state, self.to_device(host_batch), aux
        )
        self._steps_since_pull += 1
        if self._steps_since_pull >= self.metrics_every:
            self._steps_since_pull = 0
            loss = float(out["loss"])
            grad_sqr = float(out["grad_sqr"])
            grad_var = float(out["grad_var"])
            metrics.update_grad_params(grad_sqr, grad_var)
            metrics.update_progress(float(out["progress"]))
            # The detection latency is metrics_every steps, by this gate.
            self._restored_state = None
            verdict = guard.observe_step(
                loss, grad_sqr=grad_sqr, grad_var=grad_var,
                dataloader=dataloader,
            )
            restored = self._restored_state
            if verdict["restored"] is not None and restored is not None:
                state = restored
        return state, out

    def make_checkpoint_state(
        self,
        get_state: Callable[[], TrainState],
        set_state: Callable[[TrainState], None],
        name: str = "elastic_trainer",
    ) -> "TrainerCheckpoint":
        return TrainerCheckpoint(name, self, get_state, set_state)


class TrainerCheckpoint(checkpoint.State):
    """Persists a TrainState device-agnostically: ``torch.save`` writes
    every tensor bit for bit, and a restore lands on the current
    trainer's device.

    The snapshot copies every tensor into a host buffer kept across
    saves (pinned for a device tensor: one ``non_blocking`` copy each,
    then one synchronize), so a periodic save blocks the step loop for
    the copy alone and allocates no host memory after the first. The
    write serializes those copies. For the handoff the snapshot splits
    into one chunk per tensor (its raw bytes) and a ``meta`` chunk, JSON
    of the structure, dtypes and shapes: what the successor reads from
    the peer is data, never code, as ``torch.load(weights_only=True)``
    reads storage."""

    def __init__(self, name, trainer: ElasticTrainer, get_state, set_state):
        super().__init__(name)
        self._trainer = trainer
        self._get_state = get_state
        self._set_state = set_state
        self._host: list[torch.Tensor] = []
        self._synced: dict | None = None

    @property
    def host_buffer_bytes(self) -> int:
        """Bytes of the reused host buffers (pinned for device tensors)."""
        return sum(t.numel() * t.element_size() for t in self._host)

    def _payload(self) -> dict:
        state = self._get_state()
        trainer = self._trainer
        if trainer.zero_mode is not None or trainer.sharded:
            synced, self._synced = self._synced, None
            if synced is not None:
                return synced
            if collective.world_size() > 1:
                raise RuntimeError(
                    "a ZeRO-mode or model/expert/stage-sharded checkpoint gathers "
                    "its rows or shards in sync(), which every rank runs "
                    "before the snapshot"
                )
            return trainer.canonical_payload(state)
        return self._dense_payload(state)

    def _dense_payload(self, state: TrainState) -> dict:
        """The dense trainer's payload of this rank's own tensors."""
        trainer = self._trainer
        fields = state.gns.tensors()
        return {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "prev_grad": fields.pop("prev_grad"),
            "gns": fields,
            "progress": state.progress,
            "step": state.step,
            "seed": state.seed,
            "group_ids": list(trainer._group_ids),
            "param_names": list(trainer._names),
            "layout": "dense",
        }

    def sync(self) -> None:
        """Every rank: under a ZeRO mode, join the gather of the rows to
        the canonical layout; under a model, expert or stage axis, the
        gather of the shards to the full logical tensors (under the dense
        LM's names). Rank 0's snapshot then
        copies it (the snapshot issues no collective)."""
        trainer = self._trainer
        if trainer.zero_mode is not None:
            payload = trainer.canonical_payload(self._get_state())
        elif trainer.sharded:
            payload = trainer.logical_payload(self._dense_payload(self._get_state()))
        else:
            return
        # Only rank 0 snapshots it; the others joined the gather.
        writes = env.replica_rank() == 0 and env.checkpoint_path() is not None
        self._synced = payload if writes else None

    def snapshot(self) -> dict:
        tensors: list[torch.Tensor] = []
        payload = self._payload()
        _map_tensors(payload, tensors.append)
        fits = len(self._host) == len(tensors) and all(
            h.shape == t.shape and h.dtype == t.dtype
            for h, t in zip(self._host, tensors)
        )
        if not fits:
            self._host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                for t in tensors
            ]
        for host, t in zip(self._host, tensors):
            host.copy_(t.detach(), non_blocking=t.is_cuda)
        if any(t.is_cuda for t in tensors):
            torch.cuda.synchronize(self._trainer.device)
        host = iter(self._host)
        return _map_tensors(payload, lambda t: next(host))

    def write_snapshot(self, snapshot: dict, fileobj) -> None:
        torch.save(snapshot, fileobj)

    def save(self, fileobj):
        self.write_snapshot(self.snapshot(), fileobj)

    def load(self, fileobj):
        self._apply(torch.load(fileobj, map_location="cpu", weights_only=True))

    def snapshot_chunks(self, snapshot: dict) -> list:
        tensors: list[torch.Tensor] = []
        meta = json.dumps(_encode_meta(snapshot, tensors)).encode()
        return [("meta", meta)] + [
            (f"t{i}", t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
            for i, t in enumerate(tensors)
        ]

    def load_chunks(self, chunks: list) -> None:
        data = dict(chunks)

        def rebuild(index, dtype_name, shape):
            dtype = getattr(torch, str(dtype_name), None)
            if not isinstance(dtype, torch.dtype):
                raise ValueError(f"handoff meta names no dtype: {dtype_name!r}")
            raw = data[f"t{int(index)}"]
            flat = (
                torch.frombuffer(bytearray(raw), dtype=torch.uint8)
                if raw else torch.empty(0, dtype=torch.uint8)
            )
            return flat.view(dtype).reshape([int(n) for n in shape])

        self._apply(_decode_meta(json.loads(data["meta"]), rebuild))

    def _apply(self, payload: dict) -> None:
        trainer = self._trainer
        device = trainer.device
        if trainer.zero_mode is None:
            if payload.get("layout", "dense") != "dense":
                raise ValueError(
                    f"a {payload['layout']} checkpoint restores into a "
                    "trainer of the ZeRO family, not a dense one"
                )
            if trainer.sharded:
                payload = trainer.local_payload(payload)
        trainer.check_group_ids(payload.get("group_ids"))
        state = self._get_state()
        valid = None
        if trainer.zero_mode is not None:
            carry, valid = trainer.restore_payload(payload)
        else:
            state.model.load_state_dict(payload["model"])
            state.optimizer.load_state_dict(payload["optimizer"])
            carry = [t.to(device) for t in payload["prev_grad"]]
        new_state = trainer.restored_state(state, payload, carry, valid)
        self._set_state(new_state)
        trainer._restored_state = new_state


def _encode_meta(obj, tensors: list):
    """``obj`` (dicts, lists, tuples, tensors and JSON scalars) as JSON
    data; each tensor goes to ``tensors`` and is replaced by its index,
    dtype and shape. Containers are tagged so that tuples and non-string
    keys (an optimizer's parameter ids) come back as they were."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return {"tensor": [len(tensors) - 1, str(obj.dtype)[6:], list(obj.shape)]}
    if isinstance(obj, dict):
        return {"dict": [
            [_encode_meta(k, tensors), _encode_meta(v, tensors)]
            for k, v in obj.items()
        ]}
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return {kind: [_encode_meta(v, tensors) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"the handoff cannot carry a {type(obj).__name__}")


def _decode_meta(node, rebuild):
    """Invert :func:`_encode_meta`, each tensor from ``rebuild(index,
    dtype, shape)``; raises on anything it did not write."""
    if isinstance(node, dict) and len(node) == 1:
        (kind, items), = node.items()
        if kind == "tensor":
            return rebuild(*items)
        if kind == "dict":
            return {
                _decode_meta(k, rebuild): _decode_meta(v, rebuild)
                for k, v in items
            }
        if kind in ("list", "tuple"):
            values = [_decode_meta(v, rebuild) for v in items]
            return values if kind == "list" else tuple(values)
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    raise ValueError(f"malformed handoff meta: {str(node)[:80]}")


def _map_tensors(obj, fn):
    """``obj`` with every tensor inside dicts, lists and tuples replaced
    by ``fn(tensor)``, visited in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return type(obj)((k, _map_tensors(v, fn)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj
