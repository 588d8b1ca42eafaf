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
  buffer (the identity with one replica);
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
microbatch index and the replica rank, so a restart (which restores the
step and the seed) draws the same numbers. The two packages' random
streams differ; only the port's own draws repeat.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from adaptdl_tpu_torch import checkpoint, collective, env, gns, guard, metrics
from adaptdl_tpu_torch.device import resolve_device
from adaptdl_tpu_torch.optim import SGD, AdamW
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
    device: torch.device, seed: int, step: int, micro: int, rank: int
) -> torch.Generator:
    """The generator of microbatch ``micro`` of ``step`` on replica
    ``rank``: a fresh generator on ``device`` seeded by a hash of the
    four integers."""
    entropy = np.random.SeedSequence([seed, step, micro, rank])
    generator = torch.Generator(device=device)
    generator.manual_seed(int(entropy.generate_state(1, np.uint64)[0]))
    return generator


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

    Each of ``ADAPTDL_NUM_REPLICAS`` replicas is one process of the
    job's process group (``initialize_job`` joins it), stepping on its
    own block of each global batch. ``zero1``, ``zero3``,
    ``zero3_blocks`` and a ``mesh`` belong to parallel modes not ported
    yet and raise, as do sharded axes in the environment.
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
    ):
        if zero1 or zero3 or zero3_blocks is not None or mesh is not None:
            raise NotImplementedError(
                "zero1/zero3/zero3_blocks and device meshes are not "
                "ported yet; the port runs the data-parallel step only"
            )
        sharded = {
            "ADAPTDL_SEQ_SHARDS": env.seq_shards(),
            "ADAPTDL_MODEL_SHARDS": env.model_shards(),
            "ADAPTDL_STAGE_SHARDS": env.stage_shards(),
            "ADAPTDL_EXPERT_SHARDS": env.expert_shards(),
        }
        if any(v > 1 for v in sharded.values()):
            raise NotImplementedError(
                f"sharded axes are not ported yet: {sharded}"
            )
        num_replicas = env.num_replicas()
        if num_replicas != env.num_processes():
            raise NotImplementedError(
                "multi-replica data parallelism runs one process per "
                f"replica; ADAPTDL_NUM_REPLICAS={num_replicas} over "
                f"ADAPTDL_NUM_PROCESSES={env.num_processes()} would hold "
                "several replicas in one process"
            )
        if collective.world_size() != num_replicas:
            raise RuntimeError(
                f"ADAPTDL_NUM_REPLICAS={num_replicas} but the process "
                f"group holds {collective.world_size()} replica(s); call "
                "initialize_job() first"
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
        self.loss_fn = loss_fn
        self.model = model
        self.optimizer = optimizer
        self.init_batch_size = init_batch_size
        self.scaling_rule = scaling_rule or ScalingRule()
        self.precondition = precondition
        self.smoothing = smoothing
        self.seed = seed
        self.has_aux = has_aux
        self.num_replicas = num_replicas
        metrics.set_active_topology()
        self._calibrated: set[int] = set()
        # One warm-up run plus this many timed runs per calibration.
        self.calibrate_repeats = 3
        # How often run_step reads the statistics back to the host.
        self.metrics_every = 10
        self._steps_since_pull = self.metrics_every - 1  # pull early once
        # The state the last restore of a TrainerCheckpoint of this
        # trainer set (what run_step hands back after a rollback).
        self._restored_state: TrainState | None = None

    def init_state(self) -> TrainState:
        zero = torch.zeros((), device=self.device)
        return TrainState(
            model=self.model,
            optimizer=self.optimizer,
            gns=gns.init(self._params, self.num_param_groups),
            progress=zero.clone(),
            step=zero.to(torch.int64),
            seed=self.seed,
        )

    def to_device(self, batch: dict) -> dict:
        """Host (numpy) batch -> tensors on the trainer's device."""
        return {
            k: torch.as_tensor(np.asarray(v)).to(self.device)
            for k, v in batch.items()
        }

    def _precond(self):
        if self.precondition != "adam":
            return None
        return [
            torch.sqrt(torch.clamp(nu, min=0.0)) + 1e-8
            for nu in self.optimizer.second_moments()
        ]

    def train_step(self, atomic_bsz: int, accum_steps: int = 0) -> Callable:
        """``(state, batch[, aux]) -> (state, metrics)`` for this
        replica's block (on the device) of ``(accum_steps + 1) *
        atomic_bsz`` rows of the global batch; microbatch ``i`` is its
        ``i``-th run of ``atomic_bsz`` rows. ``aux`` (with ``has_aux``)
        reaches every microbatch's loss whole."""

        def step(state: TrainState, batch: dict, aux: Any = None):
            return self._step(state, batch, atomic_bsz, accum_steps, aux)

        return step

    def _loss(self, micro: dict, generator: torch.Generator, aux: Any):
        if self.has_aux:
            return self.loss_fn(self.model, micro, generator, aux)
        return self.loss_fn(self.model, micro, generator)

    def _step(self, state: TrainState, batch: dict, atomic_bsz: int,
              accum_steps: int, aux: Any = None):
        num_micro = accum_steps + 1
        count = self.num_replicas * num_micro
        accum_scale = self.num_replicas * atomic_bsz / self.init_batch_size
        scale = accum_scale * num_micro
        batch_size = self.num_replicas * num_micro * atomic_bsz
        precond = self._precond()
        rank = env.replica_rank()
        grad_sum = None
        lsqr_sum = torch.zeros(self.num_param_groups, device=self.device)
        loss_sum = torch.zeros((), device=self.device)
        with record_function(RANGE_MICROBATCHES):
            for i in range(num_micro):
                micro = {
                    k: v[i * atomic_bsz : (i + 1) * atomic_bsz]
                    for k, v in batch.items()
                }
                generator = microbatch_generator(
                    self.device, state.seed, state.host_step, i, rank
                )
                loss = self._loss(micro, generator, aux)
                grads = [
                    g.float()
                    for g in torch.autograd.grad(loss, self._params)
                ]
                lsqr_sum = lsqr_sum + gns.group_normsqr(
                    grads, self._group_ids, self.num_param_groups, precond
                )
                loss_sum = loss_sum + loss.detach().float()
                if grad_sum is None:
                    grad_sum = grads
                else:
                    for acc, g in zip(grad_sum, grads):
                        acc.add_(g)
        with record_function(RANGE_STATISTICS):
            grads = [g.div_(num_micro) for g in grad_sum]
            local_sqr_mean = lsqr_sum / num_micro
            loss = loss_sum / num_micro
            # The one all-reduce point: gradients, with the two noise
            # scalars and the loss riding along in one flat buffer.
            collective.allreduce_mean(grads + [local_sqr_mean, loss])
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
            )
            step_gain = gns.gain(new_gns, scale)
            ctx = RuleContext(
                scale=scale,
                batch_size=batch_size,
                init_batch_size=self.init_batch_size,
                gns_state=new_gns,
                progress=state.progress,
            )
            lr_factor = self.scaling_rule.lr_factor(ctx)
            group_factors = self.scaling_rule.lr_factor_groups(ctx)
        with record_function(RANGE_OPTIMIZER):
            for p, g in zip(self._params, grads):
                p.grad = g
            self.optimizer.step(
                [group_factors[gid] for gid in self._group_ids]
            )
            for p in self._params:
                p.grad = None
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

    def calibrate_accum_time(
        self, host_batch: Any, atomic_bsz: int, aux: Any = None
    ) -> float:
        """Time one microbatch forward and backward with no gradient
        sync (the best of ``calibrate_repeats`` runs after a warm-up)
        and record it for the performance model. ``host_batch`` is this
        process's block; one microbatch takes its share of it."""
        local_rows = self.num_replicas * atomic_bsz // env.num_processes()
        micro = self.to_device(
            {k: v[:local_rows] for k, v in host_batch.items()}
        )
        generator = microbatch_generator(
            self.device, self.seed, CALIBRATION_STEP, 0, env.replica_rank()
        )

        def run():
            loss = self._loss(micro, generator, aux)
            grads = torch.autograd.grad(loss, self._params)
            return gns.normsqr(grads) + loss.detach()

        run()
        _sync(self.device)
        best = float("inf")
        for _ in range(self.calibrate_repeats):
            start = time.perf_counter()
            run()
            _sync(self.device)
            best = min(best, time.perf_counter() - start)
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

    @property
    def host_buffer_bytes(self) -> int:
        """Bytes of the reused host buffers (pinned for device tensors)."""
        return sum(t.numel() * t.element_size() for t in self._host)

    def _payload(self) -> dict:
        state = self._get_state()
        fields = state.gns.tensors()
        return {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "prev_grad": fields.pop("prev_grad"),
            "gns": fields,
            "progress": state.progress,
            "step": state.step,
            "seed": state.seed,
            "group_ids": list(self._trainer._group_ids),
        }

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
        saved_ids = payload.get("group_ids")
        if (
            saved_ids is not None
            and max(saved_ids, default=0) > 0
            and list(saved_ids) != trainer._group_ids
        ):
            raise ValueError(
                "the checkpoint's parameter groups differ from this "
                "trainer's param_group_fn"
            )
        state = self._get_state()
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        # A checkpoint with one group seeds every group of this trainer.
        restored = gns.normalize_groups(
            gns.GNSState(
                **{k: v.to(device) for k, v in payload["gns"].items()},
                prev_grad=[t.to(device) for t in payload["prev_grad"]],
            ),
            trainer.num_param_groups,
        )
        new_state = replace(
            state,
            gns=restored,
            progress=payload["progress"].to(device),
            step=payload["step"].to(device),
            seed=payload.get("seed", state.seed),
            host_step=int(payload["step"]),
        )
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
