"""Elastic, adaptive-batch-size data loader, the port of ``adaptdl_tpu.data``.

``AdaptiveDataLoader`` is the user's inner loop:

- **ElasticSampler**: deterministic epoch shuffling; partitions the
  *remaining* samples of an epoch, so a job restarted mid-epoch picks
  up exactly where it stopped.
- **adaptive batch size**: each loop entry (and every
  ``_reoptimize_every`` steps) re-optimizes (atomic_bsz, accum_steps):
  the supervisor's published decision (``batchConfig`` of ``/config``)
  when it has one for this allocation, else the fitted goodput function,
  adopting a new configuration only for a >5% predicted speedup; rank 0
  decides and broadcasts. Candidate atomic sizes are bucketed (multiples
  of 8 below 128, of 64 above) so the set of step shapes stays small.
- **poisoned ranges**: the numeric-health guard records the span of a
  batch it condemned (:meth:`AdaptiveDataLoader.add_skip_range`); the
  sampler jumps past it from then on, and the table is checkpointed.
- **graceful preemption**: once per step the loader agrees on the
  SIGTERM flag across replicas, overlapped with the step; once set, it
  checkpoints every state (the urgent drain under a preemption notice,
  else a blocking save that may leave a handoff server behind) and
  exits with code 143.
- **periodic saves** (``ADAPTDL_CKPT_EVERY_STEPS``) block for their
  snapshot only; the write runs on a thread.
- **replay**: loops finished before a restart are skipped; the
  interrupted loop resumes at its saved position.

Each global batch holds ``num_replicas * (accum_steps + 1) * atomic_bsz``
rows, shuffled per epoch (``shuffle``, from ``seed``); a partial
trailing batch is dropped unless ``drop_last=False``, which yields it
(the trainer steps it as one microbatch of the rows it holds). With one
process per replica, each process yields only its own contiguous,
replica-major block of the batch's rows (numpy); the trainer moves it to
its device. A dataset is a dict of equal-length arrays, or any
indexable of samples (dicts, tuples or arrays, stacked per batch). Each
loader checkpoints under its own ``name``.
"""

from __future__ import annotations

import logging
import pickle
import sys
import time
import weakref
from typing import Any, Iterator

import numpy as np

from adaptdl_tpu_torch import (
    _signal,
    checkpoint,
    collective,
    env,
    handoff,
    metrics,
    sched_hints,
)
from adaptdl_tpu_torch.sched import preemption

LOG = logging.getLogger(__name__)

SPEEDUP_THRESHOLD = 1.05
_current_dataloader: "AdaptiveDataLoader | None" = None
# The loader that sizes the job: its batch-size configuration is the one
# the metrics and hints carry, and its steps alone are profiled.
_job_sizer: "weakref.ref[AdaptiveDataLoader] | None" = None


def _grid_step(atomic_bsz: int) -> int:
    return 1 if atomic_bsz <= 8 else 8 if atomic_bsz <= 128 else 64


def bucket_atomic_bsz(
    atomic_bsz: int, minimum: int = 1, maximum: int | None = None
) -> int:
    """Round a candidate atomic batch size DOWN onto the bucket grid,
    keeping every cap the goodput optimizer already enforced; where that
    falls below ``minimum``, take the least grid point at or above
    ``minimum`` instead, if it is at most ``maximum``. Where no grid
    point lies in [minimum, maximum], the candidate stays off the grid
    (clipped into the range)."""
    step = _grid_step(atomic_bsz)
    bucket = max(int(atomic_bsz) // step * step, 1)
    if bucket >= minimum:
        return bucket
    step = _grid_step(minimum)
    bucket = -(-int(minimum) // step) * step
    if maximum is None or bucket <= maximum:
        return bucket
    return int(min(max(int(atomic_bsz), int(minimum)), int(maximum)))


class ElasticSampler:
    """Deterministic per-epoch shuffle (from ``(seed, epoch)``; the
    identity order without ``shuffle``); ``index`` counts the samples of
    the epoch already consumed."""

    def __init__(self, dataset_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset_size = dataset_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.index = 0  # samples of this epoch already consumed
        self._perm_cache: tuple[int, np.ndarray] | None = None

    def set_position(self, epoch: int, index: int) -> None:
        self.epoch = epoch
        self.index = index

    def _permutation(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.dataset_size)
        if self._perm_cache is None or self._perm_cache[0] != self.epoch:
            rng = np.random.default_rng((self.seed, self.epoch))
            self._perm_cache = (self.epoch, rng.permutation(self.dataset_size))
        return self._perm_cache[1]

    def remaining(self) -> int:
        return max(self.dataset_size - self.index, 0)

    def next_indices(self, count: int) -> np.ndarray:
        return self._permutation()[self.index : self.index + count]


class AdaptiveDataLoader:
    """Iterates global batches with adaptive sizing and elasticity.

    Args:
      dataset: a dict of equal-length numpy arrays, or an indexable
        with ``len`` whose ``dataset[i]`` is a sample (a dict, tuple or
        array).
      batch_size: the initial (and LR-reference) global batch size.
      shuffle: deterministic per-epoch shuffling.
      drop_last: drop the trailing partial batch; with False it is
        yielded (a multi-process job needs it to split evenly).
      seed: seeds the per-epoch shuffle.
      name: checkpoint state name, one per loader of a job.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        name: str = "adaptdl_dataloader",
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._size = _dataset_size(dataset)
        self.sampler = ElasticSampler(self._size, shuffle, seed)
        self._max_batch_size: int | None = None
        self._local_bsz_bounds: tuple[int, int] | None = None
        self._gradient_accumulation = False
        self._atomic_bsz = max(batch_size // env.num_replicas(), 1)
        self._accum_steps = 0
        # Replay bookkeeping, keyed per epoch.
        self._loops_finished: dict[int, int] = {}
        self._loops_started: dict[int, int] = {}
        self._exit_future = None
        self._reoptimize_every = 50
        self._ckpt_every_steps = env.checkpoint_every_steps()
        self._last_profiled_config: tuple[int, int] | None = None
        # Poisoned (epoch, start, end) spans of the epoch permutation the
        # sampler must never re-feed, and the span of the batch yielded
        # last (the guard's identity for the step it grades).
        self._skip_ranges: list[tuple[int, int, int]] = []
        self._last_span: tuple[int, int, int] | None = None
        # Bumped by every restore of the loader's state. A guard rollback
        # restores the position during a step: the iterator sees it
        # across the yield and keeps the restored cursor.
        self._restore_gen = 0
        # Only changes after the first decision count as live re-tunes.
        self._decided_once = False
        # The job's first loader sizes it until another one autoscales:
        # a second loader (an evaluation loop's) would otherwise replace
        # the batch-size configuration the goodput model is relative to,
        # and add its steps to the training profile.
        if not any(
            isinstance(s, _DataLoaderCheckpoint)
            for s in checkpoint.registered_states()
        ):
            self._size_the_job()
        self._checkpoint = _DataLoaderCheckpoint(name, self)
        checkpoint.load_state(self._checkpoint)

    # -- configuration -------------------------------------------------

    def autoscale_batch_size(
        self,
        max_batch_size: int,
        local_bsz_bounds: tuple[int, int] | None = None,
        gradient_accumulation: bool = False,
    ) -> None:
        """Let the goodput model choose the global batch size up to
        ``max_batch_size``."""
        if max_batch_size < self.batch_size:
            raise ValueError("max_batch_size below initial batch size")
        self._max_batch_size = max_batch_size
        self._local_bsz_bounds = local_bsz_bounds
        self._gradient_accumulation = gradient_accumulation
        self._size_the_job()

    def _sizes_the_job(self) -> bool:
        return _job_sizer is not None and _job_sizer() is self

    def _size_the_job(self) -> None:
        global _job_sizer
        _job_sizer = weakref.ref(self)
        metrics.set_batch_size_config(
            self.batch_size,
            self._max_batch_size,
            self._local_bsz_bounds,
            self._gradient_accumulation,
        )

    @property
    def current_atomic_bsz(self) -> int:
        return self._atomic_bsz

    @property
    def current_accum_steps(self) -> int:
        return self._accum_steps

    @property
    def current_batch_size(self) -> int:
        """Global batch size currently in effect."""
        return env.num_replicas() * self._atomic_bsz * (self._accum_steps + 1)

    # -- adaptive sizing ----------------------------------------------

    def _optimize_batch_size(self) -> None:
        """Re-optimize (atomic_bsz, accum_steps); adopt on >5% speedup."""
        decision = self._rank0_decision() if env.replica_rank() == 0 else None
        self.apply_retune(*collective.broadcast(decision))

    def apply_retune(self, atomic_bsz: int, accum_steps: int) -> None:
        """Adopt a new (atomic_bsz, accum_steps) in-process: the sampler
        position and epoch bookkeeping carry over and nothing restarts.
        Must be called with the same values on every replica."""
        decision = (max(int(atomic_bsz), 1), max(int(accum_steps), 0))
        changed = decision != (self._atomic_bsz, self._accum_steps)
        self._atomic_bsz, self._accum_steps = decision
        if changed and self._decided_once:
            LOG.info("live re-tune: atomic_bsz=%d accum_steps=%d", *decision)
            metrics.record_retune()
        self._decided_once = True

    def _rank0_decision(self) -> tuple[int, int]:
        num_replicas = env.num_replicas()
        if self._max_batch_size is None:
            return max(self.batch_size // num_replicas, 1), 0
        remote = self._supervisor_decision(num_replicas)
        if remote is not None:
            return remote
        goodput_fn = metrics.get_goodput_fn()
        if goodput_fn is None:
            # No fitted model yet: split the initial batch size.
            atomic = max(self.batch_size // num_replicas, 1)
            if self._local_bsz_bounds is not None:
                atomic = int(np.clip(atomic, *self._local_bsz_bounds))
            return atomic, 0
        num_nodes = env.num_nodes()
        # Configurations are scored at the topology that runs: its
        # collective and pipeline terms belong on both sides of the
        # comparison. Each chip of an sp x tp group holds 1/(sp*tp) of a
        # microbatch's activations, so the atomic ceiling scales by it;
        # pipeline stages and expert shards keep the per-chip activations
        # about constant.
        sp, tp, ss, ep, pipeline_micro = metrics.active_topology()
        group = sp * tp
        topology = {
            "seq_shards": sp, "model_shards": tp, "stage_shards": ss,
            "pipeline_micro": pipeline_micro if ss > 1 else 1,
            "expert_shards": ep,
        }
        # The restored config may be infeasible at the new replica
        # count; then the optimizer's choice is adopted outright.
        current_feasible = (
            self.current_batch_size <= self._max_batch_size
            and (
                self._local_bsz_bounds is None
                or self._local_bsz_bounds[0]
                <= self._atomic_bsz
                <= self._local_bsz_bounds[1] * group
            )
            and self.current_batch_size >= self.batch_size
        )
        current_goodput = (
            goodput_fn(
                num_nodes, num_replicas, self._atomic_bsz, self._accum_steps,
                **topology,
            )
            if current_feasible
            else 0.0
        )
        _, atomic_bsz, accum_steps = goodput_fn.optimize(
            num_nodes,
            num_replicas,
            max_batch_size=self._max_batch_size,
            atomic_bsz_range=self._local_bsz_bounds,
            accumulation=self._gradient_accumulation,
            **topology,
        )
        # Rounding down alone may take the global batch below the initial
        # one, where the goodput model is not defined (the JAX loader
        # fails an assertion there), and rounding up may take it past
        # max_batch_size: the bucket stays inside both.
        per_step = num_replicas * (int(accum_steps) + 1)
        atomic_bsz = bucket_atomic_bsz(
            int(atomic_bsz),
            minimum=-(-self.batch_size // per_step),
            maximum=self._max_batch_size // per_step,
        )
        if self._local_bsz_bounds is not None:
            atomic_bsz = int(np.clip(
                atomic_bsz, self._local_bsz_bounds[0],
                self._local_bsz_bounds[1] * group,
            ))
        candidate_goodput = goodput_fn(
            num_nodes, num_replicas, atomic_bsz, int(accum_steps), **topology
        )
        if candidate_goodput > SPEEDUP_THRESHOLD * current_goodput:
            return atomic_bsz, int(accum_steps)
        return self._atomic_bsz, self._accum_steps

    def _supervisor_decision(
        self, num_replicas: int
    ) -> tuple[int, int] | None:
        """The allocator's published (atomicBsz, accumSteps) for this
        job, or None (no supervisor, no decision, or one made for another
        allocation): then the local decision applies. Rank 0 only."""
        remote = sched_hints.fetch_job_config()
        if not remote or not remote.get("batchConfig"):
            return None
        # The published config belongs to the published allocation: a
        # different device count means this incarnation is about to be
        # restarted, and a config sized for that world would skew the
        # remaining steps' profile for nothing.
        allocation = remote.get("allocation") or []
        sp, tp, ss, ep, _ = metrics.active_topology()
        # The allocation lists chips: sp * tp * ss * ep per replica.
        if allocation and len(allocation) != num_replicas * sp * tp * ss * ep:
            return None
        cfg = remote["batchConfig"]
        try:
            atomic = bucket_atomic_bsz(int(cfg.get("atomicBsz", 0)))
            accum = max(int(cfg.get("accumSteps", 0)), 0)
        except (TypeError, ValueError):
            return None
        if self._local_bsz_bounds is not None:
            atomic = int(np.clip(
                atomic, self._local_bsz_bounds[0], self._local_bsz_bounds[1] * sp * tp
            ))
        if num_replicas * atomic * (accum + 1) > self._max_batch_size:
            return None
        return atomic, accum

    @staticmethod
    def _replica_block(indices, take: int):
        """This process's rows of a global batch: its data replica's
        block, replica-major. The processes (one per chip) are the
        replicas times the seq shards, data outermost, so process ``p``
        holds replica ``p // (processes // replicas)``'s block, and the
        processes of one seq group receive the same rows."""
        processes, replicas = env.num_processes(), env.num_replicas()
        if processes % replicas:
            raise RuntimeError(
                f"{processes} processes do not divide into {replicas} "
                "data-parallel replicas"
            )
        if take % replicas:
            raise RuntimeError(
                f"global batch not divisible across {replicas} replicas "
                f"(take={take}); use drop_last=True for multi-process jobs"
            )
        block = take // replicas
        start = env.process_rank() // (processes // replicas) * block
        return indices[start : start + block]

    # -- elasticity ----------------------------------------------------

    def _check_exit(self) -> None:
        """Exit-flag agreement, once per step on every replica and
        overlapped with the step: the flags are OR-ed across replicas,
        so a signal that reached any one of them stops all of them at
        the same step, where every state is checkpointed and each exits
        143. A preemption notice routes the final save through the
        urgent drain (deadline-budgeted, joins a write in flight);
        otherwise it is a planned stop: a blocking save and, with the
        handoff on, a shard server left behind for the successor, which
        serves the save's own host copies."""
        if self._exit_future is not None and self._exit_future.result():
            if preemption.notice_active():
                LOG.info("graceful exit (preemption notice): urgent drain")
                preemption.urgent_drain()
            else:
                LOG.info("graceful exit: saving states and exiting 143")
                serve = env.handoff_enabled()
                handle = checkpoint.save_all_states(retain_snapshots=serve)
                if serve:
                    handoff.spawn_server(snapshots=handle.snapshots)
            sys.exit(_signal.GRACEFUL_EXIT_CODE)
        self._exit_future = collective.allreduce_async(
            bool(_signal.get_exit_flag()), any
        )

    # -- numeric-health guard hooks ------------------------------------

    def current_batch_span(self) -> tuple[int, int, int] | None:
        """(epoch, start, end) permutation span of the batch yielded
        last; None before the first batch."""
        return self._last_span

    def add_skip_range(self, epoch: int, start: int, end: int) -> None:
        """Record a poisoned sample range the sampler skips from now on.
        Every replica derives the same permutation, so the same call on
        each keeps their batches aligned; the next save persists it."""
        span = (int(epoch), int(start), int(end))
        if span not in self._skip_ranges:
            self._skip_ranges.append(span)
            LOG.warning(
                "guard: sampler will skip poisoned range epoch=%d [%d, %d)",
                *span,
            )

    def _skip_bound(self, take: int) -> int | None:
        """Where the sampler jumps if its next ``take`` samples overlap a
        poisoned range; None when the batch is clean."""
        start = self.sampler.index
        end = start + take
        for epoch, s0, e0 in self._skip_ranges:
            if epoch == self.sampler.epoch and s0 < end and e0 > start:
                return e0
        return None

    # -- iteration -----------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        global _current_dataloader
        if _current_dataloader is not None:
            raise RuntimeError("only one AdaptiveDataLoader loop may be active")
        epoch = _loop_epoch()
        started = self._loops_started.get(epoch, 0)
        finished = self._loops_finished.get(epoch, 0)
        self._loops_started[epoch] = started + 1
        if started < finished:
            return  # this loop of this epoch completed before the restart
        if self.sampler.epoch != epoch:
            self.sampler.set_position(epoch, 0)
        _current_dataloader = self
        try:
            self._optimize_batch_size()
            steps = 0
            while True:
                remaining = self.sampler.remaining()
                global_bsz = self.current_batch_size
                if remaining == 0 or (remaining < global_bsz and self.drop_last):
                    break
                take = min(global_bsz, remaining)
                skip_to = self._skip_bound(take)
                if skip_to is not None:
                    # A poisoned range: jump past it without yielding.
                    # The jump strictly advances the index, and replays
                    # identically on every replica and after a restart.
                    self.sampler.index = skip_to
                    continue
                self._check_exit()
                self._last_span = (
                    self.sampler.epoch,
                    self.sampler.index,
                    self.sampler.index + take,
                )
                indices = self.sampler.next_indices(take)
                if env.num_processes() > 1:
                    indices = self._replica_block(indices, take)
                batch = _gather(self.dataset, indices)
                config = (self._atomic_bsz, self._accum_steps)
                restore_gen = self._restore_gen
                start = time.monotonic()
                yield batch
                elapsed = time.monotonic() - start
                if self._restore_gen != restore_gen:
                    # A rollback restored the loader during the step: the
                    # restored position is authoritative, and the aborted
                    # step neither moves it nor records a profile sample.
                    continue
                # Neither a partial batch nor a loader that does not
                # size the job gives a sample of the configuration.
                profiled = take == global_bsz and self._sizes_the_job()
                if profiled and config == self._last_profiled_config:
                    metrics.profile_step(*config, elapsed)
                elif profiled:
                    # A new shape's first step includes its one-off
                    # set-up; recording it would skew the fit.
                    self._last_profiled_config = config
                self.sampler.index += take
                steps += 1
                if steps % self._reoptimize_every == 0:
                    self._optimize_batch_size()
                if (
                    self._ckpt_every_steps
                    and steps % self._ckpt_every_steps == 0
                ):
                    # The snapshot blocks; the write runs on a thread.
                    checkpoint.save_all_states(wait=False)
            self._loops_finished[epoch] = finished + 1
            for key in [k for k in self._loops_finished if k < epoch]:
                del self._loops_finished[key]
                self._loops_started.pop(key, None)
            self.sampler.index = 0
        finally:
            _current_dataloader = None


def current_dataloader() -> "AdaptiveDataLoader | None":
    """The loader whose loop is running, None outside any loop."""
    return _current_dataloader


def _dataset_size(dataset) -> int:
    if isinstance(dataset, dict):
        return len(next(iter(dataset.values())))
    return len(dataset)


def _gather(dataset, index: np.ndarray):
    """The rows ``index`` of ``dataset``: a dict of arrays is indexed
    directly; samples of any other dataset are stacked per field."""
    if isinstance(dataset, dict):
        return {k: v[index] for k, v in dataset.items()}
    samples = [dataset[int(i)] for i in index]
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            np.stack([s[j] for s in samples]) for j in range(len(first))
        )
    return np.stack(samples)


def _loop_epoch() -> int:
    from adaptdl_tpu_torch import epoch as epoch_mod

    current = epoch_mod.current_epoch()
    return current if current is not None else 0


class _DataLoaderCheckpoint(checkpoint.State):
    """Persists the loop/epoch position for mid-epoch resume."""

    def __init__(self, name: str, loader: AdaptiveDataLoader):
        super().__init__(name)
        self._loader = loader

    def save(self, fileobj):
        loader = self._loader
        pickle.dump(
            {
                "epoch": loader.sampler.epoch,
                "index": loader.sampler.index,
                "loops_finished": loader._loops_finished,
                "atomic_bsz": loader._atomic_bsz,
                "accum_steps": loader._accum_steps,
                "skip_ranges": list(loader._skip_ranges),
            },
            fileobj,
        )

    def load(self, fileobj):
        payload = pickle.load(fileobj)
        loader = self._loader
        loader.sampler.set_position(payload["epoch"], payload["index"])
        loader._loops_finished = payload["loops_finished"]
        loader._atomic_bsz = payload["atomic_bsz"]
        loader._accum_steps = payload["accum_steps"]
        # Checkpoints from before the guard slice carry no skip table.
        loader._skip_ranges = [
            tuple(r) for r in payload.get("skip_ranges", [])
        ]
        loader._restore_gen += 1
