"""Per-step profiling, perf-param fitting and hint reporting.

The port of ``adaptdl_tpu.metrics``:

- ``profile_step``: wall-clock of a whole training step, keyed by
  ``(num_nodes, num_replicas, seq_shards, model_shards, stage_shards,
  expert_shards, pipeline_micro, atomic_bsz)`` as in the JAX package.
- ``profile_accum_time``: the trainer's one-off compute-only
  calibration per atomic batch size (one microbatch forward and
  backward, no gradient sync). ``optim`` observations are then
  ``step_time - accum_steps * accum_time``, the residual that holds the
  gradient sync.

Every replica profiles its own steps; every ``fit_interval`` seconds
rank 0 alone refits the performance model and posts the scheduling
hints to the supervisor (when one is set) on a background thread,
joined by :func:`join_fit`; :func:`get_goodput_fn` combines the fit with
the latest gradient statistics. Profiles and fitted parameters are
checkpointed so a restarted job does not re-learn its performance
model.

Goodput hygiene: a step the numeric-health guard condemned
(:func:`note_unhealthy_step`) feeds only the raw throughput EWMAs, never
the profile table, the perf fit or the guarded EWMAs behind
``measuredGoodput``. The buffered trace spans reach the supervisor on
the hint cadence (after each post), and the first profiled step closes
the ``restart.first_step`` span bootstrap opened.
"""

from __future__ import annotations

import atexit
import pickle
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

from adaptdl_tpu_torch import checkpoint, env, guard, sched_hints, trace
from adaptdl_tpu_torch.goodput import (
    GoodputFunction,
    GradParams,
    PerfParams,
    fit_perf_params,
)


@dataclass
class _ProfileEntry:
    optim_time_sum: float = 0.0
    optim_count: int = 0
    accum_time_sum: float = 0.0
    accum_count: int = 0


@dataclass
class MetricsState:
    """What the adaptation engine knows about this job so far."""

    profile: dict = field(  # guarded-by: _profile_lock
        default_factory=lambda: defaultdict(_ProfileEntry)
    )
    perf_params: PerfParams | None = None  # guarded-by: _profile_lock
    grad_params: GradParams | None = None  # guarded-by: _profile_lock
    init_batch_size: int | None = None
    max_batch_size: int | None = None
    local_bsz_bounds: tuple[int, int] | None = None
    gradient_accumulation: bool = False
    # The most replicas any incarnation of this job has profiled steps
    # at; persisted, so profiles at several counts enter one fit.
    max_profiled_replicas: int = 0
    max_seq_shards: int = 1
    max_model_shards: int = 1
    max_stage_shards: int = 1
    max_expert_shards: int = 1
    progress: float = 0.0
    # The last completed save: the seconds it blocked the training
    # thread (the snapshot), the seconds of its write (on the writer
    # thread for a periodic save), per-state timings and its bytes; this
    # incarnation's restore seconds per state and its handoff transfer.
    ckpt_snapshot_s: float | None = None  # guarded-by: _profile_lock
    ckpt_write_s: float | None = None  # guarded-by: _profile_lock
    ckpt_per_state: dict = field(  # guarded-by: _profile_lock
        default_factory=dict
    )
    ckpt_save_bytes: int | None = None  # guarded-by: _profile_lock
    restore_per_state: dict = field(  # guarded-by: _profile_lock
        default_factory=dict
    )
    handoff_s: float | None = None  # guarded-by: _profile_lock
    handoff_bytes: int | None = None  # guarded-by: _profile_lock
    # In-process (atomic_bsz, accum) re-tunes adopted without a restart.
    num_retunes: int = 0  # guarded-by: _profile_lock
    # Smoothed step time (rides the heartbeats) and examples/s at the
    # batch geometry of the last profiled step (measuredGoodput); the
    # raw examples/s EWMA also takes the steps the guard condemned, and
    # suppress_profile_steps counts condemned samples the loader has not
    # recorded yet.
    step_time_ewma: float | None = None  # guarded-by: _profile_lock
    examples_ewma: float | None = None  # guarded-by: _profile_lock
    last_global_bsz: int | None = None  # guarded-by: _profile_lock
    raw_examples_ewma: float | None = None  # guarded-by: _profile_lock
    unhealthy_steps: int = 0  # guarded-by: _profile_lock
    suppress_profile_steps: int = 0  # guarded-by: _profile_lock


_state = MetricsState()
_last_fit_time: float | None = None
_profile_lock = threading.Lock()
_fit_thread: threading.Thread | None = None
_active_topology: tuple[int, int, int, int, int] | None = None


def current_state() -> MetricsState:
    """What the engine knows now (profiles, fitted params, coverage)."""
    return _state


def join_fit(timeout: float | None = 60.0) -> None:
    """Wait for an in-flight background fit and its hint post."""
    if _fit_thread is not None and _fit_thread.is_alive():
        _fit_thread.join(timeout)


# A refit still running in torch code while the interpreter finalizes
# can abort the process, so every exit waits for it (and for the hint
# post that follows it on the same thread).
atexit.register(join_fit)


def _reset_state() -> None:
    """Test isolation."""
    global _state, _last_fit_time, _fit_thread, _active_topology
    join_fit()
    _state = MetricsState()
    _last_fit_time = None
    _fit_thread = None
    _active_topology = None


def set_active_topology(
    seq_shards: int = 1,
    model_shards: int = 1,
    stage_shards: int = 1,
    expert_shards: int = 1,
    pipeline_micro: int = 1,
) -> None:
    """Registered by the trainer with the (sp, tp, ss, ep, M) it runs;
    profiles and batch decisions key on this."""
    global _active_topology
    _active_topology = tuple(
        max(int(x), 1)
        for x in (
            seq_shards, model_shards, stage_shards, expert_shards,
            pipeline_micro,
        )
    )


def active_topology() -> tuple[int, int, int, int, int]:
    """The live (seq_shards, model_shards, stage_shards, expert_shards,
    pipeline_micro): what the trainer registered, else the scheduler's
    request."""
    if _active_topology is not None:
        return _active_topology
    return (
        env.seq_shards(), env.model_shards(), env.stage_shards(),
        env.expert_shards(), 1,
    )


def set_batch_size_config(
    init_batch_size: int,
    max_batch_size: int | None = None,
    local_bsz_bounds: tuple[int, int] | None = None,
    gradient_accumulation: bool = False,
) -> None:
    _state.init_batch_size = init_batch_size
    _state.max_batch_size = max_batch_size
    _state.local_bsz_bounds = local_bsz_bounds
    _state.gradient_accumulation = gradient_accumulation


def set_topology_config(
    max_seq_shards: int = 1,
    max_model_shards: int = 1,
    max_stage_shards: int = 1,
    max_expert_shards: int = 1,
) -> None:
    """Advertise how far this job can shard each sample and the model
    (persisted with the profiles)."""
    _state.max_seq_shards = max(int(max_seq_shards), 1)
    _state.max_model_shards = max(int(max_model_shards), 1)
    _state.max_stage_shards = max(int(max_stage_shards), 1)
    _state.max_expert_shards = max(int(max_expert_shards), 1)


def _profile_key(atomic_bsz: int) -> tuple:
    sp, tp, ss, ep, micro = active_topology()
    return (
        env.num_nodes(), env.num_replicas(), sp, tp, ss, ep,
        micro if ss > 1 else 1, atomic_bsz,
    )


def profile_accum_time(atomic_bsz: int, accum_time: float) -> None:
    """Record a compute-only (no-sync) calibration measurement."""
    key = _profile_key(atomic_bsz)
    with _profile_lock:
        entry = _state.profile[key]
        entry.accum_time_sum += accum_time
        entry.accum_count += 1


def profile_step(
    atomic_bsz: int, accum_steps: int, step_time: float
) -> None:
    """Record one full-step wall-clock measurement; the optim-time
    observation is the step time minus the modelled accumulation
    micro-steps, kept positive. A sample the guard condemned feeds only
    the raw EWMAs."""
    trace.end_pending("restart.first_step", atomic_bsz=int(atomic_bsz))
    key = _profile_key(atomic_bsz)
    alpha = 0.2  # EWMA weight: a few fit intervals of memory
    with _profile_lock:
        suppressed = _state.suppress_profile_steps > 0
        if suppressed:
            _state.suppress_profile_steps -= 1
        if step_time > 0:
            global_bsz = (
                int(atomic_bsz) * (int(accum_steps) + 1) * env.num_replicas()
            )
            examples_s = global_bsz / step_time
            _state.raw_examples_ewma = _ewma(
                _state.raw_examples_ewma, examples_s, alpha
            )
            _state.last_global_bsz = global_bsz
        if not suppressed:
            entry = _state.profile[key]
            if accum_steps > 0 and entry.accum_count > 0:
                accum_time = entry.accum_time_sum / entry.accum_count
                optim_time = max(
                    step_time - accum_steps * accum_time, 0.1 * step_time
                )
            else:
                optim_time = step_time
            entry.optim_time_sum += optim_time
            entry.optim_count += 1
            if step_time > 0:
                _state.step_time_ewma = _ewma(
                    _state.step_time_ewma, step_time, alpha
                )
                _state.examples_ewma = _ewma(
                    _state.examples_ewma, examples_s, alpha
                )
            # Profiled coverage counts devices, as the JAX package does.
            sp, tp, ss, ep, _micro = active_topology()
            _state.max_profiled_replicas = max(
                _state.max_profiled_replicas,
                env.num_replicas() * sp * tp * ss * ep,
            )
    if not suppressed:
        _maybe_fit()


def _ewma(prev: float | None, value: float, alpha: float) -> float:
    return value if prev is None else (1 - alpha) * prev + alpha * value


def record_checkpoint_save(
    snapshot_s: float,
    write_s: float,
    per_state: dict,
    total_bytes: int | None = None,
) -> None:
    """The last completed save: the seconds its snapshot blocked the
    training thread, the seconds of its write, per-state timings and
    the bytes it wrote. Called from the writer thread while the fit
    thread may read ``restart_stats``: the lock keeps one save's
    numbers together."""
    with _profile_lock:
        _state.ckpt_snapshot_s = float(snapshot_s)
        _state.ckpt_write_s = float(write_s)
        _state.ckpt_per_state = dict(per_state)
        if total_bytes is not None:
            _state.ckpt_save_bytes = int(total_bytes)


def record_handoff(seconds: float, transferred_bytes: int) -> None:
    """The successor's peer-to-peer transfer (manifest and chunks), in
    seconds and bytes: a planned rescale's restore cost."""
    with _profile_lock:
        _state.handoff_s = float(seconds)
        _state.handoff_bytes = int(transferred_bytes)


def record_checkpoint_restore(name: str, seconds: float) -> None:
    """Seconds one state's restore took in this incarnation."""
    with _profile_lock:
        _state.restore_per_state[name] = float(seconds)


def record_retune() -> None:
    """An in-process (atomic_bsz, accum) re-tune was adopted."""
    with _profile_lock:
        _state.num_retunes += 1


def restart_stats() -> dict | None:
    """Measured rescale-cost components for the ``restartStats`` hint
    (the ``restart_stats`` wire family), or None before anything was
    measured: ``snapshotS``/``writeS`` of the last save,
    ``overlapFrac`` = write / (snapshot + write), the share a periodic
    save keeps off the training thread, its bytes, the handoff's
    seconds and bytes, and ``restoreS`` summed over this incarnation's
    restores."""
    with _profile_lock:
        if (
            _state.ckpt_snapshot_s is None
            and not _state.restore_per_state
            and _state.handoff_s is None
        ):
            return None
        stats: dict = {"numRetunes": _state.num_retunes}
        if _state.ckpt_snapshot_s is not None:
            snap = _state.ckpt_snapshot_s
            write = _state.ckpt_write_s or 0.0
            stats["snapshotS"] = round(snap, 4)
            stats["writeS"] = round(write, 4)
            if snap + write > 0:
                stats["overlapFrac"] = round(write / (snap + write), 4)
        if _state.ckpt_save_bytes is not None:
            stats["saveBytes"] = _state.ckpt_save_bytes
            stats["saveKind"] = "full"
        if _state.handoff_s is not None:
            stats["handoffS"] = round(_state.handoff_s, 4)
            stats["handoffBytes"] = _state.handoff_bytes or 0
        if _state.restore_per_state:
            stats["restoreS"] = round(
                sum(_state.restore_per_state.values()), 4
            )
        return stats


def step_time_ewma() -> float | None:
    """This process's smoothed step time (seconds), or None before the
    first profiled step: what the heartbeats carry."""
    with _profile_lock:
        return _state.step_time_ewma


def measured_goodput() -> float | None:
    """Realized goodput (useful examples/s): the guarded throughput EWMA
    times the statistical efficiency at the running batch size under
    the current gradient params. None until both exist."""
    with _profile_lock:
        examples = _state.examples_ewma
        global_bsz = _state.last_global_bsz
        grad = _state.grad_params
        init = _state.init_batch_size
    return _goodput_from(examples, global_bsz, grad, init)


def raw_goodput() -> float | None:
    """:func:`measured_goodput` over the raw throughput EWMA, which also
    counts the unhealthy and rolled-back steps."""
    with _profile_lock:
        examples = _state.raw_examples_ewma
        global_bsz = _state.last_global_bsz
        grad = _state.grad_params
        init = _state.init_batch_size
    return _goodput_from(examples, global_bsz, grad, init)


def _goodput_from(examples, global_bsz, grad, init) -> float | None:
    if examples is None or not global_bsz or grad is None or not init:
        return None
    scale = global_bsz / init
    denom = grad.var / scale + grad.sqr
    gain = (grad.var + grad.sqr) / denom if denom > 0 else 1.0
    return examples * gain / scale


def note_unhealthy_step(n: int = 1) -> None:
    """The guard condemned the current step: count it and keep the next
    ``n`` profile samples (the loader records a step's sample after the
    trainer's guard graded it) out of the guarded EWMAs and the fit."""
    with _profile_lock:
        _state.unhealthy_steps += 1
        _state.suppress_profile_steps += max(int(n), 0)


def unhealthy_steps() -> int:
    """Guard-condemned steps observed (restored with the metrics state)."""
    with _profile_lock:
        return _state.unhealthy_steps


def update_grad_params(sqr: float, var: float) -> None:
    """Latest GNS estimates from the train step's statistics."""
    with _profile_lock:
        _state.grad_params = GradParams(sqr=float(sqr), var=float(var))


def update_progress(progress: float) -> None:
    _state.progress = float(progress)


def _fit() -> PerfParams | None:
    with _profile_lock:
        snapshot = [
            (key, _ProfileEntry(**vars(entry)))
            for key, entry in _state.profile.items()
        ]
    rows = []
    for (n, r, sp, tp, ss, ep, micro, bsz), entry in snapshot:
        if entry.optim_count == 0:
            continue
        optim = entry.optim_time_sum / entry.optim_count
        # A missing calibration falls back to the optim time.
        accum = (
            entry.accum_time_sum / entry.accum_count
            if entry.accum_count > 0 else optim
        )
        rows.append((n, r, bsz, accum, optim, sp, tp, ss, micro, ep))
    if not rows:
        return None
    cols = list(zip(*rows))
    return fit_perf_params(
        *cols[:5],
        seq_shards=cols[5],
        model_shards=cols[6],
        stage_shards=cols[7],
        pipeline_micro=cols[8],
        expert_shards=cols[9],
    )


def fit_now() -> None:
    """Refit the performance model from the profiles."""
    perf = _fit()
    if perf is not None:
        with _profile_lock:
            _state.perf_params = perf


def fit_and_report_now() -> None:
    """Refit the performance model and, when a supervisor is set, post
    the scheduling hints (best-effort)."""
    fit_now()
    with _profile_lock:
        perf_params = _state.perf_params
        grad_params = _state.grad_params
    if _state.init_batch_size is None:
        return
    hints = sched_hints.empty_hints()
    hints["initBatchSize"] = _state.init_batch_size
    if _state.local_bsz_bounds is not None:
        hints["localBszBounds"] = list(_state.local_bsz_bounds)
    hints["maxBatchSize"] = _state.max_batch_size
    hints["maxProfiledReplicas"] = _state.max_profiled_replicas
    hints["gradientAccumulation"] = _state.gradient_accumulation
    hints["maxSeqShards"] = _state.max_seq_shards
    hints["maxModelShards"] = _state.max_model_shards
    hints["maxStageShards"] = _state.max_stage_shards
    hints["maxExpertShards"] = _state.max_expert_shards
    # The pipeline fields at the JAX package's defaults for a job with
    # no pipeline stages: the cap on M it would post (8), one
    # microbatch, no interleaved schedule.
    hints["maxPipelineMicro"] = 8
    hints["pipelineMicrobatches"] = 1
    hints["pipelineChunks"] = 0
    measured = measured_goodput()
    if measured is not None:
        hints["measuredGoodput"] = round(measured, 6)
    stats = restart_stats()
    if stats is not None:
        hints["restartStats"] = stats
    gstats = guard.guard_stats()
    if gstats is not None:
        hints["guardStats"] = gstats
    if grad_params is not None:
        hints["gradParams"] = dict(grad_params._asdict())
    if perf_params is not None:
        hints["perfParams"] = {
            k: float(v) for k, v in perf_params._asdict().items()
        }
    sched_hints.post_sched_hints(hints)
    trace.flush_to_supervisor()


def _maybe_fit() -> None:
    global _last_fit_time, _fit_thread
    now = time.monotonic()
    if _last_fit_time is not None and now - _last_fit_time < env.fit_interval():
        return
    _last_fit_time = now
    if env.replica_rank() != 0:
        return
    # The refit and the post run on the host; they must never stall the
    # step loop.
    if _fit_thread is None or not _fit_thread.is_alive():
        _fit_thread = threading.Thread(
            target=fit_and_report_now, name="adaptdl-torch-fit", daemon=True
        )
        _fit_thread.start()


def get_goodput_fn() -> GoodputFunction | None:
    """The goodput function of the latest fitted perf and gradient
    params, or None until both exist."""
    with _profile_lock:
        perf_params = _state.perf_params
        grad_params = _state.grad_params
    if (
        perf_params is None
        or grad_params is None
        or _state.init_batch_size is None
    ):
        return None
    return GoodputFunction(perf_params, grad_params, _state.init_batch_size)


_SAVED_FIELDS = (
    "perf_params", "grad_params", "init_batch_size", "max_batch_size",
    "local_bsz_bounds", "gradient_accumulation", "max_profiled_replicas",
    "max_seq_shards", "max_model_shards", "max_stage_shards",
    "max_expert_shards", "progress",
)
# Fields checkpoints from before the guard slice lack: read with their
# defaults.
_OPTIONAL_FIELDS = (
    "ckpt_snapshot_s", "ckpt_save_bytes", "num_retunes",
    "raw_examples_ewma", "unhealthy_steps", "ckpt_write_s",
)


class _MetricsCheckpoint(checkpoint.State):
    """Profiles and fitted params survive restarts."""

    def __init__(self):
        super().__init__("adaptdl_metrics")

    def save(self, fileobj):
        with _profile_lock:
            payload = {
                name: getattr(_state, name)
                for name in _SAVED_FIELDS + _OPTIONAL_FIELDS
            }
            payload["profile"] = {
                key: vars(entry).copy()
                for key, entry in _state.profile.items()
            }
        pickle.dump(payload, fileobj)

    def load(self, fileobj):
        payload = pickle.load(fileobj)
        profile = defaultdict(_ProfileEntry)
        for key, entry in payload.pop("profile").items():
            profile[key] = _ProfileEntry(**entry)
        with _profile_lock:
            _state.profile = profile
            for name in _SAVED_FIELDS:
                setattr(_state, name, payload[name])
            defaults = MetricsState()
            for name in _OPTIONAL_FIELDS:
                setattr(
                    _state, name, payload.get(name, getattr(defaults, name))
                )


def ensure_checkpoint_registered() -> None:
    """Register the metrics state for checkpointing and, the first
    time, restore it, so a restarted job keeps the profiles (at every
    replica count it ran) and fitted parameters of its predecessors."""
    try:
        state = _MetricsCheckpoint()
    except ValueError:
        return  # already registered (and restored)
    checkpoint.load_state(state)
