"""Per-step profiling and perf-param fitting.

The port of the profiling half of ``adaptdl_tpu.metrics``:

- ``profile_step``: wall-clock of a whole training step, keyed by
  ``(num_nodes, num_replicas, seq_shards, model_shards, stage_shards,
  expert_shards, pipeline_micro, atomic_bsz)`` as in the JAX package.
- ``profile_accum_time``: the trainer's one-off compute-only
  calibration per atomic batch size (one microbatch forward and
  backward, no gradient sync). ``optim`` observations are then
  ``step_time - accum_steps * accum_time``, the residual that holds the
  gradient sync.

Every replica profiles its own steps; every ``fit_interval`` seconds
rank 0 alone refits the performance model on
a background thread (joined by :func:`join_fit`), and
:func:`get_goodput_fn` combines it with the latest gradient statistics.
Profiles and fitted parameters are checkpointed so a restarted job does
not re-learn its performance model. Posting scheduling hints to a
supervisor is not part of the port yet.
"""

from __future__ import annotations

import atexit
import pickle
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

from adaptdl_tpu_torch import checkpoint, env
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


_state = MetricsState()
_last_fit_time: float | None = None
_profile_lock = threading.Lock()
_fit_thread: threading.Thread | None = None
_active_topology: tuple[int, int, int, int, int] | None = None


def current_state() -> MetricsState:
    """What the engine knows now (profiles, fitted params, coverage)."""
    return _state


def join_fit(timeout: float | None = 60.0) -> None:
    """Wait for an in-flight background fit."""
    if _fit_thread is not None and _fit_thread.is_alive():
        _fit_thread.join(timeout)


# A refit still running in torch code while the interpreter finalizes
# can abort the process, so every exit waits for it.
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
    micro-steps, kept positive."""
    key = _profile_key(atomic_bsz)
    with _profile_lock:
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
        # Profiled coverage counts devices, as the JAX package does.
        sp, tp, ss, ep, _micro = active_topology()
        _state.max_profiled_replicas = max(
            _state.max_profiled_replicas,
            env.num_replicas() * sp * tp * ss * ep,
        )
    _maybe_fit()


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


def _maybe_fit() -> None:
    global _last_fit_time, _fit_thread
    now = time.monotonic()
    if _last_fit_time is not None and now - _last_fit_time < env.fit_interval():
        return
    _last_fit_time = now
    if env.replica_rank() != 0:
        return
    # The refit solves on the host; it must never stall the step loop.
    if _fit_thread is None or not _fit_thread.is_alive():
        _fit_thread = threading.Thread(
            target=fit_now, name="adaptdl-torch-fit", daemon=True
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


class _MetricsCheckpoint(checkpoint.State):
    """Profiles and fitted params survive restarts."""

    def __init__(self):
        super().__init__("adaptdl_metrics")

    def save(self, fileobj):
        with _profile_lock:
            payload = {name: getattr(_state, name) for name in _SAVED_FIELDS}
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


def ensure_checkpoint_registered() -> None:
    """Register the metrics state for checkpointing and, the first
    time, restore it, so a restarted job keeps the profiles (at every
    replica count it ran) and fitted parameters of its predecessors."""
    try:
        state = _MetricsCheckpoint()
    except ValueError:
        return  # already registered (and restored)
    checkpoint.load_state(state)
