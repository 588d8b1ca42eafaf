"""Elastic hyperparameter tuning: trials as co-scheduled elastic jobs.

The port's copy of ``adaptdl_tpu.tune``. A trial is a job of the port's
:class:`~adaptdl_tpu_torch.sched.multi_runner.MultiJobRunner` (``python
-m adaptdl_tpu_torch.launch SCRIPT``, so on the card unless the script
asks for the CPU), whose one Pollux allocator re-optimizes every trial's
slots as its goodput hints evolve: a trial's rescale is the ordinary
checkpoint-restart.

What this module adds on top of the runner:

- the trial API inside the training script: :func:`get_trial_config`
  (hyperparameters) and :func:`report` (one result row per call),
- :class:`TrialScheduler`: samples configs from a search space, runs all
  trials elastically on one node's slots, reads their reported metrics,
  and stops losers by successive halving at rung barriers.

In the training script::

    from adaptdl_tpu_torch import tune
    config = tune.get_trial_config()       # {"lr": 0.1, ...}
    ...
    tune.report(loss=float(loss))          # once per epoch

and in the tuning program::

    sched = tune.TrialScheduler(
        "train.py", {"lr": [0.1, 0.01, 0.001]},
        num_chips=3, metric="loss", mode="min")
    best = sched.run()
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import random
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any

from adaptdl_tpu_torch import _signal, env

LOG = logging.getLogger(__name__)

# Key spellings live in env.py; the scheduler writes them into the trials'
# environments, the trials read them back through env's accessors.
_CONFIG_ENV = env.TRIAL_CONFIG_KEY
_RESULT_ENV = env.TRIAL_RESULT_KEY


# ---- the in-script trial API ----------------------------------------


def get_trial_config() -> dict[str, Any]:
    """This trial's hyperparameters (empty when not under the tuner)."""
    raw = env.trial_config_raw()
    return json.loads(raw) if raw else {}


def _gate_path(result_file: str) -> str:
    """The scheduler-owned rung gate beside a trial's result file: it
    holds the number of results the trial may post before PAUSING for
    a promotion. Absent = ungated (plain runs)."""
    return result_file + ".gate"


def report(**metrics: float) -> None:
    """Stream one result row to the trial scheduler (appends a JSON
    line; restarts simply keep appending, so results survive
    rescales). Under a :class:`TrialScheduler`, a trial that has
    filled its current rung then WAITS here until the scheduler
    promotes it (or stops it — SIGTERM raises the graceful-exit flag
    and the wait returns so the normal checkpoint-and-exit path
    runs). The pause is what makes early stopping a guarantee rather
    than a race: a hopeless trial cannot sprint through its rungs
    faster than the scheduler can judge them."""
    path = env.trial_result_file()
    if not path:
        return
    with open(path, "a") as f:
        f.write(json.dumps(metrics) + "\n")
    # Count our rows AFTER the append (restarts resume the count).
    with open(path) as f:
        reported = sum(1 for line in f if line.strip())
    gate = _gate_path(path)
    while not _signal.get_exit_flag():
        try:
            with open(gate) as f:
                allowed = int(f.read().strip() or 0)
        except FileNotFoundError:
            return  # no scheduler gate: never block
        except ValueError:
            allowed = 0  # torn write: re-read next cycle
        if allowed <= 0 or reported < allowed:
            return
        time.sleep(0.05)


# ---- the scheduler side ---------------------------------------------


@dataclass
class Trial:
    trial_id: str
    config: dict[str, Any]
    result_file: str
    status: str = "RUNNING"  # RUNNING | STOPPED | DONE
    results: list[dict[str, float]] = field(default_factory=list)

    def last(self, metric: str) -> float | None:
        for row in reversed(self.results):
            if metric in row:
                return float(row[metric])
        return None


def sample_configs(
    search_space: dict[str, list], num_samples: int | None, seed: int = 0
) -> list[dict[str, Any]]:
    """Grid of the space (sorted for determinism), optionally
    subsampled to ``num_samples`` without replacement."""
    keys = sorted(search_space)
    grid = [
        dict(zip(keys, values))
        for values in itertools.product(*(search_space[k] for k in keys))
    ]
    if num_samples is not None and num_samples < len(grid):
        grid = random.Random(seed).sample(grid, num_samples)
    return grid


class TrialScheduler:
    """Run trials elastically on one slice with early stopping.

    Args:
      script: training script path (uses :func:`get_trial_config` /
        :func:`report`).
      search_space: {hyperparam: [values...]} grid.
      num_chips: slots shared by ALL trials (the Pollux allocator splits
        them by fitted goodput). Give every trial at least one: a trial
        paused at its rung gate keeps its slot, so a trial without one
        would never reach the rung.
      metric / mode: what :func:`report` field ranks trials, and
        whether bigger ("max") or smaller ("min") is better.
      num_samples: cap on the number of grid points (random subset).
      grace_results: results every surviving trial must post before a
        halving decision (the ASHA rung size).
      reduction_factor: keep ceil(n / reduction_factor) trials per rung.
      checkpoint_root: directory for per-trial checkpoint dirs (default
        ``adaptdl-torch-tune`` in the temp dir).
      poll_interval: seconds between monitor passes.
    """

    def __init__(
        self,
        script: str,
        search_space: dict[str, list],
        num_chips: int,
        metric: str,
        mode: str = "min",
        num_samples: int | None = None,
        grace_results: int = 1,
        reduction_factor: int = 2,
        checkpoint_root: str | None = None,
        poll_interval: float = 1.0,
        runner_kwargs: dict | None = None,
    ):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.grace_results = max(int(grace_results), 1)
        self.reduction_factor = max(int(reduction_factor), 2)
        self.poll_interval = poll_interval
        if checkpoint_root is None:
            checkpoint_root = os.path.join(
                tempfile.gettempdir(), "adaptdl-torch-tune"
            )
        os.makedirs(checkpoint_root, exist_ok=True)
        self.trials: dict[str, Trial] = {}
        jobs = []
        from adaptdl_tpu_torch.sched.multi_runner import JobSpec

        for i, config in enumerate(
            sample_configs(search_space, num_samples)
        ):
            trial_id = f"trial-{i}"
            result_file = os.path.join(
                checkpoint_root, f"{trial_id}.results.jsonl"
            )
            open(result_file, "w").close()
            # Arm the rung gate: the trial runs freely to the first
            # rung, then PAUSES in tune.report until a halving
            # decision promotes (or stops) it — early stopping by
            # construction, not by the monitor thread winning a race.
            with open(_gate_path(result_file), "w") as f:
                f.write(str(self.grace_results))
            self.trials[f"tune/{trial_id}"] = Trial(
                trial_id, config, result_file
            )
            jobs.append(
                JobSpec(
                    name=f"tune/{trial_id}",
                    script=script,
                    checkpoint_dir=os.path.join(
                        checkpoint_root, trial_id
                    ),
                    extra_env={
                        _CONFIG_ENV: json.dumps(config),
                        _RESULT_ENV: result_file,
                    },
                )
            )
        from adaptdl_tpu_torch.sched.multi_runner import MultiJobRunner

        self.runner = MultiJobRunner(
            jobs, num_chips=num_chips, **(runner_kwargs or {})
        )
        self._next_rung = self.grace_results
        self.stopped_trials: list[str] = []

    # -- monitoring ---------------------------------------------------

    def _refresh_results(self) -> None:
        for key, trial in self.trials.items():
            try:
                with open(trial.result_file) as f:
                    rows = [
                        json.loads(line)
                        for line in f
                        if line.strip()
                    ]
            except FileNotFoundError:
                rows = []
            trial.results = rows
            # Sync with the runner's lifecycle: a crashed or finished
            # trial must leave the RUNNING pool immediately, or the
            # halving rung waits forever on results that will never
            # arrive.
            record = self.runner.state.get_job(key)
            if trial.status == "RUNNING" and record is not None:
                if record.status == "Failed":
                    trial.status = "FAILED"
                elif record.status == "Succeeded":
                    trial.status = "DONE"

    def _promote(self, trial: Trial, allowed: int | None) -> None:
        """Let a surviving trial run past its rung gate: ``allowed``
        result rows before the next pause (None = remove the gate
        entirely — no peer is left to judge it against)."""
        gate = _gate_path(trial.result_file)
        try:
            if allowed is None:
                os.remove(gate)
            else:
                with open(gate, "w") as f:
                    f.write(str(allowed))
        except OSError:  # pragma: no cover - gate is advisory
            pass

    def _maybe_halve(self) -> None:
        """Successive halving at rung barriers. Trials
        PAUSE in :func:`report` when they fill their current rung, so
        a hopeless trial can never sprint to completion before the
        monitor looks — early stopping is a guarantee, not a race
        against scheduler-thread starvation. Once every RUNNING trial
        has reached the rung, the worst are stopped and the survivors
        promoted to the next rung. Trials that already FINISHED (at a
        rung they were promoted through) stay in the scoring pool;
        only running trials block completeness or can be stopped."""
        live = [
            (key, t)
            for key, t in self.trials.items()
            if t.status == "RUNNING"
        ]
        if not live:
            return
        for _, trial in live:
            if len(trial.results) < self._next_rung:
                return  # rung not complete yet
        done = [
            (key, t)
            for key, t in self.trials.items()
            if t.status == "DONE"
            and len(t.results) >= self._next_rung
        ]
        pool = live + done
        if len(pool) <= 1:
            # Every other trial is terminal below this rung (failed,
            # stopped, or finished short): nobody is left to judge
            # the survivor against — ungate it so it can't deadlock
            # at a barrier no decision will ever open.
            for _, trial in live:
                self._promote(trial, None)
            return
        scored = []
        for key, trial in pool:
            scored.append((trial.last(self.metric), key))
        if any(score is None for score, _ in scored):
            return
        reverse = self.mode == "max"
        scored.sort(key=lambda kv: kv[0], reverse=reverse)
        keep = -(-len(scored) // self.reduction_factor)  # ceil
        for score, key in scored[keep:]:
            if self.trials[key].status != "RUNNING":
                continue  # a finished loser cannot be stopped
            LOG.info(
                "halving: stopping %s (%s=%s)", key, self.metric, score
            )
            self.trials[key].status = "STOPPED"
            self.stopped_trials.append(key)
            self.runner.stop_job(key)
        self._next_rung *= self.reduction_factor
        for _, key in scored[:keep]:
            if self.trials[key].status == "RUNNING":
                self._promote(self.trials[key], self._next_rung)

    def run(self) -> Trial:
        """Run to completion; returns the best trial."""
        import threading

        exit_codes: dict[str, int] = {}

        def run_jobs():
            exit_codes.update(self.runner.run())

        thread = threading.Thread(
            target=run_jobs, name="tune-runner", daemon=True
        )
        thread.start()
        while thread.is_alive():
            thread.join(timeout=self.poll_interval)
            self._refresh_results()
            self._maybe_halve()
        self._refresh_results()
        for key, trial in self.trials.items():
            if trial.status == "RUNNING":
                trial.status = (
                    "DONE" if exit_codes.get(key) == 0 else "FAILED"
                )
        return self.best_trial()

    def best_trial(self) -> Trial:
        def score(trial: Trial):
            value = trial.last(self.metric)
            if value is None:
                return float("inf") if self.mode == "min" else -float("inf")
            return value

        candidates = sorted(
            self.trials.values(),
            key=score,
            reverse=self.mode == "max",
        )
        return candidates[0]
