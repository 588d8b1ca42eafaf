"""The examples' step budget and per-incarnation report.

``--steps N`` ends a run once the trainer has taken N optimizer steps in
all, counted across restarts (the step rides the checkpoint), so a run
under an elastic runner is bounded whatever its replica counts.
``--report-dir DIR`` has every rank of every incarnation write
``report-<restarts>-<rank>.json`` when it exits, whether it finished or
stopped for a rescale (exit 143): the step it resumed at, the steps and
losses it took, the wall time and the loader's (atomic batch,
accumulation steps) of each, the wall clock when it was ready to step
(its checkpoint loaded), at its first step's end and at its last
step's end, its flash-kernel launches by kernel, a SHA-256 of its
parameters (equal on every rank of a data-parallel group), the values of
its small parameters (at most 16 elements), the bytes its handoff
fetched and reused, and its warm-up hold, the facts the ``warmup.hold``
span carries: its verdict (``go`` for a warm successor adopted at a
cutover, null without a hold; a discarded one exits before it reports)
and the seconds it held. A runner's caller reads these to check each
rescale.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time

import torch


class RunReport:
    def __init__(self, report_dir: str | None, steps: int | None, model):
        """``model``: the module whose parameters the report hashes, or a
        callable returning the name -> tensor tree."""
        self._dir = report_dir
        self._steps = steps
        self._model = model
        self._start_step: int | None = None
        self._losses: list[float] = []
        self._times: list[float] = []
        self._configs: list[list[int]] = []
        self._last = time.perf_counter()
        self._step = 0
        self._ready_wall = time.time()
        self._first_step_wall: float | None = None
        self._last_step_wall: float | None = None

    def begin(self, state) -> None:
        """Call once the checkpoint is loaded: the step resumed at."""
        from adaptdl_tpu_torch.ops import _build

        _build.reset_launches()
        self._start_step = self._step = int(state.host_step)
        self._last = time.perf_counter()
        self._ready_wall = time.time()

    def note(self, state, metrics, loader=None) -> bool:
        """Record one step (and ``loader``'s batch configuration for it);
        True once the step budget is spent."""
        self._step = int(state.host_step)
        self._last_step_wall = time.time()
        if self._first_step_wall is None:
            self._first_step_wall = self._last_step_wall
        if self._dir:
            self._losses.append(float(metrics["loss"]))
            now = time.perf_counter()
            self._times.append(now - self._last)
            self._last = now
            if loader is not None:
                self._configs.append([
                    int(loader.current_atomic_bsz),
                    int(loader.current_accum_steps),
                ])
        return self.done()

    def done(self) -> bool:
        return self._steps is not None and self._step >= self._steps

    def write(self) -> None:
        if not self._dir:
            return
        from adaptdl_tpu_torch import env, handoff
        from adaptdl_tpu_torch.ops import _build
        from adaptdl_tpu_torch.sched import warmup

        digest = hashlib.sha256()
        small = {}
        # A callable gives the parameter tree (the params_tree of a ZeRO
        # or model/expert-sharded trainer, a collective every rank
        # reaches here).
        if isinstance(self._model, torch.nn.Module):
            named = self._model.named_parameters()
        else:
            named = self._model().items()
        for name, param in sorted(named):
            values = param.detach().float().cpu().numpy()
            digest.update(name.encode())
            digest.update(values.tobytes())
            if values.size <= 16:
                small[name] = values.ravel().tolist()
        hold = warmup.hold_info()
        report = {
            "restarts": env.num_restarts(),
            "rank": env.replica_rank(),
            "replicas": env.num_replicas(),
            "start_step": self._start_step,
            "end_step": self._step,
            "losses": self._losses,
            "losses_finite": all(math.isfinite(x) for x in self._losses),
            "step_s": self._times,
            "step_configs": self._configs,
            "launches": dict(_build.LAUNCHES),
            "params_sha256": digest.hexdigest(),
            "small_params": small,
            "ready_wall": self._ready_wall,
            "first_step_wall": self._first_step_wall,
            "last_step_wall": self._last_step_wall,
            "handoff": handoff.fetch_stats(),
            "hold_verdict": hold["verdict"],
            "hold_s": hold["seconds"],
        }
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(
            self._dir, f"report-{report['restarts']}-{report['rank']}.json"
        )
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(report, f)
        os.replace(path + ".tmp", path)
