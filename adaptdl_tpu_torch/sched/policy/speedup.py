"""Speedup function: a job's goodput normalised by its base goodput.

The port's copy of ``adaptdl_tpu.sched.policy.speedup``. It wraps a
fitted :class:`adaptdl_tpu_torch.goodput.GoodputFunction` as
``speedup(num_nodes, num_chips)``, the quantity the Pollux policy sums
across jobs. The genetic search evaluates the same few (nodes, chips)
points thousands of times per cycle, so results are cached in a table
filled lazily, with one vectorised search per batch of new points.

Each chip count is scored by :meth:`GoodputFunction.optimize_topology`:
the best (data, seq, model, stage, expert) factorisation of those chips
and, with stages, the pipeline M (up to ``max_pipeline_micro``) and the
interleaved schedule a job of ``pipeline_chunks`` chunks would run, so a
job advertising ``max_seq_shards``, ``max_model_shards``,
``max_stage_shards`` or ``max_expert_shards`` > 1 (or a
``mesh_shape_grid`` of such shapes) competes with the sharded
configurations inside the same speedup number, and
:meth:`SpeedupFunction.best_config` keeps the chosen one for the
allocator to publish.
"""

from __future__ import annotations

import numpy as np

class SpeedupFunction:
    def __init__(
        self,
        goodput_fn,
        max_batch_size: int | None = None,
        atomic_bsz_range: tuple[int, int] | None = None,
        accumulation: bool = False,
        max_seq_shards: int = 1,
        max_model_shards: int = 1,
        max_stage_shards: int = 1,
        max_expert_shards: int = 1,
        max_pipeline_micro: int = 8,
        pipeline_chunks: int = 0,
        mesh_shape_grid=None,
    ):
        self._goodput_fn = goodput_fn
        self._max_batch_size = max_batch_size
        self._atomic_bsz_range = atomic_bsz_range
        self._accumulation = accumulation
        self._max_seq_shards = max(int(max_seq_shards or 1), 1)
        self._max_model_shards = max(int(max_model_shards or 1), 1)
        self._max_stage_shards = max(int(max_stage_shards or 1), 1)
        self._max_expert_shards = max(int(max_expert_shards or 1), 1)
        self._max_pipeline_micro = max(int(max_pipeline_micro or 1), 1)
        self._pipeline_chunks = max(int(pipeline_chunks or 0), 0)
        # Explicit candidate mesh shapes (goodput.mesh_shape_grid /
        # the job's meshShapeGrid hint). None keeps the max_*-derived
        # power-of-two enumeration, so dp-only jobs (all limits 1, no
        # grid) take the IDENTICAL search the pre-mesh scheduler ran.
        self._mesh_shape_grid = (
            tuple(
                (int(sp), int(tp), int(ss), int(ep))
                for sp, tp, ss, ep in mesh_shape_grid
            )
            if mesh_shape_grid
            else None
        )
        # Base goodput: one chip on one slice.
        base, *_ = self._optimize(np.array([1]), np.array([1]))
        self._base_goodput = float(np.atleast_1d(base)[0])
        self._cache: dict[tuple[int, int], float] = {(0, 0): 0.0}
        # (nodes, chips) ->
        #   (atomic_bsz, accum_steps, sp, tp, ss, ep, micro)
        self._config: dict[tuple[int, int], tuple] = {}

    def _optimize(self, nodes, chips):
        return self._goodput_fn.optimize_topology(
            nodes,
            chips,
            max_batch_size=self._max_batch_size,
            atomic_bsz_range=self._atomic_bsz_range,
            accumulation=self._accumulation,
            max_seq_shards=self._max_seq_shards,
            max_model_shards=self._max_model_shards,
            max_stage_shards=self._max_stage_shards,
            max_expert_shards=self._max_expert_shards,
            max_pipeline_micro=self._max_pipeline_micro,
            pipeline_chunks=self._pipeline_chunks,
            shape_grid=self._mesh_shape_grid,
        )

    @property
    def mesh_shape_grid(self):
        """The explicit candidate shapes this job advertised, or None
        when the search runs on the max_*-derived enumeration."""
        return self._mesh_shape_grid

    def best_config(
        self, num_nodes: int, num_chips: int
    ) -> tuple[int, int, int, int, int, int, int]:
        """(atomic_bsz, accum_steps, seq_shards, model_shards,
        stage_shards, expert_shards, pipeline_micro) behind the
        speedup at this allocation — what the controller exports as
        ADAPTDL_SEQ_SHARDS / ADAPTDL_MODEL_SHARDS /
        ADAPTDL_STAGE_SHARDS / ADAPTDL_EXPERT_SHARDS /
        ADAPTDL_PIPELINE_MICRO."""
        self(num_nodes, num_chips)  # warm the cache
        return self._config.get(
            (int(num_nodes), int(num_chips)), (0, 0, 1, 1, 1, 1, 1)
        )

    def best_config_with_hysteresis(
        self,
        num_nodes: int,
        num_chips: int,
        incumbent: dict | None,
        threshold: float = 1.05,
    ) -> tuple[int, int, int, int, int, int, int]:
        """Like :meth:`best_config`, but keeps the job's incumbent
        factorization unless the challenger beats it by ``threshold``
        on the fitted model — a topology change costs a full
        checkpoint-restart-recompile, so near-ties must not flap
        across refits (same philosophy as the dataloader's 5%
        batch-size threshold, reference: data.py:297-301). A change
        in the pipeline microbatch count alone also restarts (the
        gpipe_loss is rebuilt), so M is part of the incumbent."""
        bsz, accum, sp, tp, ss, ep, micro = self.best_config(
            num_nodes, num_chips
        )
        inc = incumbent or {}
        inc_sp = max(int(inc.get("seqShards", 1)), 1)
        inc_tp = max(int(inc.get("modelShards", 1)), 1)
        inc_ss = max(int(inc.get("stageShards", 1)), 1)
        inc_ep = max(int(inc.get("expertShards", 1)), 1)
        inc_micro = max(
            int(inc.get("pipelineMicro", 1 if inc_ss == 1 else 4)), 1
        )
        if inc_ss == 1:
            inc_micro = 1
        challenger = (sp, tp, ss, ep, micro)
        if challenger == (inc_sp, inc_tp, inc_ss, inc_ep, inc_micro):
            return bsz, accum, sp, tp, ss, ep, micro
        group = inc_sp * inc_tp * inc_ss * inc_ep
        dp = num_chips // group
        if dp < 1 or dp * group != num_chips or dp < max(num_nodes, 1):
            # Incumbent no longer fits this chip count; adopt the best.
            return bsz, accum, sp, tp, ss, ep, micro
        inc_goodput, inc_bsz, inc_accum = self._goodput_fn.optimize(
            max(num_nodes, 1),
            dp,
            max_batch_size=self._max_batch_size,
            atomic_bsz_range=self._atomic_bsz_range,
            accumulation=self._accumulation,
            seq_shards=inc_sp,
            model_shards=inc_tp,
            stage_shards=inc_ss,
            pipeline_micro=inc_micro,
            expert_shards=inc_ep,
        )
        best_goodput = (
            self._cache.get((int(num_nodes), int(num_chips)), 0.0)
            * self._base_goodput
        )
        if best_goodput > threshold * float(inc_goodput):
            return bsz, accum, sp, tp, ss, ep, micro
        # The kept M must be schedulable at the re-optimized atomic
        # batch (optimize() prices it clamped the same way).
        inc_micro = min(inc_micro, max(int(inc_bsz), 1))
        return (
            int(inc_bsz), int(inc_accum),
            inc_sp, inc_tp, inc_ss, inc_ep, inc_micro,
        )

    def __call__(self, num_nodes, num_replicas):
        scalar = np.isscalar(num_nodes) and np.isscalar(num_replicas)
        nodes = np.atleast_1d(np.asarray(num_nodes, dtype=int))
        replicas = np.atleast_1d(np.asarray(num_replicas, dtype=int))
        nodes, replicas = np.broadcast_arrays(nodes, replicas)
        shape = nodes.shape
        nodes = nodes.ravel()
        replicas = replicas.ravel()
        out = np.zeros(nodes.shape, dtype=float)
        # Identify points not yet cached and evaluate them in one
        # vectorized optimize call.
        keys = list(zip(nodes.tolist(), replicas.tolist()))
        missing = sorted(
            {k for k in keys if k not in self._cache and k[1] > 0}
        )
        if missing:
            m_nodes = np.array([k[0] for k in missing])
            m_chips = np.array([k[1] for k in missing])
            goodput, bsz, accum, sps, tps, sss, eps, micros = (
                self._optimize(np.maximum(m_nodes, 1), m_chips)
            )
            goodput = np.atleast_1d(goodput)
            bsz = np.atleast_1d(bsz)
            accum = np.atleast_1d(accum)
            sps = np.atleast_1d(sps)
            tps = np.atleast_1d(tps)
            sss = np.atleast_1d(sss)
            eps = np.atleast_1d(eps)
            micros = np.atleast_1d(micros)
            for i, key in enumerate(missing):
                self._cache[key] = float(goodput[i]) / self._base_goodput
                self._config[key] = (
                    int(bsz[i]),
                    int(accum[i]),
                    int(sps[i]),
                    int(tps[i]),
                    int(sss[i]),
                    int(eps[i]),
                    int(micros[i]),
                )
        for i, key in enumerate(keys):
            out[i] = self._cache.get(key, 0.0)
        out = out.reshape(shape)
        return float(out.reshape(-1)[0]) if scalar else out
