"""Speedup function: a job's goodput normalised by its base goodput.

The port's copy of ``adaptdl_tpu.sched.policy.speedup``, data-parallel
only. It wraps a fitted :class:`adaptdl_tpu_torch.goodput.GoodputFunction`
as ``speedup(num_nodes, num_chips)``, the quantity the Pollux policy sums
across jobs. The genetic search evaluates the same few (nodes, chips)
points thousands of times per cycle, so results are cached in a table
filled lazily, with one vectorised ``optimize`` call per batch of new
points.

The JAX package also scores sequence, model, stage and expert
factorisations of each chip count; the port's trainer runs none of them
(``trainer.py`` raises on a sharded axis), so a job advertising any
raises here. With every limit 1 and no shape grid the JAX search is
exactly the dp-only one below (its ``optimize_topology`` over the one
factorisation (1, 1, 1, 1)), so the two tables agree.
"""

from __future__ import annotations

import numpy as np

# The dp-only configuration tail: (seq, model, stage, expert, micro).
_DP_ONLY = (1, 1, 1, 1, 1)


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
        limits = {
            "max_seq_shards": max_seq_shards,
            "max_model_shards": max_model_shards,
            "max_stage_shards": max_stage_shards,
            "max_expert_shards": max_expert_shards,
        }
        sharded = sorted(k for k, v in limits.items() if int(v or 1) > 1)
        if sharded or mesh_shape_grid:
            raise NotImplementedError(
                "mesh-shaped speedups (sequence, model, stage and expert "
                "axes) are not ported to adaptdl_tpu_torch yet (ROADMAP "
                f"Queue 1 item 7): {sharded or 'mesh_shape_grid'}"
            )
        # Accepted for the JAX signature; only a staged pipeline reads them.
        del max_pipeline_micro, pipeline_chunks
        self._goodput_fn = goodput_fn
        self._max_batch_size = max_batch_size
        self._atomic_bsz_range = atomic_bsz_range
        self._accumulation = accumulation
        # Base goodput: one chip on one node.
        base, _, _ = self._optimize(np.array([1]), np.array([1]))
        self._base_goodput = float(np.atleast_1d(base)[0])
        self._cache: dict[tuple[int, int], float] = {(0, 0): 0.0}
        # (nodes, chips) -> (atomic_bsz, accum_steps, sp, tp, ss, ep, micro)
        self._config: dict[tuple[int, int], tuple] = {}

    def _optimize(self, nodes, chips):
        """(goodput, atomic_bsz, accum_steps) at each (nodes, chips):
        the JAX ``optimize_topology`` at its one dp-only factorisation,
        fewer chips than nodes masked to zero goodput."""
        nodes = np.asarray(nodes)
        chips = np.asarray(chips)
        valid = chips >= np.maximum(nodes, 1)
        goodput, atomic_bsz, accum_steps = self._goodput_fn.optimize(
            np.where(valid, np.maximum(nodes, 1), 1),
            np.where(valid, np.maximum(chips, 1), 1),
            max_batch_size=self._max_batch_size,
            atomic_bsz_range=self._atomic_bsz_range,
            accumulation=self._accumulation,
        )
        goodput = np.where(valid, np.atleast_1d(goodput), 0.0)
        return goodput, np.atleast_1d(atomic_bsz), np.atleast_1d(accum_steps)

    def best_config(
        self, num_nodes: int, num_chips: int
    ) -> tuple[int, int, int, int, int, int, int]:
        """(atomic_bsz, accum_steps, seq_shards, model_shards,
        stage_shards, expert_shards, pipeline_micro) behind the speedup
        at this allocation; every shard count is 1."""
        self(num_nodes, num_chips)  # warm the cache
        return self._config.get(
            (int(num_nodes), int(num_chips)), (0, 0) + _DP_ONLY
        )

    def best_config_with_hysteresis(
        self,
        num_nodes: int,
        num_chips: int,
        incumbent: dict | None,
        threshold: float = 1.05,
    ) -> tuple[int, int, int, int, int, int, int]:
        """As :meth:`best_config`. The JAX package keeps an incumbent
        mesh factorisation against a near-tie challenger; with data
        parallelism only, the dp-only factorisation is both, so its
        hysteresis always returns the best config, as here."""
        del incumbent, threshold
        return self.best_config(num_nodes, num_chips)

    def __call__(self, num_nodes, num_replicas):
        scalar = np.isscalar(num_nodes) and np.isscalar(num_replicas)
        nodes = np.atleast_1d(np.asarray(num_nodes, dtype=int))
        replicas = np.atleast_1d(np.asarray(num_replicas, dtype=int))
        nodes, replicas = np.broadcast_arrays(nodes, replicas)
        shape = nodes.shape
        nodes = nodes.ravel()
        replicas = replicas.ravel()
        out = np.zeros(nodes.shape, dtype=float)
        keys = list(zip(nodes.tolist(), replicas.tolist()))
        missing = sorted(
            {k for k in keys if k not in self._cache and k[1] > 0}
        )
        if missing:
            m_nodes = np.array([k[0] for k in missing])
            m_chips = np.array([k[1] for k in missing])
            goodput, bsz, accum = self._optimize(
                np.maximum(m_nodes, 1), m_chips
            )
            for i, key in enumerate(missing):
                self._cache[key] = float(goodput[i]) / self._base_goodput
                self._config[key] = (
                    int(bsz[i]), int(accum[i])
                ) + _DP_ONLY
        for i, key in enumerate(keys):
            out[i] = self._cache.get(key, 0.0)
        out = out.reshape(shape)
        return float(out.reshape(-1)[0]) if scalar else out
