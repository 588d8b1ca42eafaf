"""The goodput model: throughput x statistical efficiency.

A copy of the model in ``adaptdl_tpu.goodput`` (the Pollux objective):

    goodput = throughput(config) * efficiency(global_batch_size)

- **throughput** comes from a fitted performance model that splits a
  step into compute time (linear in the per-device batch) and network
  time (gradient all-reduce), combined with a gamma-p-norm that models
  compute/communication overlap. The "inter-node" network terms model
  links between hosts and the "intra-node" terms the links within one.
- **efficiency** is the statistical efficiency of large-batch SGD from
  the gradient noise scale: with signal ``sqr`` = |E[g]|^2 and noise
  ``var`` = tr(Var[g]) at the initial batch size, scaling the batch by
  ``s`` yields gain ``(var + sqr) / (var/s + sqr)`` out of ``s``.

``fit_perf_params`` recovers the performance parameters from profiled
step timings by L-BFGS-B on a log-space RMSE, differentiated with
PyTorch autograd in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.optimize

class PerfParams(NamedTuple):
    """Fitted performance-model parameters.

    Step-time model (all times in seconds), for a job factorized as
    ``dp`` data-parallel replica groups of ``sp x tp``
    (sequence-parallel x tensor-parallel) chips each:

    - accum step (no grad sync): compute is linear in the *per-chip*
      share of the replica's microbatch,
      ``alpha_c + beta_c * atomic_bsz / (sp * tp)``, plus the in-step
      collectives the shards cost —
      ring attention's KV rotation ``(sp-1)/sp * (alpha_sp + beta_sp *
      atomic_bsz / tp)`` and tensor-parallel activation collectives
      ``(tp-1)/tp * (alpha_tp + beta_tp * atomic_bsz / sp)`` (both ride
      ICI within the replica group, both appear in compute-only
      calibration steps because they live inside forward/backward).
    - gradient sync: ``alpha_n + beta_n * max(dp - 2, 0)`` when the job
      spans slices (DCN bottleneck), ``alpha_r + beta_r * ...`` when it
      is confined to one slice (ICI bottleneck), ~0 for one replica.
    - optim step (with sync): ``(T_acc**gamma + T_net**gamma)**(1/gamma)``
      — gamma in [1, 10] interpolates between no overlap (1) and
      perfect overlap (max, ~10).

    The first 7 fields are the reference's published Pollux model with
    DCN/ICI in place of inter/intra-node NCCL (reference:
    adaptdl/adaptdl/goodput.py:31-49); the last 4 price the sp/tp mesh
    axes the reference does not have, so the scheduler can search
    (data, seq, model) factorizations on the same fitted surface. They
    default to 0 (optimistic-until-profiled, the same philosophy as the
    reference's unidentified-term pinning) and old 7-field checkpoints
    unpickle into them cleanly.
    """

    alpha_c: float
    beta_c: float
    alpha_n: float
    beta_n: float
    alpha_r: float
    beta_r: float
    gamma: float
    alpha_sp: float = 0.0
    beta_sp: float = 0.0
    alpha_tp: float = 0.0
    beta_tp: float = 0.0
    # Pipeline handoff cost per schedule tick (one ppermute of one
    # microbatch's activations between neighboring stages). The
    # pipeline BUBBLE needs no fitted parameter — it is structural:
    # a GPipe schedule with M microbatches over S stages runs
    # (M + S - 1) ticks of per-stage work, an (M+S-1)/M stretch.
    alpha_pp: float = 0.0
    beta_pp: float = 0.0
    # Expert-parallel all_to_all cost (the GShard dispatch + return
    # exchange per microbatch). Fitted from observations at
    # expert_shards > 1; also absorbs whatever expert sharding does
    # NOT divide (e.g. redundantly-computed attention within the
    # expert group), since the compute term optimistically divides by
    # every shard axis.
    alpha_ep: float = 0.0
    beta_ep: float = 0.0


class GradParams(NamedTuple):
    """Gradient signal (|E[g]|^2) and noise (tr Var[g]) estimates."""

    sqr: float
    var: float


# The model formulas are written against a pluggable array module so the
# same code runs under numpy (fast host-side evaluation) and the torch
# namespace below (differentiable, for fitting).


def _accum_time(
    xp,
    params,
    atomic_bsz,
    seq_shards=1,
    model_shards=1,
    stage_shards=1,
    pipeline_micro=1,
    expert_shards=1,
    pipeline_interleave=1,
):
    """Forward+backward time of one microbatch on one chip.

    Compute divides across the replica group's sp x tp x ss x ep
    chips; the ring/TP/expert collective terms are the price of the
    sp/tp/ep division, and the pipeline pays a structural (M+S-1)/M
    bubble stretch plus a fitted per-tick handoff cost (zero when the
    corresponding axis is unsharded).
    """
    shards = seq_shards * model_shards * stage_shards * expert_shards
    compute = params[0] + params[1] * atomic_bsz / shards
    ring = ((seq_shards - 1) / xp.maximum(seq_shards, 1)) * (
        params[7] + params[8] * atomic_bsz / model_shards
    )
    tp = ((model_shards - 1) / xp.maximum(model_shards, 1)) * (
        params[9] + params[10] * atomic_bsz / seq_shards
    )
    # Two all_to_alls (dispatch + return) per microbatch; volume is
    # this device's token slice of the replica's batch.
    ep = ((expert_shards - 1) / xp.maximum(expert_shards, 1)) * (
        params[13]
        + params[14] * atomic_bsz / (seq_shards * model_shards)
    )
    base = compute + ring + tp + ep
    # Degenerates exactly to `base` at stage_shards == 1 (ticks == M,
    # stretch == 1, zero hops). With an interleaved schedule (v model
    # chunks per device, parallel/pipeline.py interleaved_pipeline)
    # a tick is 1/v of a stage-pass: v*M + S - 1 ticks total, bubble
    # (S-1)/(v*M + S - 1), at v x the hand-off count.
    v = xp.maximum(pipeline_interleave, 1)
    ticks = v * pipeline_micro + stage_shards - 1
    stretch = ticks / xp.maximum(v * pipeline_micro, 1)
    has_hops = (stage_shards - 1) / xp.maximum(stage_shards - 1, 1)
    hop_cost = params[11] + params[12] * atomic_bsz / xp.maximum(
        pipeline_micro, 1
    )
    return base * stretch + has_hops * ticks * hop_cost


def _network_time(xp, params, num_nodes, num_replicas):
    """Gradient all-reduce time on the bottleneck link.

    DCN (cross-slice) dominates when num_nodes > 1; otherwise ICI
    (intra-slice) when num_replicas > 1; otherwise no sync at all. The
    retrogression term grows with the ring size beyond 2 replicas.
    """
    multi_node = num_nodes > 1
    multi_replica = num_replicas > 1
    base = xp.where(
        multi_node, params[2], xp.where(multi_replica, params[4], 1e-8)
    )
    slope = xp.where(
        multi_node, params[3], xp.where(multi_replica, params[5], 1e-8)
    )
    return base + slope * xp.maximum(num_replicas - 2, 1e-8)


def _log_optim_time(xp, params, accum_time, network_time):
    """log of the gamma-p-norm combining compute and network time."""
    gamma = params[6]
    return xp.log(accum_time**gamma + network_time**gamma) / gamma



def mesh_shape_grid(
    max_seq_shards: int = 1,
    max_model_shards: int = 1,
    max_stage_shards: int = 1,
    max_expert_shards: int = 1,
    num_chips: int | None = None,
    max_candidates: int = 64,
) -> tuple[tuple[int, int, int, int], ...]:
    """The bounded candidate set of mesh shapes ``(sp, tp, ss, ep)``
    the scheduler may factorize a job's chips into.

    Per-axis candidate values are the powers of two up to the job's
    advertised limit plus — when ``num_chips`` is known — every
    divisor of the chip count within the limit, so non-power-of-two
    slice counts (12 chips -> tp=3) are searchable instead of falling
    through to pure DP. The cross product is filtered to shapes whose
    group size divides ``num_chips`` (when given), deduplicated, and
    truncated deterministically to ``max_candidates`` smallest-group-
    first — the same bounded-candidate philosophy as the incremental
    allocator's slice-inventory cap. ``(1, 1, 1, 1)`` (pure DP) is
    always first and never truncated away, so a dp-only job's grid is
    exactly ``((1, 1, 1, 1),)``.
    """

    def axis_values(limit: int) -> list[int]:
        limit = max(int(limit), 1)
        values = set()
        v = 1
        while v <= limit:
            values.add(v)
            v *= 2
        if num_chips:
            for d in range(1, min(limit, int(num_chips)) + 1):
                if num_chips % d == 0:
                    values.add(d)
        return sorted(values)

    shapes = set()
    for sp in axis_values(max_seq_shards):
        for tp in axis_values(max_model_shards):
            for ss in axis_values(max_stage_shards):
                for ep in axis_values(max_expert_shards):
                    group = sp * tp * ss * ep
                    if num_chips and (
                        group > num_chips or num_chips % group
                    ):
                        continue
                    shapes.add((sp, tp, ss, ep))
    shapes.add((1, 1, 1, 1))
    ordered = sorted(
        shapes, key=lambda s: (s[0] * s[1] * s[2] * s[3], s)
    )
    cap = max(int(max_candidates), 1)
    return tuple(ordered[:cap])


class GoodputFunction:
    """Evaluates and optimizes goodput for one job's fitted parameters."""

    def __init__(self, perf_params, grad_params, init_batch_size: int):
        self._perf_params = PerfParams(*perf_params)
        self._grad_params = GradParams(*grad_params)
        self._init_batch_size = init_batch_size

    def __call__(
        self,
        num_nodes,
        num_replicas,
        atomic_bsz,
        accum_steps,
        seq_shards=1,
        model_shards=1,
        stage_shards=1,
        pipeline_micro=1,
        expert_shards=1,
        pipeline_interleave=1,
    ):
        return self.evaluate(
            num_nodes,
            num_replicas,
            atomic_bsz,
            accum_steps,
            seq_shards=seq_shards,
            model_shards=model_shards,
            stage_shards=stage_shards,
            pipeline_micro=pipeline_micro,
            expert_shards=expert_shards,
            pipeline_interleave=pipeline_interleave,
        )

    def evaluate(
        self,
        num_nodes,
        num_replicas,
        atomic_bsz,
        accum_steps,
        seq_shards=1,
        model_shards=1,
        stage_shards=1,
        pipeline_micro=1,
        expert_shards=1,
        pipeline_interleave=1,
    ):
        """num_replicas counts *data-parallel* replica groups; each
        group spans seq_shards*model_shards*stage_shards*expert_shards
        chips. sp/tp/ss/ep leave the statistical batch size untouched —
        they divide the sample/model, not multiply the samples."""
        batch_size = num_replicas * atomic_bsz * (accum_steps + 1)
        assert np.all(batch_size >= self._init_batch_size)
        return self.throughput(
            num_nodes,
            num_replicas,
            atomic_bsz,
            accum_steps,
            seq_shards=seq_shards,
            model_shards=model_shards,
            stage_shards=stage_shards,
            pipeline_micro=pipeline_micro,
            expert_shards=expert_shards,
            pipeline_interleave=pipeline_interleave,
        ) * self.efficiency(batch_size)

    def throughput(
        self,
        num_nodes,
        num_replicas,
        atomic_bsz,
        accum_steps,
        seq_shards=1,
        model_shards=1,
        stage_shards=1,
        pipeline_micro=1,
        expert_shards=1,
        pipeline_interleave=1,
    ):
        """Samples/second: an iteration is accum_steps silent accumulation
        micro-steps plus one optim step that includes the gradient sync."""
        p = self._perf_params
        t_acc = _accum_time(
            np, p, atomic_bsz, seq_shards, model_shards,
            stage_shards, pipeline_micro, expert_shards,
            pipeline_interleave,
        )
        t_net = _network_time(np, p, num_nodes, num_replicas)
        t_opt = np.exp(_log_optim_time(np, p, t_acc, t_net))
        iter_time = accum_steps * t_acc + t_opt
        batch_size = num_replicas * atomic_bsz * (accum_steps + 1)
        return batch_size / iter_time

    def efficiency(self, batch_size):
        """Statistical efficiency in (0, 1]: gain per unit of batch scale."""
        sqr, var = self._grad_params
        scale = batch_size / self._init_batch_size
        denom = var / scale + sqr
        gain = np.where(denom > 0, (var + sqr) / denom, 1.0)
        return gain / scale

    def optimize(
        self,
        num_nodes,
        num_replicas,
        max_batch_size=None,
        atomic_bsz_range=None,
        accumulation: bool = False,
        num_candidates: int = 50,
        seq_shards: int = 1,
        model_shards: int = 1,
        stage_shards: int = 1,
        pipeline_micro: int = 1,
        expert_shards: int = 1,
        pipeline_interleave: int = 1,
    ):
        """Best (goodput, atomic_bsz, accum_steps) per allocation, at a
        *fixed* (seq_shards, model_shards, stage_shards, expert_shards)
        topology.

        Vectorized over broadcastable ``num_nodes``/``num_replicas``:
        candidate global batch sizes are sampled geometrically between
        the feasible minimum and ``max_batch_size``, converted to
        per-chip (atomic_bsz, accum_steps) pairs, and scored. The
        atomic-bsz memory ceiling scales with the shard count — an
        sp x tp group holds only ``1/(sp*tp)`` of each microbatch's
        activations per chip.
        """
        num_nodes = np.asarray(num_nodes)
        num_replicas = np.asarray(num_replicas)
        assert np.all(num_nodes >= 1)
        assert np.all(num_replicas >= num_nodes)
        if max_batch_size is None:
            max_batch_size = self._init_batch_size
        assert max_batch_size >= self._init_batch_size
        min_atomic, max_atomic = atomic_bsz_range or (None, None)
        min_atomic = min_atomic or 1
        max_atomic = max_atomic or max_batch_size
        # Memory ceiling: sp/tp split each microbatch's activations
        # across the group, so the per-replica atomic ceiling scales
        # with them. STAGE does not — GPipe stages hold ~M in-flight
        # microbatch activations, so per-chip activation memory is
        # roughly unchanged by pipeline depth.
        group = seq_shards * model_shards
        if group > 1:
            max_atomic = max_atomic * group

        shape = np.broadcast_shapes(num_nodes.shape, num_replicas.shape)
        scalar_out = shape == ()
        nodes = np.broadcast_to(num_nodes, shape).ravel()
        replicas = np.broadcast_to(num_replicas, shape).ravel()

        # Candidate axis 0: geometric sweep of global batch size from the
        # smallest feasible value up to max_batch_size.
        lo = np.maximum(self._init_batch_size, min_atomic * replicas)
        global_bsz = np.geomspace(lo, max_batch_size, num=num_candidates)
        local_bsz = global_bsz / replicas
        eps = 1e-8
        if accumulation:
            accum_steps = np.ceil(local_bsz / max_atomic - eps) - 1
            # A single replica estimates gradient noise from differenced
            # consecutive micro-batches, which needs >= 2 micro-batches
            # whenever the batch is actually scaled up.
            needs_accum = (replicas == 1) & (
                local_bsz > self._init_batch_size + eps
            )
            accum_steps = np.where(
                needs_accum, np.maximum(accum_steps, 1), accum_steps
            ).astype(int)
            atomic_bsz = np.ceil(local_bsz / (accum_steps + 1) - eps)
        else:
            accum_steps = np.zeros_like(local_bsz, dtype=int)
            # Without accumulation a single replica cannot scale its
            # batch without distorting noise estimates; pin it.
            atomic_bsz = np.where(
                replicas == 1, self._init_batch_size, np.ceil(local_bsz - eps)
            )
        atomic_bsz = np.clip(atomic_bsz, min_atomic, max_atomic).astype(int)

        # A pipeline microbatch cannot be smaller than one sample:
        # clamp the schedule's M to the candidate's atomic batch so
        # tiny-batch candidates are priced at a feasible M. The
        # interleaved schedule additionally requires M >= S (wrap-hop
        # buffering window, parallel/pipeline.py) — candidates whose
        # clamped M falls below that run (and are priced as) plain
        # GPipe.
        micro_eff = np.minimum(pipeline_micro, np.maximum(atomic_bsz, 1))
        interleave_eff = np.where(
            micro_eff >= stage_shards, pipeline_interleave, 1
        )
        goodput = self.evaluate(
            nodes,
            replicas,
            atomic_bsz,
            accum_steps,
            seq_shards=seq_shards,
            model_shards=model_shards,
            stage_shards=stage_shards,
            pipeline_micro=micro_eff,
            expert_shards=expert_shards,
            pipeline_interleave=interleave_eff,
        )
        best = np.argmax(goodput, axis=0)
        cols = np.arange(goodput.shape[1])
        goodput = goodput[best, cols].reshape(shape)
        atomic_bsz = atomic_bsz[best, cols].reshape(shape)
        accum_steps = accum_steps[best, cols].reshape(shape)
        if scalar_out:
            return goodput.item(), atomic_bsz.item(), accum_steps.item()
        return goodput, atomic_bsz, accum_steps

    def optimize_topology(
        self,
        num_nodes,
        num_chips,
        max_batch_size=None,
        atomic_bsz_range=None,
        accumulation: bool = False,
        num_candidates: int = 50,
        max_seq_shards: int = 1,
        max_model_shards: int = 1,
        max_stage_shards: int = 1,
        max_pipeline_micro: int = 8,
        max_expert_shards: int = 1,
        pipeline_chunks: int = 0,
        shape_grid=None,
    ):
        """Best configuration over (data, seq, model, stage, expert)
        factorizations AND the pipeline microbatch count.

        ``num_chips`` counts total chips in the allocation; every
        power-of-two factorization ``chips = dp * sp * tp * ss * ep``
        with each axis within its advertised limit and at least one
        replica group per spanned slice is scored with :meth:`optimize`
        and the argmax wins. Stage factorizations are additionally
        scored at every power-of-two GPipe microbatch count M up to
        ``max_pipeline_micro``: more microbatches shrink the structural
        (M+S-1)/M bubble but pay the per-tick handoff (alpha_pp) more
        often, so M is a real decision variable, not an assumption.
        This is the search the reference never needed — its only axis
        is data parallelism (reference: adaptdl/adaptdl/goodput.py:
        88-148 searches batch geometry at fixed parallelism).

        ``pipeline_chunks`` declares how many uniform model chunks
        the job can split into (parallel/pipeline.py
        stack_interleaved_params); a stage candidate ss runs the
        interleaved schedule with v = pipeline_chunks // ss chunks per
        device (bubble (S-1)/(v*M + S - 1)), falling back to plain
        GPipe (v = 1) when the chunks don't divide or none were
        declared.

        ``shape_grid`` overrides the power-of-two enumeration with an
        explicit candidate set of ``(sp, tp, ss, ep)`` shapes (see
        :func:`mesh_shape_grid`) — how a job advertises non-pow2
        factorizations. ``None`` keeps the default enumeration from
        the ``max_*`` limits, whose all-ones case reduces exactly to
        one :meth:`optimize` call (the dp-only path is the special
        case, not a separate code path).

        Returns ``(goodput, atomic_bsz, accum_steps, seq_shards,
        model_shards, stage_shards, expert_shards, pipeline_micro)``,
        vectorized like :meth:`optimize`.
        """
        num_nodes = np.asarray(num_nodes)
        num_chips = np.asarray(num_chips)
        shape = np.broadcast_shapes(num_nodes.shape, num_chips.shape)
        scalar_out = shape == ()
        nodes = np.broadcast_to(num_nodes, shape).ravel()
        chips = np.broadcast_to(num_chips, shape).ravel()

        def pow2s(limit):
            out, v = [], 1
            while v <= limit:
                out.append(v)
                v *= 2
            return out

        micro_candidates = pow2s(max(int(max_pipeline_micro), 1))
        if shape_grid is not None:
            base_shapes = [
                (
                    max(int(sp), 1), max(int(tp), 1),
                    max(int(ss), 1), max(int(ep), 1),
                )
                for sp, tp, ss, ep in shape_grid
            ] or [(1, 1, 1, 1)]
        else:
            base_shapes = [
                (sp, tp, ss, ep)
                for sp in pow2s(max(int(max_seq_shards), 1))
                for tp in pow2s(max(int(max_model_shards), 1))
                for ss in pow2s(max(int(max_stage_shards), 1))
                for ep in pow2s(max(int(max_expert_shards), 1))
            ]
        factorizations = [
            (sp, tp, ss, ep, micro)
            for sp, tp, ss, ep in base_shapes
            # M only matters with a pipeline; ss == 1 pins M = 1.
            for micro in (micro_candidates if ss > 1 else [1])
        ]
        results = []
        for sp, tp, ss, ep, micro in factorizations:
            group = sp * tp * ss * ep
            dp = chips // group
            valid = (dp * group == chips) & (dp >= np.maximum(nodes, 1))
            interleave = 1
            if pipeline_chunks and ss > 1 and pipeline_chunks % ss == 0:
                # interleaved_pipeline requires M >= S; only price the
                # schedule where it is actually runnable.
                if micro >= ss:
                    interleave = max(pipeline_chunks // ss, 1)
            # Placeholder dp=1 keeps optimize()'s vectorized call well
            # formed for invalid rows; their goodput is masked to 0.
            dp_safe = np.where(valid, np.maximum(dp, 1), 1)
            nodes_safe = np.where(valid, np.maximum(nodes, 1), 1)
            g, ab, ac = self.optimize(
                nodes_safe,
                dp_safe,
                max_batch_size=max_batch_size,
                atomic_bsz_range=atomic_bsz_range,
                accumulation=accumulation,
                num_candidates=num_candidates,
                seq_shards=sp,
                model_shards=tp,
                stage_shards=ss,
                pipeline_micro=micro,
                expert_shards=ep,
                pipeline_interleave=interleave,
            )
            g = np.where(valid, np.atleast_1d(g), 0.0)
            results.append(
                (g, np.atleast_1d(ab), np.atleast_1d(ac),
                 sp, tp, ss, ep, micro)
            )
        all_g = np.stack([r[0] for r in results])
        best = np.argmax(all_g, axis=0)
        cols = np.arange(all_g.shape[1])
        goodput = all_g[best, cols].reshape(shape)
        atomic_bsz = np.stack([r[1] for r in results])[best, cols].reshape(
            shape
        )
        accum_steps = np.stack([r[2] for r in results])[
            best, cols
        ].reshape(shape)
        sps = np.array([r[3] for r in results])[best].reshape(shape)
        tps = np.array([r[4] for r in results])[best].reshape(shape)
        sss = np.array([r[5] for r in results])[best].reshape(shape)
        eps_ = np.array([r[6] for r in results])[best].reshape(shape)
        micros = np.array([r[7] for r in results])[best].reshape(shape)
        # Report the M actually schedulable at the chosen atomic batch
        # (optimize() clamps internally the same way).
        micros = np.minimum(micros, np.maximum(atomic_bsz, 1))
        if scalar_out:
            return (
                goodput.item(),
                atomic_bsz.item(),
                accum_steps.item(),
                sps.item(),
                tps.item(),
                sss.item(),
                eps_.item(),
                micros.item(),
            )
        return (
            goodput, atomic_bsz, accum_steps, sps, tps, sss, eps_, micros
        )


def _fit_objective(
    xp,
    params,
    num_nodes,
    num_replicas,
    atomic_bsz,
    seq_shards,
    model_shards,
    stage_shards,
    pipeline_micro,
    expert_shards,
    pipeline_interleave,
    accum_time,
    optim_time,
    weight,
):
    """Log-space weighted RMSE of predicted vs measured step times +
    priors; ``weight`` masks rows out of the fit."""
    pred_acc = _accum_time(
        xp, params, atomic_bsz, seq_shards, model_shards,
        stage_shards, pipeline_micro, expert_shards,
        pipeline_interleave,
    )
    pred_net = _network_time(xp, params, num_nodes, num_replicas)
    pred_log_opt = _log_optim_time(xp, params, pred_acc, pred_net)
    total = xp.sum(weight)
    err_acc = xp.sqrt(
        xp.sum(weight * (xp.log(pred_acc) - xp.log(accum_time)) ** 2)
        / total
    )
    err_opt = xp.sqrt(
        xp.sum(weight * (pred_log_opt - xp.log(optim_time)) ** 2)
        / total
    )
    # Prefer small gamma (easier landscape) and small retrogression
    # relative to the constant network terms (optimistic scaling).
    reg_gamma = 1e-3 * (params[6] - 1.0) ** 2
    reg_retro = 1e-2 * (
        (params[3] / params[2]) ** 2 + (params[5] / params[4]) ** 2
    )
    return err_acc + err_opt + reg_gamma + reg_retro


class _TorchOps:
    """The slice of the array namespace the model formulas use, over
    torch tensors (the second operand of ``maximum`` is a number).
    torch is imported at the call: the control plane evaluates the model
    with numpy and never imports it."""

    @staticmethod
    def log(x):
        import torch

        return torch.log(x)

    @staticmethod
    def sum(x, *args, **kwargs):
        import torch

        return torch.sum(x, *args, **kwargs)

    @staticmethod
    def sqrt(x):
        import torch

        return torch.sqrt(x)

    @staticmethod
    def maximum(x, floor):
        import torch

        return torch.clamp(x, min=floor)

    @staticmethod
    def where(cond, x, y):
        import torch

        return torch.where(cond, x, y)


def fit_perf_params(
    num_nodes,
    num_replicas,
    atomic_bsz,
    accum_step_time,
    optim_step_time,
    seq_shards=None,
    model_shards=None,
    stage_shards=None,
    pipeline_micro=None,
    expert_shards=None,
    pipeline_interleave=None,
) -> PerfParams:
    """Fit PerfParams to profiled timings via L-BFGS-B + torch autograd.

    Parameters that the observed configurations cannot identify are
    pinned (e.g. DCN terms without any multi-slice measurements), which
    keeps the speedup model optimistic about unexplored allocations so
    the scheduler will actually try them (reference behavior:
    adaptdl/adaptdl/goodput.py:175-194). Unprofiled ring/TP terms get
    an ICI-latency prior rather than zero — sharding an axis is never
    entirely free, so the topology search cannot runaway-shard on pure
    optimism.
    """
    num_nodes = np.asarray(num_nodes, dtype=float)
    num_replicas = np.asarray(num_replicas, dtype=float)
    atomic_bsz = np.asarray(atomic_bsz, dtype=float)
    accum_step_time = np.asarray(accum_step_time, dtype=float)
    optim_step_time = np.asarray(optim_step_time, dtype=float)
    if seq_shards is None:
        seq_shards = np.ones_like(num_nodes)
    if model_shards is None:
        model_shards = np.ones_like(num_nodes)
    if stage_shards is None:
        stage_shards = np.ones_like(num_nodes)
    if pipeline_micro is None:
        pipeline_micro = np.ones_like(num_nodes)
    if expert_shards is None:
        expert_shards = np.ones_like(num_nodes)
    if pipeline_interleave is None:
        pipeline_interleave = np.ones_like(num_nodes)
    seq_shards = np.asarray(seq_shards, dtype=float)
    model_shards = np.asarray(model_shards, dtype=float)
    stage_shards = np.asarray(stage_shards, dtype=float)
    pipeline_micro = np.asarray(pipeline_micro, dtype=float)
    expert_shards = np.asarray(expert_shards, dtype=float)
    pipeline_interleave = np.asarray(pipeline_interleave, dtype=float)

    init = np.array(
        [1e-1, 1e-2, 1e-1, 1e-2, 1e-1, 1e-2, 1.0 + 1e-3]
        + [1e-2, 1e-3, 1e-2, 1e-3]
        + [1e-2, 1e-3]
        + [1e-2, 1e-3]
    )
    lower = np.array([1e-8] * 6 + [1.0] + [1e-8] * 8)
    upper = np.array([np.inf] * 6 + [10.0] + [np.inf] * 8)

    if len(np.unique(atomic_bsz)) == 1:
        # One observed batch size can't separate the constant and linear
        # compute terms; split the measured time evenly between them.
        init[0] = lower[0] = upper[0] = accum_step_time.mean() / 2
    if not np.any(num_nodes > 1):
        init[2] = upper[2] = lower[2]  # no DCN observations
        init[3] = upper[3] = lower[3]
    if not np.any((num_nodes == 1) & (num_replicas > 1)):
        init[4] = upper[4] = lower[4]  # no single-slice multi-replica obs
        init[5] = upper[5] = lower[5]
    if not np.any(num_replicas > 2):
        init[3] = upper[3] = lower[3]  # retrogression unidentifiable
        init[5] = upper[5] = lower[5]
    sp_observed = bool(np.any(seq_shards > 1))
    tp_observed = bool(np.any(model_shards > 1))
    ss_observed = bool(np.any(stage_shards > 1))
    ep_observed = bool(np.any(expert_shards > 1))
    if not sp_observed:
        init[7] = upper[7] = lower[7]  # ring terms unidentifiable
        init[8] = upper[8] = lower[8]
    if not tp_observed:
        init[9] = upper[9] = lower[9]  # TP terms unidentifiable
        init[10] = upper[10] = lower[10]
    if not ss_observed:
        init[11] = upper[11] = lower[11]  # pipeline hop unidentifiable
        init[12] = upper[12] = lower[12]
    if not ep_observed:
        init[13] = upper[13] = lower[13]  # all_to_all unidentifiable
        init[14] = upper[14] = lower[14]

    import torch

    args = tuple(
        torch.as_tensor(a, dtype=torch.float64)
        for a in (
            num_nodes,
            num_replicas,
            atomic_bsz,
            seq_shards,
            model_shards,
            stage_shards,
            pipeline_micro,
            expert_shards,
            pipeline_interleave,
            accum_step_time,
            optim_step_time,
            np.ones(len(num_nodes)),
        )
    )

    def fun(p):
        params = torch.tensor(p, dtype=torch.float64, requires_grad=True)
        value = _fit_objective(_TorchOps, params, *args)
        (grad,) = torch.autograd.grad(value, params)
        return float(value.detach()), grad.numpy()

    result = scipy.optimize.minimize(
        fun,
        init,
        jac=True,
        bounds=scipy.optimize.Bounds(lower, upper, keep_feasible=True),
    )
    params = result.x
    if not np.any(num_nodes > 1):
        # Prior: crossing DCN is never cheaper than staying on ICI.
        params[2] = max(params[2], params[4] * 1.1)
        params[3] = max(params[3], params[5] * 1.1)
    # Priors for unprofiled sharding axes: a ring hop / TP collective
    # costs at least the fitted ICI latency — optimistic enough that
    # the scheduler will try the axis, never literally free.
    if not sp_observed:
        params[7] = max(params[7], params[4])
    if not tp_observed:
        params[9] = max(params[9], params[4])
    if not ss_observed:
        # A pipeline handoff costs at least the fitted ICI latency
        # (the structural bubble already tempers over-optimism).
        params[11] = max(params[11], params[4])
    if not ep_observed:
        # An expert all_to_all costs at least the fitted ICI latency.
        params[13] = max(params[13], params[4])
    return PerfParams(*params)
