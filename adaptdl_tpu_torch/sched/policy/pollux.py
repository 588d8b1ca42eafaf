"""Pollux scheduling policy, the port's copy of
``adaptdl_tpu.sched.policy.pollux`` (pure numpy, the same search step
for step, so equal inputs and seeds give equal allocations).

Co-optimizes every job's replica allocation and the cluster size by
maximizing the sum of goodput-derived speedups (OSDI'21 Pollux;
reference: sched/adaptdl_sched/policy/pollux.py). Key semantics kept
from the reference, re-expressed for slices:

- state: integer matrix ``A[j, s]`` = replicas of job j on slice s,
  with as many *virtual* slices appended as real ones so the search can
  propose growing the cluster (autoscaling).
- objectives: (-sum of scaled speedups, number of active slices).
  Speedups are normalized by each job's dominant resource share so one
  "fair share" of the cluster ~ speedup 1; solutions that move a job
  off its current allocation pay a 10% restart penalty (checkpoint-
  restart is cheap but not free). Placements on hazardous (spot)
  slices additionally pay an **expected-loss** term — the sum of the
  occupied slices' reclaim-hazard rates times the job's measured
  restart cost — so expensive-restart jobs migrate to on-demand
  capacity while cheap-restart jobs soak up the spot discount.
- feasibility (the repair step): pinned (non-preemptible, already
  running) jobs keep their allocation; at most one *distributed* job
  per slice — a job spanning chips owns the slice's ICI; per-job
  min/max replica bounds; per-slice resource capacity.
- the final allocation is chosen from the Pareto front subject to the
  autoscaler's node budget; desired cluster size targets average
  utilization inside [0.35, 0.65] (reference: pollux.py:121-142).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from collections import OrderedDict

import numpy as np

from adaptdl_tpu_torch import env
from adaptdl_tpu_torch.sched.policy import nsga2
from adaptdl_tpu_torch.sched.policy.utils import JobInfo

LOG = logging.getLogger(__name__)

RESTART_PENALTY = 0.1
# Assumed checkpoint-restart cost (seconds) for jobs that have not
# posted measured restartStats yet — RESTART_PENALTY amortized over
# the allocator's 5-minute horizon (allocator.RESTART_AMORTIZATION_S),
# so the hazard term and the move penalty price restarts consistently.
DEFAULT_RESTART_COST_S = 30.0
# Ceiling on the hazard expected-loss fraction: even a hazard-saturated
# placement keeps a sliver of scored goodput, so the search can still
# rank terrible options instead of flattening them all to zero.
MAX_HAZARD_LOSS = 0.9


class PolluxPolicy:
    def __init__(
        self,
        pop_size: int = 100,
        generations: int = 100,
        partition_slices: int = 64,
        util_band: tuple[float, float] | None = None,
    ):
        self._pop_size = pop_size
        self._generations = generations
        # Target cluster-utilization band for the autoscaling
        # objective (reference: pollux.py:121-142). Allocation picks
        # are clamped to the band-derived node budget so capacity the
        # autoscaler wants to retire drains; a STATICALLY provisioned
        # cluster (no expander — e.g. the simulator) should widen the
        # band to (0, 1) so free capacity is actually used.
        self._min_util, self._max_util = util_band or (0.35, 0.65)
        self._prev_population = None
        self._prev_jobs: list = []
        self._prev_nodes: list = []
        # Above this many slices a full cycle runs PARTITIONED (the
        # Pollux paper's scalability device): jobs and nodes are
        # split into sub-problems of at most this many slices each,
        # solved independently, and merged — search cost grows
        # linearly with cluster size instead of quadratically.
        self._partition_slices = max(int(partition_slices), 1)
        # Desired-node target of the last full cycle; incremental
        # cycles reuse it (autoscaling decisions ride full cycles).
        self._last_full_desired: int | None = None
        # Candidate-inventory cap for the incremental path: a dirty
        # job is re-searched over its own slices plus the best free
        # slices, not the whole 10k-slot inventory.
        self._incremental_candidates = 64
        # Decision provenance (graftwatch): optimize()/
        # optimize_incremental() leave the cycle's explain record
        # here — candidates scored, winner, top-k losers with the
        # objective term that killed them, per-job terms. Written by
        # the allocator thread only; the allocator hands it to the
        # watch store right after the cycle.
        self.last_explain: dict | None = None
        self._last_single_explain: dict | None = None

    # -- single-job arrival (cheap path) ------------------------------

    def allocate_job(
        self, job_info: JobInfo, nodes: dict, quarantined=()
    ) -> list:
        """First-fit of a newly arrived job's min_replicas (reference:
        pollux.py:43-70). ``quarantined`` slots are skipped — they
        struck out of the transactional-rescale commit loop and must
        not host placements until their un-quarantine probe."""
        want = max(job_info.min_replicas, 1)
        if quarantined:
            nodes = {
                name: node
                for name, node in nodes.items()
                if name not in quarantined
            }
        for name, node in _sorted_nodes(nodes).items():
            fits = min(
                node.resources.get(rtype, 0) // amount
                for rtype, amount in job_info.resources.items()
                if amount > 0
            )
            if fits >= want:
                return [name] * want
        return []

    # -- full optimization cycle --------------------------------------

    def optimize(
        self,
        jobs,
        nodes,
        base_allocations,
        node_template,
        quarantined=(),
    ):
        """One FULL Pollux cycle.

        Args:
          jobs: {job_key: JobInfo} incomplete jobs.
          nodes: {node_key: NodeInfo} existing slices.
          base_allocations: {job_key: [node_key per replica]} current.
          node_template: NodeInfo for a provisionable slice.
          quarantined: slot keys the search must not place jobs on
            (struck out of the transactional-rescale commit loop).
            Dropping them from the inventory also drops any base
            allocation entries they held, so preemptible incumbents
            migrate off a quarantined slot instead of being pinned to
            it. A slot a NON-preemptible incumbent still runs on stays
            in the inventory — ``repair`` pins such jobs to their base
            allocation verbatim, so dropping the slot would silently
            truncate an allocation the policy promises not to touch
            (shrinking and restarting a non-preemptible job) — but is
            blocked for every other job until its un-quarantine probe.

        Above ``partition_slices`` slices the cycle runs PARTITIONED:
        jobs grouped with the slices they occupy into sub-problems of
        bounded size, each searched independently (the Pollux paper's
        scalability strategy) — the thousand-job control plane's full
        fallback stays tractable at 10k slots.

        Returns:
          (allocations, desired_nodes)
        """
        if (
            len(nodes) > self._partition_slices
            and len(jobs) > 1
        ):
            allocations, desired = self._optimize_partitioned(
                jobs, nodes, base_allocations, node_template,
                quarantined=quarantined,
            )
        else:
            allocations, desired = self._optimize_single(
                jobs, nodes, base_allocations, node_template,
                quarantined=quarantined,
            )
        self._last_full_desired = desired
        explain = self._last_single_explain or _empty_explain(desired)
        self.last_explain = dict(explain)
        if self.last_explain.get("kind") == "single":
            self.last_explain["kind"] = "full"
        return allocations, desired

    def _optimize_partitioned(
        self,
        jobs,
        nodes,
        base_allocations,
        node_template,
        quarantined=(),
    ):
        """Partition the (jobs, slices) problem into independent
        sub-problems of at most ``partition_slices`` slices: each job
        with an allocation lands in the partition that holds its
        slices (slices of one job are kept together); free slices and
        queued jobs are dealt round-robin. Deterministic for fixed
        inputs."""
        cap = self._partition_slices
        parts: list[dict] = []  # {"nodes": [keys], "jobs": [keys]}
        node_part: dict[str, int] = {}

        def new_part() -> int:
            parts.append({"nodes": [], "jobs": []})
            return len(parts) - 1

        def smallest_open_part(need: int) -> int:
            best = None
            for i, part in enumerate(parts):
                if len(part["nodes"]) + need <= cap and (
                    best is None
                    or len(part["nodes"]) < len(parts[best]["nodes"])
                ):
                    best = i
            return new_part() if best is None else best

        # 1. Jobs with allocations, priority order (pinned, then by
        # creation): grouped with their slices.
        def pinned(key):
            job = jobs[key]
            return not job.preemptible and bool(
                base_allocations.get(key)
            )

        allocated = sorted(
            (key for key in jobs if base_allocations.get(key)),
            key=lambda k: (
                not pinned(k),
                jobs[k].min_replicas,
                jobs[k].creation_timestamp,
                k,
            ),
        )
        for key in allocated:
            held = sorted(set(base_allocations[key]) & set(nodes))
            homes = {node_part[s] for s in held if s in node_part}
            if homes:
                # A slice shared with an earlier job pins this job to
                # that partition; its remaining slices follow (the
                # partition may overflow cap slightly — correctness
                # beats balance).
                idx = min(homes)
            else:
                idx = smallest_open_part(len(held))
            parts[idx]["jobs"].append(key)
            for slot in held:
                if slot not in node_part:
                    node_part[slot] = idx
                    parts[idx]["nodes"].append(slot)
        # 2. Free slices round-robin into partitions with headroom.
        free = [s for s in sorted(nodes) if s not in node_part]
        if not parts:
            new_part()
        free_count = [0] * len(parts)
        cursor = 0
        for slot in free:
            for _ in range(len(parts) + 1):
                idx = cursor % len(parts)
                cursor += 1
                if len(parts[idx]["nodes"]) < cap:
                    break
            else:
                idx = new_part()
                free_count.append(0)
            node_part[slot] = idx
            parts[idx]["nodes"].append(slot)
            free_count[idx] += 1
        # 3. Queued jobs go where the FREE capacity went (greedy by
        # remaining free-slice quota, arrival order, lowest-index
        # tie-break): a blind index round-robin could deterministically
        # deal a queued job into a partition saturated by pinned
        # incumbents every cycle while free slices sat elsewhere.
        queued = sorted(
            (key for key in jobs if not base_allocations.get(key)),
            key=lambda k: (jobs[k].creation_timestamp, k),
        )
        quota = list(free_count)
        for key in queued:
            idx = max(
                range(len(parts)), key=lambda i: (quota[i], -i)
            )
            parts[idx]["jobs"].append(key)
            quota[idx] -= 1

        allocations: dict = {}
        desired_total = 0
        sub_explains: list[dict] = []
        for part in parts:
            part_jobs = OrderedDict(
                (key, jobs[key]) for key in part["jobs"]
            )
            part_nodes = {key: nodes[key] for key in part["nodes"]}
            part_base = {
                key: [
                    s
                    for s in base_allocations.get(key, [])
                    if s in part_nodes
                ]
                for key in part["jobs"]
            }
            if not part_jobs:
                desired_total += len(part_nodes)
                continue
            sub_alloc, sub_desired = self._optimize_single(
                part_jobs,
                part_nodes,
                part_base,
                node_template,
                quarantined=set(quarantined) & set(part_nodes),
                warm=False,
            )
            if self._last_single_explain is not None:
                sub_explains.append(self._last_single_explain)
            allocations.update(sub_alloc)
            desired_total += sub_desired
        # Per-partition GA populations are not comparable across
        # cycles; drop the warm-start state rather than seed a later
        # small cycle from one partition's population.
        self._prev_population = None
        self._prev_jobs = []
        self._prev_nodes = []
        for key in jobs:
            allocations.setdefault(key, [])
        self._last_single_explain = _merge_explains(
            sub_explains, allocations, desired_total
        )
        return allocations, desired_total

    def optimize_incremental(
        self,
        jobs,
        nodes,
        base_allocations,
        node_template,
        dirty,
        quarantined=(),
        resources=None,
    ):
        """Re-optimize only the DIRTY jobs against a pinned background.

        Args:
          jobs: {job_key: JobInfo} for the dirty jobs ONLY (the caller
            skips building speedup models for the pinned background).
          nodes: the full slice inventory.
          base_allocations: current allocations of EVERY active job —
            non-dirty jobs keep theirs verbatim; their capacity is
            subtracted from the inventory the dirty jobs search.
          dirty: job keys to re-optimize (subset of ``jobs``).
          resources: {job_key: per-replica resources} for background
            jobs (defaults to {"tpu": 1}).

        Returns (allocations covering every key in base_allocations
        and ``jobs``, desired_nodes — the last full cycle's target;
        autoscaling decisions ride full cycles).

        With no dirty jobs this is a pure pass-through: the committed
        allocations are returned unchanged and NO search runs.
        """
        desired = (
            self._last_full_desired
            if self._last_full_desired is not None
            else len(nodes)
        )
        allocations = {
            key: list(alloc)
            for key, alloc in base_allocations.items()
        }
        dirty = [k for k in jobs if k in set(dirty)]
        if not dirty:
            # Pure pass-through: provenance records every job pinned.
            self.last_explain = _empty_explain(desired)
            self.last_explain["kind"] = "incremental"
            self.last_explain["jobs"] = _pinned_jobs(base_allocations)
            return allocations, desired
        resources = resources or {}
        background = {
            key: alloc
            for key, alloc in base_allocations.items()
            if key not in set(dirty) and alloc
        }
        # Capacity net of the pinned background, and the slices whose
        # ICI a distributed background job owns (a distributed dirty
        # job may not co-claim them; repair enforces it via ici_owned).
        used: dict[str, dict[str, int]] = {}
        ici_owned: set[str] = set()
        for key, alloc in background.items():
            res = resources.get(key) or {"tpu": 1}
            distributed = len(alloc) > 1
            for slot in alloc:
                slot_used = used.setdefault(slot, {})
                for rtype, amount in res.items():
                    slot_used[rtype] = (
                        slot_used.get(rtype, 0) + int(amount)
                    )
                if distributed:
                    ici_owned.add(slot)
        # Quarantined slots are NOT pre-filtered here: _optimize_single
        # owns that policy (drop unless a pinned non-preemptible
        # incumbent still runs there, else block via the repair mask)
        # and must see them to apply it — pre-dropping would strip a
        # pinned dirty job of the slot the full path promises it keeps.
        sub_nodes = {}
        for key, node in nodes.items():
            if key in used:
                remaining = {
                    rtype: max(
                        int(total) - used[key].get(rtype, 0), 0
                    )
                    for rtype, total in node.resources.items()
                }
                node = dataclasses.replace(node, resources=remaining)
            sub_nodes[key] = node
        # Candidate inventory: the dirty jobs' own slices plus the
        # best free slices in preference order, capped — re-searching
        # a handful of jobs must not scan a 10k-slot inventory.
        budget = max(
            self._incremental_candidates, 4 * max(len(dirty), 1)
        )
        if len(sub_nodes) > budget:
            keep = set()
            for key in dirty:
                keep.update(
                    s
                    for s in base_allocations.get(key, [])
                    if s in sub_nodes
                )
            # Fill with the emptiest slices first (capacity here is
            # already net of the pinned background): a dirty job must
            # be able to GROW into free capacity, not just shuffle
            # around whatever happens to sort first by name.
            by_free = sorted(
                sub_nodes.items(),
                key=lambda kv: (
                    kv[1].preemptible,
                    getattr(kv[1], "hazard", 0.0),
                    -max(kv[1].resources.values(), default=0),
                    kv[0],
                ),
            )
            for slot, node in by_free:
                if len(keep) >= budget:
                    break
                keep.add(slot)
            sub_nodes = {
                slot: node
                for slot, node in sub_nodes.items()
                if slot in keep
            }
        sub_jobs = OrderedDict((key, jobs[key]) for key in dirty)
        sub_base = {
            key: [
                s
                for s in base_allocations.get(key, [])
                if s in sub_nodes
            ]
            for key in dirty
        }
        sub_alloc, _ = self._optimize_single(
            sub_jobs,
            sub_nodes,
            sub_base,
            node_template,
            quarantined=set(quarantined) & set(sub_nodes),
            ici_owned=ici_owned,
            warm=False,
        )
        for key in dirty:
            allocations[key] = sub_alloc.get(key, [])
        # Provenance: the dirty sub-problem's explain plus pinned
        # entries for the untouched background.
        sub_ex = self._last_single_explain or _empty_explain(desired)
        explain = dict(sub_ex, kind="incremental")
        explain["desiredNodes"] = desired
        jobs_ex = _pinned_jobs(background)
        jobs_ex.update(sub_ex.get("jobs") or {})
        explain["jobs"] = jobs_ex
        self.last_explain = explain
        return allocations, desired

    def _optimize_single(
        self,
        jobs,
        nodes,
        base_allocations,
        node_template,
        quarantined=(),
        ici_owned=(),
        warm=True,
    ):
        """The direct NSGA-II cycle over one (jobs, nodes) problem.
        ``ici_owned`` slices host a distributed job OUTSIDE this
        problem (incremental background): repair blocks distributed
        placements there. ``warm=False`` (partition/incremental
        sub-problems) neither reads nor stores the cross-cycle
        warm-start population."""
        blocked_slots: set = set()
        if quarantined:
            protected = {
                slot
                for key, job in jobs.items()
                if not job.preemptible
                for slot in base_allocations.get(key, [])
            }
            nodes = {
                key: node
                for key, node in nodes.items()
                if key not in quarantined or key in protected
            }
            blocked_slots = set(quarantined) & protected
        if not jobs or not nodes:
            self._last_single_explain = _empty_explain(len(nodes))
            return {}, len(nodes)

        def pinned(key, job):
            return not job.preemptible and bool(base_allocations.get(key))

        jobs = OrderedDict(
            sorted(
                jobs.items(),
                key=lambda kv: (
                    not pinned(*kv),
                    kv[1].min_replicas,
                    kv[1].creation_timestamp,
                ),
            )
        )
        nodes = _sorted_nodes(nodes)
        job_list = list(jobs.values())
        # Real slices followed by equally many virtual (requestable).
        node_list = list(nodes.values()) + [node_template] * len(nodes)

        base_state = np.zeros((len(jobs), len(node_list)), dtype=int)
        node_index = {key: i for i, key in enumerate(nodes)}
        for j, key in enumerate(jobs):
            for node_key in base_allocations.get(key, []):
                if node_key in node_index:
                    base_state[j, node_index[node_key]] += 1

        blocked = np.zeros((len(jobs), len(node_list)), dtype=bool)
        for slot in blocked_slots:
            if slot in node_index:
                for j, (key, job) in enumerate(jobs.items()):
                    if not pinned(key, job):
                        blocked[j, node_index[slot]] = True

        owned_mask = None
        if ici_owned:
            owned_mask = np.zeros(len(node_list), dtype=bool)
            for slot in ici_owned:
                if slot in node_index:
                    owned_mask[node_index[slot]] = True

        problem = _Problem(
            job_list,
            node_list,
            base_state,
            blocked=blocked,
            ici_owned=owned_mask,
        )
        if warm:
            seeds = self._seed_population(
                jobs, nodes, base_state, node_list
            )
        else:
            seeds = np.concatenate(
                [
                    base_state.reshape(1, -1),
                    self._greedy_seeds(
                        job_list, node_list, num_real=len(nodes)
                    ),
                ],
                axis=0,
            )
        population, F, front = nsga2.minimize(
            evaluate=problem.evaluate,
            initial=seeds,
            crossover=problem.crossover,
            mutate=problem.mutate,
            repair=problem.repair,
            pop_size=self._pop_size,
            generations=self._generations,
        )
        if warm:
            self._prev_population = copy.deepcopy(population)
            self._prev_jobs = list(jobs)
            self._prev_nodes = list(nodes)

        states = population[front].reshape(
            front.size, len(jobs), len(node_list)
        )
        values = F[front]
        utilities = problem.cluster_utilities(states)
        desired_nodes = self._desired_nodes(utilities, values, len(nodes))
        pick = _select_within_budget(
            values, min(len(nodes), desired_nodes)
        )
        if pick is None:
            self._last_single_explain = _empty_explain(desired_nodes)
            self._last_single_explain["candidates"] = int(front.size)
            return {}, desired_nodes
        chosen = states[pick]
        allocations = {}
        node_keys = list(nodes)
        for j, key in enumerate(jobs):
            alloc = []
            for s, node_key in enumerate(node_keys):
                alloc.extend([node_key] * int(chosen[j, s]))
            allocations[key] = alloc
        self._last_single_explain = self._explain_single(
            problem, states, pick, list(jobs), allocations,
            desired_nodes, len(nodes),
        )
        return allocations, desired_nodes

    def _explain_single(
        self,
        problem: "_Problem",
        states,
        pick: int,
        job_keys: list,
        allocations: dict,
        desired: int,
        num_real: int,
    ) -> dict:
        """The provenance record of one NSGA-II cycle: every
        Pareto-front candidate's decomposed objective, the winner, and
        the top-k losers each labeled with the term that killed it —
        ``speedup`` (plainly worse), ``restartPenalty`` (would win
        without the move penalty), ``hazardRestartCost`` (would win
        without the hazard x restart-cost loss), or ``utilBand``
        (outside the autoscaler's node budget). Deterministic for
        fixed inputs — the search is internally seeded."""
        comps = problem.objective_components(states)
        budget = min(num_real, desired)
        eps = 1e-9
        winner = {
            "objective": round(float(comps["full"][pick]), 6),
            "speedup": round(float(comps["base"][pick]), 6),
            "nodes": int(comps["sizes"][pick]),
        }
        order = sorted(
            range(states.shape[0]),
            key=lambda i: (-float(comps["full"][i]), int(comps["sizes"][i]), i),
        )
        losers = []
        topk = env.watch_explain_topk()
        for i in order:
            if i == pick or len(losers) >= topk:
                continue
            if int(comps["sizes"][i]) > budget:
                killed = "utilBand"
            elif float(comps["base"][i]) > float(comps["base"][pick]) + eps:
                killed = (
                    "hazardRestartCost"
                    if float(comps["after_restart"][i])
                    > float(comps["after_restart"][pick]) + eps
                    else "restartPenalty"
                )
            else:
                killed = "speedup"
            loser = {
                "objective": round(float(comps["full"][i]), 6),
                "speedup": round(float(comps["base"][i]), 6),
                "nodes": int(comps["sizes"][i]),
                "killedBy": killed,
            }
            # The front routinely holds duplicate states; one line per
            # distinct losing configuration.
            if loser not in losers:
                losers.append(loser)
        terms = problem.job_terms(states[pick])
        jobs = {}
        for j, key in enumerate(job_keys):
            alloc = allocations.get(key, [])
            jobs[key] = dict(
                terms[j],
                alloc=list(alloc),
                replicas=len(alloc),
                nodes=len(set(alloc)),
            )
        return {
            "kind": "single",
            "candidates": int(states.shape[0]),
            "winner": winner,
            "losers": losers,
            "desiredNodes": int(desired),
            "jobs": jobs,
        }

    @classmethod
    def _greedy_seeds(cls, job_list, node_list, num_real=None):
        """Three greedy seeds: the full column set (virtual columns =
        propose growing the cluster), the REAL slices only (the
        feasible dense packing the GA needs when the node budget
        forbids expansion), and a hazard-aware real-only packing —
        jobs pick in descending restart-cost order with no stagger, so
        expensive-restart jobs land on the safe slices ``_sorted_
        nodes`` puts first (the expected-loss optimum the mutation
        operators rarely reach by a coordinated swap)."""
        full = cls._greedy_seed(job_list, node_list, num_real=num_real)
        real_only = cls._greedy_seed(
            job_list,
            node_list,
            num_real=num_real,
            allow_virtual=False,
        )
        costs = [
            DEFAULT_RESTART_COST_S
            if job.restart_cost_s is None
            else float(job.restart_cost_s)
            for job in job_list
        ]
        order = sorted(
            range(len(job_list)), key=lambda i: (-costs[i], i)
        )
        permuted = cls._greedy_seed(
            [job_list[i] for i in order],
            node_list,
            num_real=num_real,
            allow_virtual=False,
            stagger=False,
        ).reshape(len(job_list), -1)
        hazard_aware = np.zeros_like(permuted)
        for pos, i in enumerate(order):
            hazard_aware[i] = permuted[pos]
        return np.concatenate(
            [full, real_only, hazard_aware.reshape(1, -1)], axis=0
        )

    @staticmethod
    def _greedy_seed(
        job_list,
        node_list,
        num_real=None,
        allow_virtual=True,
        stagger=True,
    ):
        """Fair round-robin seed: every job first gets its
        max(min_replicas, 1), then jobs grow one replica at a time up
        to their max while capacity lasts, honoring the
        one-multi-replica-job-per-slice ICI rule. Gives the GA a
        dense, fair, feasible starting point — from an all-zeros cold
        start, small populations can fail to discover even obvious
        packings (and a job-ordered greedy seed starves late jobs).

        Placement is STAGGERED: job j starts its scan at slice
        ``j % num_real`` instead of slice 0, so min-replicas spread
        across the cluster. Packing them all onto the lowest-index
        slices froze growth — the first co-tenant to go distributed
        claimed the shared slice's ICI, and every other job stranded
        there could never add a second replica. A job whose existing
        replicas ARE stranded on a foreign-owned slice relocates
        wholesale to an unowned slice with room."""
        num_columns = len(node_list)
        num_jobs = len(job_list)
        if num_real is None:
            num_real = num_columns
        num_real = max(min(num_real, num_columns), 1)
        state = np.zeros((num_jobs, num_columns), dtype=int)
        free = [dict(n.resources) for n in node_list]
        owner: list[int | None] = [None] * num_columns  # multi-job claim

        def capacity(j, s):
            if not allow_virtual and s >= num_real:
                return 0
            caps = [
                free[s].get(r, 0) // amount
                for r, amount in job_list[j].resources.items()
                if amount > 0
            ]
            return min(caps) if caps else 0

        def order_for(j):
            offset = (j % num_real) if stagger else 0
            def key(s):
                if s < num_real:
                    rotated = (s - offset) % num_real
                else:
                    # Virtual (requestable) columns always come after
                    # every real slice, in order.
                    rotated = num_real + (s - num_real)
                return (state[j, s] == 0, rotated)
            return sorted(range(num_columns), key=key)

        def take(j, s):
            state[j, s] += 1
            for r, amount in job_list[j].resources.items():
                free[s][r] = free[s].get(r, 0) - amount

        def relocate(j, s, want):
            for t in range(num_columns):
                if state[j, t]:
                    for r, amount in job_list[j].resources.items():
                        free[t][r] = (
                            free[t].get(r, 0) + amount * state[j, t]
                        )
                    if owner[t] == j:
                        owner[t] = None
                    state[j, t] = 0
            owner[s] = j
            for _ in range(want):
                take(j, s)

        def add_one(j):
            becoming_multi = state[j].sum() + 1 > 1
            order = order_for(j)
            for s in order:
                if capacity(j, s) <= 0:
                    continue
                if becoming_multi and owner[s] not in (None, j):
                    continue
                if becoming_multi:
                    # Claim every slice the now-multi job occupies.
                    for t in range(num_columns):
                        if state[j, t] or t == s:
                            if owner[t] not in (None, j):
                                break
                    else:
                        for t in range(num_columns):
                            if state[j, t] or t == s:
                                owner[t] = j
                        take(j, s)
                        return True
                    continue
                take(j, s)
                return True
            if becoming_multi:
                # Stranded: an existing replica sits on a slice some
                # other job owns. Move the whole job to an unowned
                # slice with room for one more replica.
                want = int(state[j].sum()) + 1
                for s in order:
                    if owner[s] is not None or state[j, s]:
                        continue
                    if capacity(j, s) >= want:
                        relocate(j, s, want)
                        return True
            return False

        targets = [max(job.min_replicas, 1) for job in job_list]
        maxes = [max(job.max_replicas, 1) for job in job_list]
        for phase_targets in (targets, maxes):
            progress = True
            while progress:
                progress = False
                for j in range(num_jobs):
                    if state[j].sum() < phase_targets[j] and add_one(j):
                        progress = True
        return state.reshape(1, -1)

    def _seed_population(self, jobs, nodes, base_state, node_list):
        """Warm start from the previous population, remapped across job
        and node churn (reference: pollux.py:94-119), plus a greedy
        first-fit seed."""
        greedy = self._greedy_seeds(
            list(jobs.values()), node_list, num_real=len(nodes)
        )
        flat_base = np.concatenate(
            [base_state.reshape(1, -1), greedy], axis=0
        )
        if self._prev_population is None:
            return flat_base
        prev = self._prev_population.reshape(
            self._prev_population.shape[0],
            len(self._prev_jobs),
            -1,
        )
        num_nodes = base_state.shape[1]
        states = np.zeros(
            (prev.shape[0], len(jobs), num_nodes), dtype=int
        )
        prev_job_idx = {k: i for i, k in enumerate(self._prev_jobs)}
        prev_node_idx = {k: i for i, k in enumerate(self._prev_nodes)}
        job_pairs = [
            (j, prev_job_idx[key])
            for j, key in enumerate(jobs)
            if key in prev_job_idx
        ]
        if job_pairs:
            dst_j, src_j = map(list, zip(*job_pairs))
            # Physical slices by name; new/virtual ones consume the
            # previous run's virtual columns in order.
            spare = len(self._prev_nodes)
            for s, key in enumerate(nodes):
                if key in prev_node_idx:
                    src_col = prev_node_idx[key]
                elif spare < prev.shape[2]:
                    src_col = spare
                    spare += 1
                else:
                    continue
                states[:, dst_j, s] = prev[:, src_j, src_col]
            for s in range(len(nodes), num_nodes):
                if spare >= prev.shape[2]:
                    break
                states[:, dst_j, s] = prev[:, src_j, spare]
                spare += 1
        return np.concatenate(
            [flat_base, states.reshape(states.shape[0], -1)], axis=0
        )

    def _desired_nodes(self, utilities, values, num_nodes):
        pick = _select_within_budget(values, num_nodes)
        if pick is not None and (
            self._min_util <= utilities[pick] <= self._max_util
        ):
            return num_nodes
        target = (self._min_util + self._max_util) / 2
        best_util, best_nodes = np.inf, num_nodes
        for util, (_, active) in zip(utilities, values):
            if util < self._min_util:
                continue
            if np.isclose(util, best_util) and active > best_nodes:
                best_nodes = active
            if abs(util - target) < abs(best_util - target):
                best_util, best_nodes = util, active
        return int(best_nodes)


def _empty_explain(desired: int) -> dict:
    return {
        "kind": "single",
        "candidates": 0,
        "winner": None,
        "losers": [],
        "desiredNodes": int(desired),
        "jobs": {},
    }


def _pinned_jobs(base_allocations: dict) -> dict:
    """Explain entries for jobs a cycle deliberately did not touch
    (the incremental path's background): allocation kept, no terms."""
    return {
        key: {
            "alloc": list(alloc),
            "replicas": len(alloc),
            "nodes": len(set(alloc)),
            "pinned": True,
        }
        for key, alloc in sorted(base_allocations.items())
    }


def _merge_explains(
    sub_explains: list[dict], allocations: dict, desired: int
) -> dict:
    """Fold per-partition explains into one cycle record: candidates
    sum, winners sum (the partitions are independent sub-problems of
    one additive objective), losers re-ranked across partitions and
    re-truncated to top-k."""
    merged = _empty_explain(desired)
    merged["kind"] = "partitioned"
    win_obj, win_speedup, win_nodes, have_winner = 0.0, 0.0, 0, False
    losers: list[dict] = []
    for ex in sub_explains:
        merged["candidates"] += int(ex.get("candidates", 0))
        merged["jobs"].update(ex.get("jobs") or {})
        losers.extend(ex.get("losers") or [])
        winner = ex.get("winner")
        if winner:
            have_winner = True
            win_obj += winner["objective"]
            win_speedup += winner["speedup"]
            win_nodes += winner["nodes"]
    if have_winner:
        merged["winner"] = {
            "objective": round(win_obj, 6),
            "speedup": round(win_speedup, 6),
            "nodes": win_nodes,
        }
    losers.sort(key=lambda lo: (-lo["objective"], lo["nodes"]))
    merged["losers"] = losers[: env.watch_explain_topk()]
    for key, alloc in allocations.items():
        merged["jobs"].setdefault(
            key,
            {
                "alloc": list(alloc),
                "replicas": len(alloc),
                "nodes": len(set(alloc)),
            },
        )
    return merged


def _sorted_nodes(nodes: dict) -> OrderedDict:
    """Stable preference order: reliable slices first, then by
    measured hazard within each reliability class."""
    return OrderedDict(
        sorted(
            nodes.items(),
            key=lambda kv: (
                kv[1].preemptible,
                getattr(kv[1], "hazard", 0.0),
                kv[0],
            ),
        )
    )


def _select_within_budget(values, max_nodes):
    """Best total speedup among solutions within the node budget."""
    feasible = values[:, 1] <= max_nodes
    if not feasible.any():
        return None
    # Infeasible solutions must never win the argmin, even when every
    # feasible score is exactly 0 (negated speedups are <= 0).
    score = np.where(feasible, values[:, 0], np.inf)
    return int(np.argmin(score))


class _Problem:
    """Objectives + variation operators over allocation matrices."""

    def __init__(
        self, jobs, nodes, base_state, blocked=None, ici_owned=None
    ):
        self.jobs = jobs
        self.nodes = nodes
        self.base_state = base_state
        self.shape = base_state.shape
        # (jobs, nodes) placements repair must zero: quarantined slots
        # kept in the inventory only for a pinned incumbent's sake.
        self._blocked = blocked
        # Node columns whose ICI a distributed job OUTSIDE this
        # problem owns (the incremental path's pinned background):
        # distributed jobs in this problem may not claim them.
        self._ici_owned = ici_owned
        num_jobs, num_nodes = self.shape
        self._pinned = np.array(
            [
                not job.preemptible and base_state[j].any()
                for j, job in enumerate(jobs)
            ]
        )
        rtypes = sorted({r for job in jobs for r in job.resources})
        self._job_res = np.array(
            [[job.resources.get(r, 0) for r in rtypes] for job in jobs],
            dtype=np.int64,
        )
        self._node_res = np.array(
            [[n.resources.get(r, 0) for r in rtypes] for n in nodes],
            dtype=np.int64,
        )
        # Dominant share: fraction of the whole cluster one replica
        # occupies on its scarcest resource type.
        with np.errstate(divide="ignore", invalid="ignore"):
            share = self._job_res / self._node_res.sum(axis=0)
        self._dominant_share = np.nan_to_num(share).max(axis=1)
        # Per (job, node) replica capacity, net of pinned jobs' usage.
        used = (
            base_state[self._pinned, :, None]
            * self._job_res[self._pinned][:, None, :]
        ).sum(axis=0)
        avail = np.maximum(self._node_res - used, 0)
        caps = []
        for j in range(num_jobs):
            req = self._job_res[j]
            with np.errstate(divide="ignore", invalid="ignore"):
                per = np.where(req > 0, avail // np.maximum(req, 1), 10**9)
            caps.append(per.min(axis=1))
        self._cap = np.stack(caps)  # (jobs, nodes)
        self._min_replicas = np.array([j.min_replicas for j in jobs])
        self._max_replicas = np.array([j.max_replicas for j in jobs])
        # Per-job restart pricing: measured (from posted checkpoint/
        # restore timings) when the job reports it, the assumed
        # default otherwise.
        self._restart_penalty = np.array(
            [
                RESTART_PENALTY
                if job.restart_penalty is None
                else float(job.restart_penalty)
                for job in jobs
            ]
        )
        # Hazard-pricing inputs: per-node reclaim rate (EWMA of
        # observed notices, stamped by the allocator) and per-job
        # measured restart cost in seconds.
        self._node_hazard = np.array(
            [max(getattr(n, "hazard", 0.0), 0.0) for n in nodes]
        )
        self._restart_cost_s = np.array(
            [
                DEFAULT_RESTART_COST_S
                if job.restart_cost_s is None
                else max(float(job.restart_cost_s), 0.0)
                for job in jobs
            ]
        )

    # -- objectives ----------------------------------------------------

    def _speedups(self, states):
        active_nodes = np.count_nonzero(states, axis=2)
        replicas = states.sum(axis=2)
        columns = [
            job.speedup_fn(active_nodes[:, j], replicas[:, j])
            for j, job in enumerate(self.jobs)
        ]
        return np.stack(columns, axis=1).astype(float)

    def _cluster_sizes(self, states):
        order = np.arange(1, self.shape[1] + 1)
        return np.max(
            np.where(states.any(axis=1), order, 0), axis=1
        )

    def evaluate(self, flat_pop):
        states = flat_pop.reshape(-1, *self.shape)
        speedups = self._speedups(states)
        scaled = speedups * self._dominant_share * len(self.nodes)
        moved = (states != self.base_state).any(axis=2)
        scaled = np.where(
            moved, scaled * (1 - self._restart_penalty[None, :]), scaled
        )
        # Hazard expected-loss term: a job restarts when ANY of its
        # slices is reclaimed, so its reclaim rate is the sum of its
        # occupied slices' hazards; each reclaim costs ~restart_cost_s
        # of goodput. The product (rate x cost) is the expected
        # fraction of time lost to preemption restarts — expensive-
        # restart jobs are priced off spot, cheap ones soak it up.
        if self._node_hazard.any():
            lam = (states > 0).astype(float) @ self._node_hazard
            loss = np.clip(
                lam * self._restart_cost_s[None, :],
                0.0,
                MAX_HAZARD_LOSS,
            )
            scaled = scaled * (1.0 - loss)
        return np.column_stack(
            [-scaled.sum(axis=1), self._cluster_sizes(states)]
        )

    def objective_components(self, states):
        """Per-candidate decomposition of the scored objective, for
        decision provenance: ``base`` (scaled speedup sum, no
        penalties), ``after_restart`` (move penalty applied),
        ``full`` (hazard expected-loss applied — what evaluate()
        actually ranks by), and the active cluster ``sizes``. The
        explain path attributes each loser to the term that flipped
        its ranking against the winner."""
        speedups = self._speedups(states)
        scaled = speedups * self._dominant_share * len(self.nodes)
        base = scaled.sum(axis=1)
        moved = (states != self.base_state).any(axis=2)
        after_restart_per_job = np.where(
            moved, scaled * (1 - self._restart_penalty[None, :]), scaled
        )
        after_restart = after_restart_per_job.sum(axis=1)
        if self._node_hazard.any():
            lam = (states > 0).astype(float) @ self._node_hazard
            loss = np.clip(
                lam * self._restart_cost_s[None, :],
                0.0,
                MAX_HAZARD_LOSS,
            )
            full = (after_restart_per_job * (1.0 - loss)).sum(axis=1)
        else:
            full = after_restart
        return {
            "base": base,
            "after_restart": after_restart,
            "full": full,
            "sizes": self._cluster_sizes(states),
        }

    def job_terms(self, state):
        """Per-job objective terms of ONE candidate state — the
        numbers ``adaptdl-tpu explain`` renders: raw and scaled
        speedup, whether the job moved (and the restart penalty it
        paid), and the hazard expected-loss fraction charged."""
        states = state.reshape(1, *self.shape)
        speedups = self._speedups(states)[0]
        scaled = speedups * self._dominant_share * len(self.nodes)
        moved = (states[0] != self.base_state).any(axis=1)
        if self._node_hazard.any():
            lam = (states[0] > 0).astype(float) @ self._node_hazard
            loss = np.clip(lam * self._restart_cost_s, 0.0, MAX_HAZARD_LOSS)
        else:
            loss = np.zeros(self.shape[0])
        terms = []
        for j in range(self.shape[0]):
            terms.append(
                {
                    "speedup": round(float(speedups[j]), 6),
                    "scaledSpeedup": round(float(scaled[j]), 6),
                    "moved": bool(moved[j]),
                    "restartPenalty": round(
                        float(self._restart_penalty[j])
                        if moved[j]
                        else 0.0,
                        6,
                    ),
                    "hazardLoss": round(float(loss[j]), 6),
                }
            )
        return terms

    def cluster_utilities(self, states):
        """Mean speedup-per-replica weighted by resource share, per
        state (reference: pollux.py:302-335)."""
        replicas = states.sum(axis=2)
        speedups = self._speedups(states)
        active = states.sum(axis=1) > 0  # (pop, nodes)
        total = (active[:, :, None] * self._node_res).sum(axis=1)
        alloc = replicas[:, :, None] * self._job_res
        with np.errstate(divide="ignore", invalid="ignore"):
            shares = np.where(alloc > 0, alloc / total[:, None, :], 0.0)
            per_job = np.where(replicas > 0, speedups / replicas, 0.0)
        util = (per_job[:, :, None] * shares).sum(axis=1)
        return util.max(axis=1)

    # -- variation ------------------------------------------------------

    def crossover(self, parents_a, parents_b, rng):
        a = parents_a.reshape(-1, *self.shape)
        b = parents_b.reshape(-1, *self.shape)
        n = a.shape[0]
        # Exchange whole jobs at a random split point...
        point = rng.integers(self.shape[0] + 1, size=(n, 1, 1))
        take_a = np.arange(self.shape[0])[None, :, None] < point
        child = np.where(take_a, a, b)
        # ...and draw the child's cluster budget between the parents'.
        size_a = self._cluster_sizes(a)
        size_b = self._cluster_sizes(b)
        lo = np.minimum(size_a, size_b)
        hi = np.maximum(size_a, size_b)
        budget = lo + (rng.integers(1 << 30, size=n) % (hi - lo + 1))
        beyond = np.arange(self.shape[1])[None, None, :] >= budget[:, None, None]
        child = np.where(beyond, 0, child)
        return child.reshape(n, -1)

    def mutate(self, flat_pop, rng):
        states = flat_pop.reshape(-1, *self.shape).copy()
        nonzero = np.count_nonzero(states, axis=2, keepdims=True)
        zero = self.shape[1] - nonzero
        # Equalize mutation pressure between occupied and empty cells.
        prob = np.where(
            states > 0,
            1.0 / np.maximum(nonzero, 1),
            1.0 / np.maximum(zero, 1),
        )
        hit = rng.random(states.shape) < prob
        draw = rng.integers(0, self._cap[None] + 1, size=states.shape)
        states[hit] = draw[hit]
        return states.reshape(states.shape[0], -1)

    def repair(self, flat_pop, rng=None):
        """Project arbitrary matrices onto the feasible set."""
        if rng is None:
            rng = np.random.default_rng(0)
        states = flat_pop.reshape(-1, *self.shape).copy()
        pop = states.shape[0]
        # Pinned jobs keep their base allocation verbatim.
        states[:, self._pinned] = self.base_state[self._pinned]
        if self._blocked is not None and self._blocked.any():
            states[:, self._blocked] = 0
        if self._ici_owned is not None and self._ici_owned.any():
            # Slices ICI-owned by a distributed background job: a
            # distributed job HERE may not co-claim them (the global
            # one-distributed-job-per-slice rule, enforced across the
            # incremental problem boundary).
            distributed = (states.sum(axis=2) > 1)[:, :, None]
            owned = self._ici_owned[None, None, :]
            states = np.where(distributed & owned, 0, states)
        # A distributed job owns its slices' ICI: on every slice, keep
        # only the first distributed job (in the sorted priority
        # order), clearing later claimants. "Distributed" = more than
        # one replica anywhere — even a single-slice 2-replica job
        # psums over its slice's ICI, so it may not share the slice
        # with another multi-replica job.
        distributed = (states.sum(axis=2) > 1)[:, :, None]
        claims = (states > 0) & distributed
        later_claim = claims.cumsum(axis=1) > 1
        states[later_claim & claims] = 0
        # Per-job replica ceiling: greedily keep replicas in a random
        # node order so no single column is systematically favored —
        # drawn from the GA's rng so the shuffle actually varies
        # across repairs rather than repeating one fixed permutation.
        shuffled = np.argsort(rng.random(states.shape), axis=2)
        inverse = np.argsort(shuffled, axis=2)
        shuffled_states = np.take_along_axis(states, shuffled, axis=2)
        running = shuffled_states.cumsum(axis=2)
        allowed = np.minimum(running, self._max_replicas[None, :, None])
        shuffled_states = np.diff(
            allowed, axis=2, prepend=np.zeros((pop, self.shape[0], 1), int)
        )
        states = np.take_along_axis(shuffled_states, inverse, axis=2)
        # Per-slice capacity (net of pinned usage), job-priority order.
        per_cap = np.minimum(states, self._cap[None])
        # Resource units cap allocations across *different* jobs.
        res_usage = (
            per_cap[:, :, :, None] * self._job_res[None, :, None, :]
        ).cumsum(axis=1)
        over = res_usage > self._node_avail()[None, None]
        # Scale back any job pushing a slice over capacity: zero its
        # allocation on that slice (coarse but safe; the GA refines).
        violating = over.any(axis=3)
        states = np.where(violating, 0, per_cap)
        # Jobs that end up below min_replicas get nothing at all.
        under = states.sum(axis=2) < self._min_replicas[None, :]
        states = np.where(under[:, :, None], 0, states)
        # Pinned jobs are exempt from the above zeroing.
        states[:, self._pinned] = self.base_state[self._pinned]
        return states.reshape(pop, -1)

    def _node_avail(self):
        used = (
            self.base_state[self._pinned, :, None]
            * self._job_res[self._pinned][:, None, :]
        ).sum(axis=0)
        return np.maximum(self._node_res - used, 0)
