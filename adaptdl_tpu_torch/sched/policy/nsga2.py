"""Minimal NSGA-II engine in pure numpy, the port's copy of
``adaptdl_tpu.sched.policy.nsga2``: the same numpy calls in the same
order, so one seed gives the same population.

The reference delegates its multi-objective search to pymoo
(reference: sched/adaptdl_sched/policy/pollux.py:193-201); this build
carries its own ~100-line implementation instead of a dependency:
fast non-dominated sorting, crowding distance, binary tournament
selection, and a (mu+lambda) elitist generational loop with pluggable
variation operators.

All objectives are minimized. Population entries are integer vectors;
the problem supplies evaluate/crossover/mutate/repair as plain
functions over stacked arrays.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def nondominated_fronts(F: np.ndarray) -> list[np.ndarray]:
    """Indices grouped into Pareto fronts, best first. F: (n, n_obj)."""
    n = F.shape[0]
    # dominates[i, j]: i is no worse everywhere and better somewhere.
    le = (F[:, None, :] <= F[None, :, :]).all(axis=2)
    lt = (F[:, None, :] < F[None, :, :]).any(axis=2)
    dominates = le & lt
    dom_count = dominates.sum(axis=0)  # how many dominate each point
    fronts = []
    remaining = np.arange(n)
    while remaining.size:
        front = remaining[dom_count[remaining] == 0]
        if front.size == 0:  # duplicates dominating each other: break ties
            front = remaining[:1]
        fronts.append(front)
        for i in front:
            dom_count -= dominates[i].astype(int)
            dom_count[i] = np.iinfo(int).max  # remove from consideration
        remaining = np.setdiff1d(remaining, front, assume_unique=True)
    return fronts


def crowding_distance(F: np.ndarray, front: np.ndarray) -> np.ndarray:
    """Crowding distance of each point within one front."""
    distances = np.zeros(front.size)
    for obj in range(F.shape[1]):
        order = front[np.argsort(F[front, obj], kind="stable")]
        fmin, fmax = F[order[0], obj], F[order[-1], obj]
        pos = {idx: i for i, idx in enumerate(order)}
        span = fmax - fmin
        for i, idx in enumerate(front):
            rank = pos[idx]
            if rank == 0 or rank == front.size - 1:
                distances[i] = np.inf
            elif span > 0:
                distances[i] += (
                    F[order[rank + 1], obj] - F[order[rank - 1], obj]
                ) / span
    return distances


def _rank_and_crowding(F: np.ndarray):
    rank = np.empty(F.shape[0], dtype=int)
    crowd = np.empty(F.shape[0], dtype=float)
    for level, front in enumerate(nondominated_fronts(F)):
        rank[front] = level
        crowd[front] = crowding_distance(F, front)
    return rank, crowd


def _survivors(F: np.ndarray, pop_size: int) -> np.ndarray:
    """Elitist truncation: whole fronts, then by crowding distance."""
    chosen: list[int] = []
    for front in nondominated_fronts(F):
        if len(chosen) + front.size <= pop_size:
            chosen.extend(front.tolist())
        else:
            crowd = crowding_distance(F, front)
            order = front[np.argsort(-crowd, kind="stable")]
            chosen.extend(order[: pop_size - len(chosen)].tolist())
            break
    return np.asarray(chosen)


def minimize(
    evaluate: Callable[[np.ndarray], np.ndarray],
    initial: np.ndarray,
    crossover: Callable[[np.ndarray, np.ndarray, np.random.Generator], np.ndarray],
    mutate: Callable[[np.ndarray, np.random.Generator], np.ndarray],
    repair: Callable[[np.ndarray, np.random.Generator], np.ndarray],
    pop_size: int = 100,
    generations: int = 100,
    seed: int = 0,
):
    """Run NSGA-II; returns (population, objectives) of the final
    non-dominated-sorted population.

    - evaluate(pop) -> (n, n_obj) objectives to minimize
    - crossover(parents_a, parents_b, rng) -> children
    - mutate(pop, rng) -> pop
    - repair(pop, rng) -> pop (feasibility projection; rng so any
      tie-breaking randomness differs per generation)
    """
    rng = np.random.default_rng(seed)
    pop = repair(np.asarray(initial), rng)
    if pop.shape[0] < pop_size:
        # Fill by mutating copies of the seeds — but keep EVERY given
        # seed intact: the callers' seeds are high-value states (the
        # incumbent allocation, greedy dense packings), and mutating
        # all but the first threw the good ones away before the
        # search even started.
        reps = -(-pop_size // pop.shape[0])
        fill = np.concatenate([pop] * reps, axis=0)[
            pop.shape[0]:pop_size
        ]
        if fill.shape[0]:
            fill = repair(mutate(fill, rng), rng)
            pop = np.concatenate([pop, fill], axis=0)
    F = evaluate(pop)

    for _ in range(generations):
        rank, crowd = _rank_and_crowding(F)

        def tournament(k):
            a = rng.integers(pop.shape[0], size=k)
            b = rng.integers(pop.shape[0], size=k)
            better_a = (rank[a] < rank[b]) | (
                (rank[a] == rank[b]) & (crowd[a] > crowd[b])
            )
            return np.where(better_a, a, b)

        parents_a = pop[tournament(pop_size)]
        parents_b = pop[tournament(pop_size)]
        children = crossover(parents_a, parents_b, rng)
        children = repair(mutate(children, rng), rng)
        child_F = evaluate(children)
        merged = np.concatenate([pop, children], axis=0)
        merged_F = np.concatenate([F, child_F], axis=0)
        keep = _survivors(merged_F, pop_size)
        pop, F = merged[keep], merged_F[keep]

    front = nondominated_fronts(F)[0]
    return pop, F, front
