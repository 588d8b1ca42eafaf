"""The port's Pollux policy held to the JAX package's.

The same numpy inputs (``PerfParams``, ``GradParams``, job bounds, node
inventories, base allocations) go to ``adaptdl_tpu.sched.policy`` and to
``adaptdl_tpu_torch.sched.policy``. Both searches are seeded numpy, so:

- the NSGA-II engines return equal populations, objectives and fronts;
- the speedup tables agree to rtol 1e-12 (the same numpy expression);
- every allocation and every ``desired_nodes`` is EXACTLY equal, cycle
  after cycle on one policy object each (the warm-start population makes
  cycle n depend on cycle n-1), in the dp-only scenarios of
  ``tests/test_pollux_policy.py``: first fit, all jobs allocated,
  ``max_replicas``, a distributed job owning its slice, a pinned
  non-preemptible job, the warm start, hazard pricing and its exact
  objective math, and the dp default of ``best_config``; plus an
  incremental cycle and a partitioned one.

The port's speedup function prices every mesh axis as the JAX package
does: seq, model, stage (with the pipeline M) and expert hints.
"""

import numpy as np
import pytest

from adaptdl_tpu import goodput as jax_goodput
from adaptdl_tpu.sched.policy import nsga2 as jax_nsga2
from adaptdl_tpu.sched.policy import pollux as jax_pollux
from adaptdl_tpu.sched.policy import speedup as jax_speedup
from adaptdl_tpu.sched.policy import utils as jax_utils
from adaptdl_tpu_torch import goodput as port_goodput
from adaptdl_tpu_torch.sched.policy import nsga2 as port_nsga2
from adaptdl_tpu_torch.sched.policy import pollux as port_pollux
from adaptdl_tpu_torch.sched.policy import speedup as port_speedup
from adaptdl_tpu_torch.sched.policy import utils as port_utils
from tests.torch_support import private_tempdir  # noqa: F401

PERF = (0.121, 0.00568, 0.0236, 0.00634, 0.0118, 0.00317, 1.14)
GRAD = (0.00136, 0.000502)
PACKAGES = {
    "jax": (jax_goodput, jax_speedup, jax_utils, jax_pollux),
    "port": (port_goodput, port_speedup, port_utils, port_pollux),
}


def _speedup_fn(pkg, perf=PERF, grad=GRAD, init=128, **kw):
    goodput, speedup, _, _ = PACKAGES[pkg]
    kw = {
        "max_batch_size": 1280, "atomic_bsz_range": (64, 256),
        "accumulation": True, **kw,
    }
    return speedup.SpeedupFunction(
        goodput.GoodputFunction(
            goodput.PerfParams(*perf), goodput.GradParams(*grad), init
        ),
        **kw,
    )


def _job(pkg, ts=0.0, min_replicas=0, max_replicas=8, preemptible=True,
         restart_cost_s=None, perf=PERF, grad=GRAD):
    return PACKAGES[pkg][2].JobInfo(
        resources={"tpu": 1},
        speedup_fn=_speedup_fn(pkg, perf=perf, grad=grad),
        creation_timestamp=ts,
        min_replicas=min_replicas,
        max_replicas=max_replicas,
        preemptible=preemptible,
        restart_cost_s=restart_cost_s,
    )


def _node(pkg, chips, **kw):
    return PACKAGES[pkg][2].NodeInfo(resources={"tpu": chips}, **kw)


def _nodes(pkg, n=2, chips=4):
    return {f"slice-{i}": _node(pkg, chips) for i in range(n)}


def _policy(pkg, **kw):
    return PACKAGES[pkg][3].PolluxPolicy(pop_size=24, generations=20, **kw)


def _both(run):
    """``run(pkg)`` for each package; asserts equal results, returns one."""
    jax_out, port_out = run("jax"), run("port")
    assert port_out == jax_out
    return port_out


# ---- NSGA-II and the speedup table ----------------------------------------


def test_nsga2_same_population_for_the_same_seed():
    rng = np.random.default_rng(5)
    weights = rng.normal(size=(2, 6))

    def evaluate(pop):
        return np.stack([pop @ weights[0], (pop - 2) ** 2 @ weights[1]], 1)

    def crossover(a, b, r):
        mask = r.random(a.shape) < 0.5
        return np.where(mask, a, b)

    def mutate(pop, r):
        return pop + r.integers(-1, 2, size=pop.shape)

    def repair(pop, r):
        return np.clip(pop, 0, 4)

    initial = rng.integers(0, 5, size=(3, 6))
    outs = [
        mod.minimize(evaluate, initial, crossover, mutate, repair,
                     pop_size=16, generations=12, seed=11)
        for mod in (jax_nsga2, port_nsga2)
    ]
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("accumulation", [True, False])
def test_speedup_tables_agree(accumulation):
    nodes = np.array([1, 1, 1, 2, 2, 3, 2])
    chips = np.array([1, 2, 8, 2, 16, 2, 1])
    fns = [_speedup_fn(pkg, accumulation=accumulation) for pkg in PACKAGES]
    tables = [fn(nodes, chips) for fn in fns]
    np.testing.assert_allclose(tables[1], tables[0], rtol=1e-12, atol=0)
    assert tables[1][-1] == 0.0  # fewer chips than nodes
    for n, c in [(1, 1), (1, 4), (2, 8)]:
        assert fns[1].best_config(n, c) == fns[0].best_config(n, c)
        assert fns[1].best_config_with_hysteresis(
            n, c, None
        ) == fns[0].best_config_with_hysteresis(n, c, None)
    assert fns[1](1, 1) == pytest.approx(1.0)
    assert fns[1](0, 0) == 0.0


def test_speedup_best_config_pure_dp_defaults():
    bsz, accum, sp, tp, ss, ep, micro = _speedup_fn("port").best_config(1, 4)
    assert (sp, tp, ss, ep, micro) == (1, 1, 1, 1, 1)
    assert bsz >= 64
    assert _speedup_fn("port").best_config(1, 4) == _speedup_fn(
        "jax"
    ).best_config(1, 4)


@pytest.mark.parametrize(
    "kw",
    [{"max_seq_shards": 2}, {"max_model_shards": 4}, {"max_stage_shards": 2},
     {"max_expert_shards": 2}, {"mesh_shape_grid": [(1, 1, 1, 1), (1, 2, 1, 1)]}],
)
def test_mesh_hints_raise(kw):
    """Every mesh axis is ported: the seq, model, stage and expert hints
    give the JAX package's table and configurations (``mesh_shape_grid``
    shapes are (sp, tp, ss, ep), so (1, 2, 1, 1) is a model axis; a
    stage configuration carries the pipeline M the search picked). The
    name is kept from when the stage hint raised."""
    nodes, chips = np.array([1, 1, 1, 2, 2]), np.array([1, 2, 4, 4, 8])
    fns = [_speedup_fn(pkg, **kw) for pkg in PACKAGES]
    np.testing.assert_allclose(
        fns[1](nodes, chips), fns[0](nodes, chips), rtol=1e-12, atol=0
    )
    for n, c in zip(nodes.tolist(), chips.tolist()):
        assert fns[1].best_config(n, c) == fns[0].best_config(n, c)


# ---- the policy, cycle after cycle ----------------------------------------


def test_allocate_job_first_fit():
    def run(pkg):
        policy, nodes = _policy(pkg), _nodes(pkg, 2, chips=4)
        return [
            policy.allocate_job(_job(pkg, min_replicas=2), nodes),
            policy.allocate_job(
                _job(pkg, min_replicas=9, max_replicas=16), nodes
            ),
            policy.allocate_job(
                _job(pkg, min_replicas=2), nodes, quarantined={"slice-0"}
            ),
        ]

    first, too_big, skipped = _both(run)
    assert len(first) == 2 and len(set(first)) == 1
    assert too_big == []
    assert set(skipped) == {"slice-1"}


def _cycles(pkg, schedule, **policy_kw):
    """Run ``schedule(pkg)``'s cycles on ONE policy, feeding each cycle's
    allocations back as the next one's base; the list of results."""
    policy = _policy(pkg, **policy_kw)
    base = {}
    out = []
    for jobs, nodes, template, kw in schedule(pkg):
        allocations, desired = policy.optimize(
            jobs, nodes, {k: v for k, v in base.items() if k in jobs},
            template, **kw,
        )
        out.append(({k: list(v) for k, v in allocations.items()}, desired))
        base = allocations
    return out


def test_optimize_allocates_all_jobs_over_cycles():
    def schedule(pkg):
        jobs = {f"job-{i}": _job(pkg, ts=i) for i in range(3)}
        for _ in range(3):
            yield jobs, _nodes(pkg, 2, chips=4), _node(pkg, 4), {}

    result = _both(lambda pkg: _cycles(pkg, schedule))
    for allocations, desired in result:
        assert all(len(allocations[k]) >= 1 for k in allocations)
        assert desired >= 1


def test_optimize_respects_max_replicas():
    def schedule(pkg):
        for _ in range(2):
            yield ({"only": _job(pkg, max_replicas=2)},
                   _nodes(pkg, 2, chips=4), _node(pkg, 4), {})

    for allocations, _ in _both(lambda pkg: _cycles(pkg, schedule)):
        assert len(allocations["only"]) <= 2


def test_distributed_job_owns_its_slice():
    def schedule(pkg):
        jobs = {f"job-{i}": _job(pkg, ts=i, min_replicas=2) for i in range(2)}
        for _ in range(2):
            yield jobs, _nodes(pkg, 2, chips=8), _node(pkg, 8), {}

    for allocations, _ in _both(lambda pkg: _cycles(pkg, schedule)):
        spanning = {}
        for key, alloc in allocations.items():
            if len(alloc) > 1:
                for node in set(alloc):
                    spanning.setdefault(node, set()).add(key)
        assert all(len(c) == 1 for c in spanning.values()), spanning


def test_non_preemptible_job_pinned():
    def run(pkg):
        jobs = {
            "pinned": _job(pkg, preemptible=False),
            "other": _job(pkg, ts=1.0),
        }
        policy = _policy(pkg)
        out = []
        base = {"pinned": ["slice-0", "slice-0"]}
        for _ in range(3):
            allocations, desired = policy.optimize(
                jobs, _nodes(pkg, 2, chips=4), base, _node(pkg, 4)
            )
            out.append((dict(allocations), desired))
            base = dict(allocations, pinned=["slice-0", "slice-0"])
        return out

    for allocations, _ in _both(run):
        assert allocations["pinned"] == ["slice-0", "slice-0"]


def test_warm_start_across_cycles():
    def schedule(pkg):
        jobs = {f"job-{i}": _job(pkg, ts=i) for i in range(2)}
        nodes, template = _nodes(pkg, 2, chips=4), _node(pkg, 4)
        yield jobs, nodes, template, {}
        # One new job, one departed: the warm start re-maps the
        # previous population onto the new job set.
        jobs2 = {"job-1": jobs["job-1"], "job-2": _job(pkg, ts=2)}
        yield jobs2, nodes, template, {}
        yield jobs2, nodes, template, {"quarantined": {"slice-1"}}
        yield jobs2, _nodes(pkg, 3, chips=4), template, {}

    result = _both(lambda pkg: _cycles(pkg, schedule))
    assert set(result[1][0]) == {"job-1", "job-2"}
    assert all("slice-1" not in alloc for alloc in result[2][0].values())


def test_hazard_pricing_places_expensive_restart_on_ondemand():
    def schedule(pkg):
        nodes = {
            "ondemand-0": _node(pkg, 4),
            "spot-0": _node(pkg, 4, preemptible=True, hazard=1 / 600.0),
        }
        jobs = {
            "cheap": _job(pkg, ts=0.0, min_replicas=2, max_replicas=4,
                          restart_cost_s=2.0),
            "expensive": _job(pkg, ts=1.0, min_replicas=2, max_replicas=4,
                              restart_cost_s=240.0),
        }
        for _ in range(2):
            yield jobs, nodes, _node(pkg, 4), {}

    first = _both(lambda pkg: _cycles(pkg, schedule))[0][0]
    assert set(first["expensive"]) == {"ondemand-0"}
    assert set(first["cheap"]) == {"spot-0"}


def test_hazard_expected_loss_exact_objective_math():
    states = np.array([[[1, 0]], [[0, 2]]], dtype=int).reshape(2, -1)

    def evaluate(pkg, hazard, cost):
        job = PACKAGES[pkg][2].JobInfo(
            resources={"tpu": 1}, speedup_fn=_speedup_fn(pkg),
            min_replicas=1, max_replicas=4, restart_cost_s=cost,
        )
        nodes = [_node(pkg, 4, hazard=hazard), _node(pkg, 4)]
        return PACKAGES[pkg][3]._Problem(
            [job], nodes, np.zeros((1, 2), dtype=int)
        ).evaluate(states)

    for hazard, cost in [(1 / 600.0, 240.0), (1 / 60.0, 600.0),
                         (0.0, 240.0), (0.0, None)]:
        np.testing.assert_array_equal(
            evaluate("port", hazard, cost), evaluate("jax", hazard, cost)
        )
    f_free = evaluate("port", 0.0, 240.0)
    f_hz = evaluate("port", 1 / 600.0, 240.0)
    loss = min(240.0 / 600.0, port_pollux.MAX_HAZARD_LOSS)
    assert f_hz[0, 0] == pytest.approx(f_free[0, 0] * (1 - loss))
    assert f_hz[1, 0] == f_free[1, 0]


def test_fitted_jobs_of_different_models_share_a_node():
    """Two jobs of different fitted models on one 2-slot node, with the
    bounds the runners' spec edits use, over consecutive cycles."""
    other = (0.09, 0.004, 0.05, 0.002, 0.02, 0.001, 1.3)

    def schedule(pkg):
        jobs = {
            "a": _job(pkg, ts=0.0, min_replicas=1, max_replicas=2),
            "b": _job(pkg, ts=1.0, min_replicas=1, max_replicas=2,
                      perf=other, grad=(0.01, 0.002)),
        }
        nodes = {"local": _node(pkg, 2)}
        for _ in range(3):
            yield jobs, nodes, _node(pkg, 2), {}
        yield {"a": jobs["a"]}, nodes, _node(pkg, 2), {}

    result = _both(lambda pkg: _cycles(pkg, schedule))
    assert [len(result[0][0][k]) for k in "ab"] == [1, 1]


def test_optimize_incremental_matches():
    def run(pkg):
        policy = _policy(pkg)
        nodes, template = _nodes(pkg, 3, chips=4), _node(pkg, 4)
        jobs = {f"job-{i}": _job(pkg, ts=i) for i in range(3)}
        base, _ = policy.optimize(jobs, nodes, {}, template)
        out = [dict(base)]
        arrival = {"job-3": _job(pkg, ts=3)}
        allocations, desired = policy.optimize_incremental(
            arrival, nodes, base, template, dirty={"job-3"},
            resources={k: {"tpu": 1} for k in jobs},
        )
        out.append((dict(allocations), desired))
        base = dict(allocations)
        changed = {"job-0": _job(pkg, ts=0, min_replicas=2)}
        allocations, desired = policy.optimize_incremental(
            changed, nodes, base, template, dirty={"job-0"},
            resources={k: {"tpu": 1} for k in base if k != "job-0"},
        )
        out.append((dict(allocations), desired))
        return out

    result = _both(run)
    assert "job-3" in result[1][0]


def test_partitioned_cycle_matches():
    def schedule(pkg):
        jobs = {f"job-{i}": _job(pkg, ts=i, max_replicas=4) for i in range(4)}
        for _ in range(2):
            yield jobs, _nodes(pkg, 5, chips=2), _node(pkg, 2), {}

    result = _both(
        lambda pkg: _cycles(pkg, schedule, partition_slices=2)
    )
    assert all(len(alloc) >= 1 for alloc in result[0][0].values())


def test_explain_records_match():
    def run(pkg):
        policy = _policy(pkg)
        jobs = {f"job-{i}": _job(pkg, ts=i) for i in range(2)}
        policy.optimize(jobs, _nodes(pkg, 2, chips=4), {}, _node(pkg, 4))
        return policy.last_explain

    explain = _both(run)
    assert explain["kind"] == "full" and set(explain["jobs"]) == {
        "job-0", "job-1"
    }
