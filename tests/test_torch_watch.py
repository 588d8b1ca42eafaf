"""The port's watch store (``adaptdl_tpu_torch.watch``) against the JAX
package's.

Both stores take one fake clock and one call sequence made from a numpy
seed: measured goodput per job, step-time EWMAs with one straggling rank,
incidents, allocator samples over three jobs of two tenants (published
allocations growing and shrinking, a seq topology, a published batch
config, guard stats, a withdrawn allocation) and explain records. Each
view (``snapshot``, ``status_fields``, ``metrics_view``, ``watch_summary``,
``explain_for`` of every job, ``suspect_slots``) is compared as JSON:
equal after the stores' own 6-digit rounding, except the values that pass
through the goodput model (predictions, rho and what is built from them),
which agree to relative 1e-6.

Also the port's copies of ``tests/test_watch.py``'s drift-threshold,
straggler-majority, starved-tenant, SLO-burn and ring-bound tests, and
the sampling-overhead gate of ``tests/test_watchgate.py`` (under 1 % of
the allocator's cycle time) on the port's state and allocator.
"""

import json
import math
import threading

import numpy as np
import pytest

from adaptdl_tpu import watch as jax_watch
from adaptdl_tpu_torch import watch as port_watch
from adaptdl_tpu_torch.sched.allocator import Allocator
from adaptdl_tpu_torch.sched.policy import NodeInfo, PolluxPolicy
from adaptdl_tpu_torch.sched.state import ClusterState
from adaptdl_tpu_torch.watch import WatchStore, tenant_of

HINTS = {
    "initBatchSize": 128,
    "localBszBounds": [64, 256],
    "maxBatchSize": 1280,
    "maxProfiledReplicas": 2,
    "gradientAccumulation": True,
    "gradParams": {"sqr": 0.00136, "var": 0.000502},
    "perfParams": {
        "alpha_c": 0.121,
        "beta_c": 0.00568,
        "alpha_n": 0.0236,
        "beta_n": 0.00634,
        "alpha_r": 0.0118,
        "beta_r": 0.00317,
        "gamma": 1.14,
    },
}
# Values computed by the goodput model, compared at relative 1e-6.
MODEL_KEYS = {
    "predicted", "ideal", "rho", "share", "drift", "goodputPredicted",
    "goodputDrift", "shareMean", "rhoP50", "rhoP90", "p50",
}
MODEL_RTOL = 1e-6


class FakeClock:
    def __init__(self, t0=1000.0):
        self.now = t0

    def time(self):
        return self.now

    def monotonic(self):
        return self.now


def assert_views_equal(got, want, key=None, path="$"):
    """Equal JSON, with model-derived floats at relative 1e-6."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_views_equal(got[k], want[k], k, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_views_equal(g, w, key, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool) and key in MODEL_KEYS:
        assert isinstance(got, float), path
        assert math.isclose(got, want, rel_tol=MODEL_RTOL, abs_tol=1e-12), (
            path, got, want,
        )
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _script(seed=0, cycles=14):
    """The call sequence, the same for both stores: a list of (method,
    args, kwargs)."""
    rng = np.random.default_rng(seed)
    keys = ["alpha/a", "alpha/b", "beta/c"]
    calls = []
    for cycle in range(cycles):
        for key in keys:
            if rng.random() < 0.7:
                calls.append(("observe_measured",
                              (key, float(rng.uniform(20.0, 400.0))),
                              {"tenant": tenant_of(key)}))
        # Four ranks of alpha/a report step times; rank 2 straggles.
        for rank in range(4):
            ewma = float(rng.uniform(0.09, 0.11)) * (3.0 if rank == 2 else 1.0)
            calls.append(("note_step_time", ("alpha/a", rank, f"s{rank}", ewma), {}))
        if cycle in (3, 9):
            calls.append(("note_incident", ("alpha/b", "nan_loss"),
                          {"blame": "slot", "slot": "s1"}))
        replicas = [4, 2 + cycle % 3, 0 if cycle in (6, 7) else 1]
        jobs = []
        for key, n in zip(keys, replicas):
            job = {
                "key": key,
                "tenant": tenant_of(key),
                "alloc": [f"s{i % 2}" for i in range(n)],
                "topology": None,
                "batchConfig": None,
                "hints": dict(HINTS),
                "requested": 4,
            }
            if key == "alpha/b" and n % 2 == 0:
                job["topology"] = {"seqShards": 2}
            if key == "beta/c":
                job["batchConfig"] = {"atomicBsz": 128, "accumSteps": 1}
                job["hints"]["guardStats"] = {
                    "rollbacks": cycle // 5, "lastGoodAge": 1.5 * cycle,
                    "rawGoodput": 33.25,
                }
            jobs.append(job)
        calls.append(("sample_cycle", (jobs, 8, 4), {"cycle_s": 0.01}))
        explain = {
            "kind": "full" if cycle % 4 == 0 else "incremental",
            "candidates": 0 if cycle % 4 == 2 else 5 + cycle,
            "winner": {"objective": 1.25 + 0.01 * cycle, "nodes": 2},
            "losers": [{"objective": 1.0, "nodes": 1, "killedBy": "speedup"}],
            "desiredNodes": 2,
        }
        per_job = {
            key: ({"alloc": job["alloc"], "replicas": len(job["alloc"]),
                   "pinned": True}
                  if cycle % 4 == 2 else
                  {"alloc": job["alloc"], "replicas": len(job["alloc"]),
                   "speedup": 1.0 + 0.1 * len(job["alloc"])})
            for key, job in zip(keys, jobs)
        }
        calls.append(("note_explain", (cycle, explain["kind"], explain, per_job), {}))
    return keys, calls


def _run(module, calls):
    clock = FakeClock()
    store = module.WatchStore(
        clock=clock, buffer=16, drift_window=5, drift_threshold=0.25,
        straggler_factor=1.5, slo_rho=3.0,
    )
    for method, args, kwargs in calls:
        clock.now += 7.25
        getattr(store, method)(*json.loads(json.dumps(args)), **kwargs)
    return store


@pytest.fixture(scope="module")
def stores():
    keys, calls = _script()
    return keys, _run(jax_watch, calls), _run(port_watch, calls)


def _drop_overhead(view):
    # Wall-clock seconds of the two processes' own sampling.
    view = dict(view)
    view.pop("overhead", None)
    return view


VIEWS = {
    "snapshot": lambda s, keys: _drop_overhead(s.snapshot()),
    "status_fields": lambda s, keys: s.status_fields(),
    "metrics_view": lambda s, keys: s.metrics_view(),
    "watch_summary": lambda s, keys: s.watch_summary(),
    "explain_for": lambda s, keys: {k: s.explain_for(k) for k in keys + ["nobody/x"]},
    "suspect_slots": lambda s, keys: s.suspect_slots(),
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_views_match_jax(stores, view):
    keys, jax_store, port_store = stores
    want = json.loads(json.dumps(VIEWS[view](jax_store, keys)))
    got = json.loads(json.dumps(VIEWS[view](port_store, keys)))
    assert_views_equal(got, want)


def test_scripted_sequence_exercises_every_stream(stores):
    """The sequence reaches what the views compare: drift, a straggler,
    incidents, guard stats, pinned explain records and bounded rings."""
    keys, _, port_store = stores
    view = port_store.metrics_view()
    assert any(job["drift"] is not None for job in view["jobs"].values())
    assert list(port_store.suspect_slots()) == ["s2"]
    assert view["jobs"]["alpha/b"]["incidents"] == 2
    assert view["jobs"]["beta/c"]["rollbacks"] == 2
    history = port_store.explain_for("alpha/a")["history"]
    assert any(rec.get("pinned") for rec in history)
    snapshot = port_store.snapshot()
    assert snapshot["samples"] == 14
    assert len(snapshot["cluster"]) == 14
    assert all(len(s["series"]) <= 16 for s in snapshot["tenants"].values())


@pytest.mark.parametrize(
    "key, spec, want",
    [("team-a/job1", None, "team-a"), ("team-a/job1", {"tenant": "gold"}, "gold"),
     ("bare-job", None, "default")],
)
def test_tenant_of_matches_jax(key, spec, want):
    assert tenant_of(key, spec) == jax_watch.tenant_of(key, spec) == want


# -- the port's copies of tests/test_watch.py's store tests -------------


def test_ring_store_bounded_under_hammer():
    store = WatchStore(buffer=32, drift_window=8)
    jobs = [f"ns/j{i}" for i in range(4)]
    errors = []

    def hammer(seed: int):
        try:
            for i in range(400):
                key = jobs[(seed + i) % len(jobs)]
                store.observe_measured(key, 10.0 + i, tenant="ns")
                store.note_step_time(key, i % 5, f"slot-{i % 3}", 0.1)
                store.sample_cycle(
                    [{"key": key, "tenant": "ns", "alloc": ["slot-0"] * (i % 3),
                      "topology": None, "batchConfig": None, "hints": HINTS,
                      "requested": 4}],
                    total_chips=8, chips_per_slice=4, cycle_s=0.01,
                )
                store.note_explain(
                    i, "full", {"kind": "full", "candidates": 1, "losers": []},
                    {key: {"alloc": [], "replicas": 0}},
                )
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(store.snapshot()["cluster"]) <= 240
    for key in jobs:
        assert len(store._job_series[key]) <= 32
        assert len(store._drift.get(key, [])) <= 8
        assert len(store._explain[key]) <= 8
    for series in store._tenant_series.values():
        assert len(series) <= 32


def _job(key="ns/fit", alloc=("s0", "s0"), requested=4):
    return {
        "key": key, "tenant": "ns", "alloc": list(alloc), "topology": None,
        "batchConfig": None, "hints": HINTS, "requested": requested,
    }


def test_drift_flag_thresholds():
    store = WatchStore(buffer=32, drift_window=8, drift_threshold=0.25)
    job = _job()
    predicted = None
    for _ in range(4):
        store.sample_cycle([job], 8, 4)
        predicted = store.metrics_view()["jobs"]["ns/fit"]["predicted"]
        store.observe_measured("ns/fit", predicted * 1.05, tenant="ns")
    view = store.metrics_view()["jobs"]["ns/fit"]
    assert view["drift"] is None or not view["reprofile"]
    for _ in range(8):
        store.observe_measured("ns/fit", predicted * 0.5, tenant="ns")
        store.sample_cycle([job], 8, 4)
    view = store.metrics_view()["jobs"]["ns/fit"]
    assert view["drift"] is not None and view["drift"] < 0.8
    assert view["reprofile"] is True


def test_straggler_suspect_needs_majority():
    store = WatchStore(straggler_factor=1.5)
    store.note_step_time("ns/j", 0, "slot-a", 0.10)
    store.note_step_time("ns/j", 1, "slot-b", 0.40)
    assert store.suspect_slots() == {}
    store.note_step_time("ns/j", 2, "slot-c", 0.11)
    suspects = store.suspect_slots()
    assert list(suspects) == ["slot-b"]
    assert suspects["slot-b"]["rank"] == 1
    assert suspects["slot-b"]["ratio"] > 1.5


def test_starved_job_shows_stalled_rho_not_stale_goodput():
    store = WatchStore(slo_rho=3.0)
    running = _job("ns/j")
    store.observe_measured("ns/j", 250.0, tenant="ns")
    store.sample_cycle([running], 8, 4)
    assert store.metrics_view()["jobs"]["ns/j"]["measured"] == 250.0
    store.sample_cycle([dict(running, alloc=[])], 8, 4)
    view = store.metrics_view()
    assert view["jobs"]["ns/j"]["measured"] is None
    assert view["jobs"]["ns/j"]["rho"] == port_watch._RHO_STALLED == 100.0
    assert view["tenants"]["ns"]["burn"] >= 1


def test_tenant_slo_burn_counts_slow_samples():
    store = WatchStore(slo_rho=2.0)
    job = _job("ns/slow", alloc=("s0",), requested=8)
    store.observe_measured("ns/slow", 1.0, tenant="ns")
    for _ in range(3):
        store.sample_cycle([job], 8, 4)
    view = store.metrics_view()["tenants"]["ns"]
    assert view["burn"] == 3
    assert view["rho"] > 2.0


def test_watch_sampling_overhead_under_one_percent():
    """The per-cycle sample costs under 1 % of the port allocator's full
    Pollux cycles it rides on."""
    state = ClusterState()
    for i in range(6):
        key = f"t{i % 3}/job{i}"
        state.create_job(key, spec={"max_replicas": 8, "requested": 4})
        state.update(key, status="Running", hints=dict(HINTS))
        state.observe_measured(key, 40.0 + i)
    nodes = {f"slice-{i:02d}": NodeInfo(resources={"tpu": 4}) for i in range(8)}
    allocator = Allocator(
        state, nodes, policy=PolluxPolicy(pop_size=32, generations=20),
        interval=1000.0, full_every=1,
    )
    for _ in range(12):
        allocator.optimize_once()
    overhead = state.watch.snapshot()["overhead"]
    assert overhead["cycleS"] > 0
    ratio = overhead["sampleS"] / overhead["cycleS"]
    assert ratio < 0.01, (
        f"watch sampling cost {ratio:.2%} of the allocator's cycle time "
        f"(sample {overhead['sampleS']:.4f}s over cycle {overhead['cycleS']:.4f}s)"
    )


def test_state_wires_the_store():
    """Hints, beats, incidents and removal reach the state's store."""
    state = ClusterState()
    state.create_job("ns/j", spec={"max_replicas": 4})
    state.update("ns/j", allocation=["s0", "s1", "s2"])
    assert state.observe_measured("ns/j", 12.5)
    assert not state.observe_measured("ns/none", 1.0)
    for rank, ewma in enumerate((0.1, 0.1, 0.5)):
        assert state.note_step_time("ns/j", rank, ewma)
    assert state.watch.suspect_slots()["s2"]["rank"] == 2
    state.report_incident("ns/j", "nan_loss", group=0, rank=1, step=3)
    assert state.watch._incident_counts["ns/j"] == 1
    state.remove_job("ns/j")
    assert "ns/j" not in state.watch._measured
    assert state.watch.suspect_slots() == {}
