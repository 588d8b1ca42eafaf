"""The port supervisor's ``/watch``, ``/explain``, ``/status`` and
``/metrics`` against the JAX supervisor's.

Two clusters, one per package, on one fake clock each: the same three
jobs of two tenants (one with a ``tenant`` spec), the same allocator
cycles from the same Pollux inputs (internally seeded), hints carrying
``measuredGoodput`` and beats carrying ``stepTimeEwma`` (one rank
straggles) through each supervisor's own HTTP routes, and one incident.
Then:

- ``/watch``, ``/explain/{job}`` and ``/status`` give equal JSON, apart
  from the watch store's wall-clock sampling seconds;
- ``/metrics`` has the same ``# HELP`` and ``# TYPE`` lines and equal
  samples in every family that is not a time (phase, decision and
  completion seconds), and both expositions pass
  ``tests/promcheck.validate_exposition``; it carries the drift and the
  tenant families;
- the two 404s of ``/explain`` (no such job; no cycle yet) have equal
  bodies, and the port serves ``/metrics`` as ``text/plain``.
"""

import json
import urllib.error
import urllib.request

import pytest

from adaptdl_tpu import trace as jax_trace
from adaptdl_tpu.sched.allocator import Allocator as JaxAllocator
from adaptdl_tpu.sched.policy import NodeInfo as JaxNodeInfo
from adaptdl_tpu.sched.policy import PolluxPolicy as JaxPolicy
from adaptdl_tpu.sched.state import ClusterState as JaxState
from adaptdl_tpu.sched.supervisor import Supervisor as JaxSupervisor
from adaptdl_tpu_torch import trace as port_trace
from adaptdl_tpu_torch.sched.allocator import Allocator as PortAllocator
from adaptdl_tpu_torch.sched.policy import NodeInfo as PortNodeInfo
from adaptdl_tpu_torch.sched.policy import PolluxPolicy as PortPolicy
from adaptdl_tpu_torch.sched.state import ClusterState as PortState
from adaptdl_tpu_torch.sched.supervisor import Supervisor as PortSupervisor
from tests import promcheck
from tests.test_torch_watch import HINTS, FakeClock, assert_views_equal

SIDES = {
    "jax": (JaxState, JaxSupervisor, JaxAllocator, JaxNodeInfo, JaxPolicy, jax_trace),
    "port": (PortState, PortSupervisor, PortAllocator, PortNodeInfo, PortPolicy,
             port_trace),
}
JOBS = {
    "alpha/a": {"max_replicas": 4, "requested": 4},
    "alpha/b": {"max_replicas": 2, "tenant": "gold"},
    "beta/c": {"max_replicas": 4, "requested": 2},
}
# Families whose samples are seconds measured on the wall clock.
TIME_FAMILIES = {
    "adaptdl_trace_phase_seconds", "adaptdl_alloc_decide_seconds",
    "adaptdl_job_completion_seconds", "adaptdl_supervisor_recovery_seconds",
}


def _call(url, method="GET", body=None):
    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        request.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(request, timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.headers.get("Content-Type", ""), exc.read()


def _drive(side):
    state_cls, sup_cls, alloc_cls, node_cls, policy_cls, trace = SIDES[side]
    trace._reset_state()
    clock = FakeClock()
    state = state_cls(clock=clock)
    for key, spec in JOBS.items():
        state.create_job(key, spec=dict(spec))
        state.update(key, status="Running", hints=dict(HINTS))
    supervisor = sup_cls(state, lease_ttl=0.0)
    url = supervisor.start()
    nodes = {f"slice-{i:02d}": node_cls(resources={"tpu": 4}) for i in range(2)}
    allocator = alloc_cls(
        state, nodes, policy=policy_cls(pop_size=8, generations=4), interval=1000.0
    )
    out = {}
    try:
        clock.now += 5.0
        allocator.optimize_once()
        for i, (key, measured) in enumerate((("alpha/a", 180.5), ("beta/c", 75.25))):
            status, _, _ = _call(
                f"{url}/hints/{key}", "PUT", dict(HINTS, measuredGoodput=measured)
            )
            assert status == 200
        for rank, ewma in enumerate((0.1, 0.11, 0.45, 0.1)):
            status, _, _ = _call(
                f"{url}/heartbeat/alpha/a/{rank}?group=0", "PUT", {"stepTimeEwma": ewma}
            )
            assert status == 200
        assert _call(f"{url}/heartbeat/alpha/a/0?group=0", "PUT")[0] == 200
        assert _call(
            f"{url}/incident/beta/c?group=0", "POST",
            {"kind": "nan_loss", "rank": 0, "step": 4},
        )[0] == 200
        for step in range(3):
            clock.now += 30.0
            _call(f"{url}/hints/alpha/a", "PUT",
                  dict(HINTS, measuredGoodput=150.0 + 10 * step))
            allocator.optimize_once()
        # A job no cycle has covered yet.
        state.create_job("beta/late", spec={"max_replicas": 1})
        for route in ("/watch", "/status", "/metrics", "/explain/alpha/a",
                      "/explain/alpha/b", "/explain/beta/c",
                      "/explain/beta/late", "/explain/nobody/x"):
            out[route] = _call(url + route)
    finally:
        allocator.stop()
        supervisor.stop()
    return out


@pytest.fixture(scope="module")
def scraped():
    return {side: _drive(side) for side in SIDES}


def _json(scraped, side, route):
    status, ctype, body = scraped[side][route]
    return status, json.loads(body)


def test_watch_matches_jax(scraped):
    _, want = _json(scraped, "jax", "/watch")
    _, got = _json(scraped, "port", "/watch")
    want.pop("overhead")
    overhead = got.pop("overhead")
    assert overhead["cycleS"] > 0
    assert_views_equal(got, want)
    assert got["jobs"]["alpha/a"]["latest"]["measured"] == 170.0
    assert list(got["suspectSlots"].values())[0]["rank"] == 2
    assert set(got["tenants"]) == {"alpha", "beta", "gold"}


@pytest.mark.parametrize("job", ["alpha/a", "alpha/b", "beta/c"])
def test_explain_matches_jax(scraped, job):
    status, want = _json(scraped, "jax", f"/explain/{job}")
    assert status == 200
    got_status, got = _json(scraped, "port", f"/explain/{job}")
    assert got_status == 200
    assert_views_equal(got, want)
    assert got["latest"]["alloc"] == got["lastDecision"]["alloc"] or got["latest"].get("pinned")


@pytest.mark.parametrize("job", ["beta/late", "nobody/x"])
def test_explain_404s_match_jax(scraped, job):
    want = scraped["jax"][f"/explain/{job}"]
    got = scraped["port"][f"/explain/{job}"]
    assert got[0] == want[0] == 404
    assert json.loads(got[2]) == json.loads(want[2])


def test_status_matches_jax(scraped):
    _, want = _json(scraped, "jax", "/status")
    _, got = _json(scraped, "port", "/status")
    assert_views_equal(got, want)
    job = got["jobs"]["alpha/a"]
    for field in ("tenant", "goodputMeasured", "goodputPredicted", "goodputDrift",
                  "reprofile", "incidents", "rollbacks", "lastGoodAge"):
        assert field in job, field
    assert got["jobs"]["alpha/b"]["tenant"] == "gold"
    assert got["jobs"]["beta/c"]["incidents"] == 1


def _families(text):
    return promcheck.validate_exposition(text)["families"]


def test_metrics_match_jax_and_conform(scraped):
    _, want_type, want_body = scraped["jax"]["/metrics"]
    _, got_type, got_body = scraped["port"]["/metrics"]
    assert got_type.startswith("text/plain") and want_type.startswith("text/plain")
    want_text, got_text = want_body.decode(), got_body.decode()
    meta = lambda text: [ln for ln in text.splitlines() if ln.startswith("# ")]  # noqa: E731
    assert meta(got_text) == meta(want_text)
    want, got = _families(want_text), _families(got_text)
    assert list(got) == list(want)
    for name, family in want.items():
        if name in TIME_FAMILIES:
            continue
        assert got[name]["samples"] == family["samples"], name
    for name in ("adaptdl_goodput_drift", "adaptdl_goodput_measured",
                 "adaptdl_tenant_goodput_share", "adaptdl_tenant_fairness_rho",
                 "adaptdl_tenant_jobs", "adaptdl_tenant_slo_burn_total",
                 "adaptdl_slot_suspect", "adaptdl_cluster_utilization"):
        assert got[name]["samples"], name
    tenants = {labels["tenant"] for _, labels, _ in got["adaptdl_tenant_jobs"]["samples"]}
    assert tenants == {"alpha", "beta", "gold"}
    decide = got["adaptdl_alloc_decide_seconds"]["samples"]
    assert [s for s in decide if s[0].endswith("_count")][0][2] == 4
