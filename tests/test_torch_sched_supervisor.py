"""The port's supervisor answers as the JAX package's.

One scripted sequence of HTTP requests goes to ``adaptdl_tpu.sched.
supervisor.Supervisor`` (aiohttp) and to the port's (``http.server``),
each over its own ``ClusterState`` of the same jobs. Every answer must
have the same status code and the same JSON body, with wall-clock fields
masked (lease ages, drain windows, span stamps). The sequence covers:
registration and an unknown job (404), the ``/discover`` long poll held
open until the last rank registers, heartbeats, bad hints (400) and good
ones with their readback, ``/config``, preemption and incident intake
with their idempotent repeats, handoff advertisements (400s, a stale
group's 404), candidates, ``/trace`` round trips (bad bodies 400,
re-sent spans not stored twice), ``/status``, and an injected handler
fault (500). Routes the port has not ported (``/metrics``, ``/watch``,
``/explain``, ``/shard/*``) are not in the sequence.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from adaptdl_tpu import faults as jax_faults
from adaptdl_tpu.sched.state import ClusterState as JaxClusterState
from adaptdl_tpu.sched.supervisor import Supervisor as JaxSupervisor
from adaptdl_tpu_torch import faults as port_faults
from adaptdl_tpu_torch.sched.state import ClusterState as PortClusterState
from adaptdl_tpu_torch.sched.supervisor import Supervisor as PortSupervisor
from tests.torch_support import private_tempdir  # noqa: F401

JOB = "ns/job"
HINTS = {
    "initBatchSize": 32,
    "localBszBounds": [8, 64],
    "maxBatchSize": 256,
    "maxProfiledReplicas": 1,
    "gradientAccumulation": True,
    "gradParams": {"sqr": 0.01, "var": 0.02},
    "perfParams": {
        "alpha_c": 0.01, "beta_c": 0.002, "alpha_n": 0.02, "beta_n": 0.004,
        "alpha_r": 0.01, "beta_r": 0.002, "gamma": 1.2,
    },
}
SPANS = [
    {"name": "ckpt.save", "trace": "t" * 32, "span": "s1", "ts": 5.0,
     "dur": 0.5, "attrs": {"job": JOB}, "pid": 1},
    {"name": "restart.first_step", "trace": "t" * 32, "span": "s2",
     "ts": 6.0, "dur": 1.5, "attrs": {}, "pid": 1},
]


def _request(url, method, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode()
    )
    req = urllib.request.Request(url + path, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


class Plane:
    def __init__(self, state_cls, supervisor_cls, faults):
        self.state = state_cls(alloc_commit_timeout=30.0)
        self.state.create_job(JOB, spec={"max_replicas": 4})
        self.state.create_job("ns/other", spec={"max_replicas": 2})
        self.sup = supervisor_cls(self.state, lease_ttl=60.0)
        self.faults = faults
        self.url = self.sup.start()

    def __call__(self, method, path, body=None, raw=None):
        return _request(self.url, method, path, body, raw)


@pytest.fixture
def planes():
    made = [
        Plane(JaxClusterState, JaxSupervisor, jax_faults),
        Plane(PortClusterState, PortSupervisor, port_faults),
    ]
    try:
        yield made
    finally:
        for plane in made:
            plane.sup.stop()
        jax_faults.reset()
        port_faults.reset()


def _masked(status):
    """``/status`` with its clock readings replaced by their keys."""
    for job in status["jobs"].values():
        job["leaseAgeS"] = sorted(job["leaseAgeS"])
        if job.get("drainRemainingS") is not None:
            job["drainRemainingS"] = "set"
    status["drainingSlots"] = sorted(status["drainingSlots"])
    status["hazardRates"] = {
        k: round(v, 6) for k, v in status["hazardRates"].items()
    }
    return status


def _same(planes, method, path, body=None, raw=None):
    jax_answer = planes[0](method, path, body, raw)
    port_answer = planes[1](method, path, body, raw)
    assert port_answer == jax_answer, (method, path)
    return port_answer


def test_scripted_sequence_answers_alike(planes):
    assert _same(planes, "GET", "/healthz") == (200, {"ok": True})
    assert _same(planes, "PUT", "/register/ns/none/0/0",
                 {"address": "h:1"})[0] == 404
    # A discover long poll on each plane, released by the last register.
    polls = [{}, {}]

    def poll(i):
        polls[i]["answer"] = planes[i]("GET", "/discover/ns/job/0?replicas=2")
        polls[i]["at"] = time.monotonic()

    threads = [threading.Thread(target=poll, args=(i,)) for i in (0, 1)]
    for thread in threads:
        thread.start()
    assert _same(planes, "PUT", "/register/ns/job/0/0",
                 {"address": "h:1", "processes": 2}) == (200, {"ok": True})
    time.sleep(0.6)
    assert all("answer" not in p for p in polls), "released too early"
    released = time.monotonic()
    _same(planes, "PUT", "/register/ns/job/0/1", {"address": "h:2"})
    for thread in threads:
        thread.join(timeout=30)
    assert polls[1]["answer"] == polls[0]["answer"] == (
        200, {"0": "h:1", "1": "h:2"}
    )
    assert polls[1]["at"] - released < 5.0
    # Heartbeats, hints, config.
    assert _same(planes, "PUT", "/heartbeat/ns/job/1?group=0") == (
        200, {"ok": True, "ttl": 60.0}
    )
    assert _same(planes, "PUT", "/heartbeat/ns/none/0")[0] == 404
    for bad in ({"bogus": 1}, dict(HINTS, perfParams={"alpha_c": 1.0}),
                dict(HINTS, measuredGoodput=-1),
                dict(HINTS, meshShapeGrid=[[1, 2]])):
        assert _same(planes, "PUT", "/hints/ns/job?group=0", bad)[0] == 400
    assert _same(planes, "PUT", "/hints/ns/none", HINTS)[0] == 404
    assert _same(planes, "PUT", "/hints/ns/job?group=0", HINTS) == (
        200, {"ok": True}
    )
    assert _same(planes, "GET", "/hints/ns/job") == (200, HINTS)
    assert _same(planes, "GET", "/hints/ns/other") == (200, {})
    assert _same(planes, "GET", "/hints/ns/none")[0] == 404
    for plane in planes:
        plane.state.update(JOB, allocation=["s0", "s0"],
                           batch_config={"atomicBsz": 16, "accumSteps": 0})
    status, config = _same(planes, "GET", "/config/ns/job?group=0")
    assert status == 200 and config["allocation"] == ["s0", "s0"]
    assert _same(planes, "GET", "/config/ns/none")[0] == 404
    # Preemption and incidents, each with its idempotent repeat.
    assert _same(planes, "POST", "/preempt/ns/job", {"group": 0, "rank": 0}
                 ) == (200, {"ok": True, "draining": True})
    assert _same(planes, "POST", "/preempt/ns/job", {"group": 0, "rank": 1}
                 ) == (200, {"ok": True, "draining": False})
    assert _same(planes, "POST", "/preempt/ns/none", {})[0] == 404
    assert _same(planes, "POST", "/incident/ns/job?group=0", {}) == (
        400, {"error": "kind required"}
    )
    incident = {"kind": "nan_grad", "rank": 0, "step": 7, "data": "0:1-2"}
    first = _same(planes, "POST", "/incident/ns/job?group=0", incident)
    assert first[1]["duplicate"] is False
    assert _same(planes, "POST", "/incident/ns/job?group=0", incident)[1][
        "duplicate"
    ] is True
    assert _same(planes, "POST", "/incident/ns/none", incident)[0] == 404
    # Handoff advertisements and candidates.
    assert _same(planes, "PUT", "/handoff/ns/job", {})[0] == 400
    assert _same(planes, "PUT", "/handoff/ns/job",
                 {"url": "http://h:9", "group": "x"})[0] == 400
    assert _same(planes, "PUT", "/handoff/ns/job",
                 {"url": "http://h:9", "group": 2}) == (200, {"ok": True})
    assert _same(planes, "PUT", "/handoff/ns/job",
                 {"url": "http://h:8", "group": 1})[0] == 404
    assert _same(planes, "GET", "/handoff/ns/job") == (
        200, {"url": "http://h:9", "group": 2}
    )
    assert _same(planes, "GET", "/handoff/ns/other") == (200, {})
    assert _same(planes, "GET", "/candidate/ns/job") == (
        404, {"error": "no candidate"}
    )
    for plane in planes:
        plane.state.publish_candidate(JOB, ["s0"], batch_config=None)
    assert _same(planes, "GET", "/candidate/ns/job")[1]["allocation"] == ["s0"]
    # Trace round trips.
    assert _same(planes, "PUT", "/trace/ns/job", raw=b"{not json")[0] == 400
    assert _same(planes, "PUT", "/trace/ns/job", {"spans": [{"dur": 1}]}
                 )[0] == 400
    assert _same(planes, "PUT", "/trace/ns/none", {"spans": SPANS})[0] == 404
    assert _same(planes, "PUT", "/trace/ns/job", {"spans": SPANS}) == (
        200, {"ok": True, "accepted": 2}
    )
    assert _same(planes, "PUT", "/trace/ns/job", {"spans": SPANS}) == (
        200, {"ok": True, "accepted": 0}
    )
    timelines = [plane("GET", "/trace/ns/job") for plane in planes]
    for status, body in timelines:
        assert status == 200
        posted = [s for s in body["spans"] if s["span"] in ("s1", "s2")]
        assert posted == SPANS
    assert timelines[1][1]["job"] == timelines[0][1]["job"] == JOB
    assert timelines[1][1]["traceParent"] == timelines[0][1]["traceParent"]
    assert _same(planes, "GET", "/trace/ns/none")[0] == 404
    # The operator's view, clocks masked.
    statuses = [plane("GET", "/status") for plane in planes]
    assert statuses[1][0] == statuses[0][0] == 200
    jax_status, port_status = (_masked(s[1]) for s in statuses)
    for key, job in port_status.pop("jobs").items():
        jax_job = jax_status["jobs"][key]
        assert job == {k: jax_job[k] for k in job}, key
    jax_status.pop("jobs")
    assert port_status == jax_status
    # An injected handler fault is a 500 on both.
    for plane in planes:
        plane.faults.configure("sup.hints.get.pre=fail@1")
    status, body = _same(planes, "GET", "/hints/ns/job")
    assert status == 500 and "injected fault" in body["error"]
    assert _same(planes, "GET", "/hints/ns/job") == (200, HINTS)


def test_discover_times_out_with_408(planes, monkeypatch):
    from adaptdl_tpu.sched import supervisor as jax_supervisor
    from adaptdl_tpu_torch.sched import supervisor as port_supervisor

    monkeypatch.setattr(jax_supervisor, "_DISCOVER_TIMEOUT", 0.5)
    monkeypatch.setattr(port_supervisor, "_DISCOVER_TIMEOUT", 0.5)
    assert _same(planes, "GET", "/discover/ns/job/3?replicas=1") == (
        408, {"error": "discover timeout"}
    )


def test_stop_releases_a_parked_long_poll():
    state = PortClusterState()
    state.create_job(JOB, spec={})
    sup = PortSupervisor(state)
    url = sup.start()
    answer = {}
    thread = threading.Thread(
        target=lambda: answer.setdefault(
            "r", _request(url, "GET", "/discover/ns/job/0?replicas=2")
        )
    )
    thread.start()
    time.sleep(0.3)
    start = time.monotonic()
    sup.stop()
    thread.join(timeout=10)
    assert not thread.is_alive() and time.monotonic() - start < 5
    assert answer["r"] == (408, {"error": "discover timeout"})


def test_unknown_route_and_method_answer_with_the_envelope():
    state = PortClusterState()
    sup = PortSupervisor(state)
    url = sup.start()
    try:
        assert _request(url, "GET", "/nowhere") == (404, {"error": "not found"})
        assert _request(url, "POST", "/healthz", {})[0] == 405
        # A handler that raises answers 500 (bad JSON in a register).
        state.create_job(JOB, spec={})
        status, body = _request(url, "PUT", "/register/ns/job/0/0",
                                raw=b"{nope")
        assert status == 500 and "error" in body
    finally:
        sup.stop()


def test_the_lease_sweeper_withdraws_a_silent_rank():
    state = PortClusterState(alloc_commit_timeout=0.0)
    state.create_job(JOB, spec={})
    state.update(JOB, allocation=["s0"], status="Running")
    sup = PortSupervisor(state, lease_ttl=0.3, sweep_interval=0.05)
    url = sup.start()
    try:
        assert _request(url, "PUT", "/heartbeat/ns/job/0?group=0")[0] == 200
        deadline = time.monotonic() + 10
        while state.get_job(JOB).allocation and time.monotonic() < deadline:
            time.sleep(0.05)
        record = state.get_job(JOB)
        assert record.degraded and record.allocation == []
    finally:
        sup.stop()


SPEC_CASES = {
    "valid": ({"min_replicas": 1, "max_replicas": 4}, None),
    "defaults": ({}, None),
    "max_below_min": ({"min_replicas": 3, "max_replicas": 2}, None),
    "negative_min": ({"min_replicas": -1}, None),
    "zero_max": ({"max_replicas": 0}, None),
    "float_bound": ({"max_replicas": 2.0}, None),
    "bad_resource": ({"resources": {"tpu": -1}}, None),
    "update_keeps_bounds": (
        {"min_replicas": 1, "max_replicas": 4, "preemptible": False},
        {"min_replicas": 1, "max_replicas": 4},
    ),
    "update_moves_max": (
        {"min_replicas": 1, "max_replicas": 8},
        {"min_replicas": 1, "max_replicas": 4},
    ),
    "update_moves_template": (
        {"template": {"spec": {}}}, {"template": {}},
    ),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_validation_answers_as_the_jax_one(case):
    """``validate_job_spec`` and ``validate_job_update`` accept and refuse
    what the JAX package's do, with the same messages."""
    from adaptdl_tpu.sched import validator as jax_validator
    from adaptdl_tpu_torch.sched import validator as port_validator

    spec, old = SPEC_CASES[case]

    def answer(module):
        try:
            if old is None:
                module.validate_job_spec(spec)
            else:
                module.validate_job_update(old, spec)
        except module.ValidationError as exc:
            return str(exc)
        return None

    assert answer(port_validator) == answer(jax_validator)
