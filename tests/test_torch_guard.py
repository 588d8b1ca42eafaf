"""The port's numeric-health guard and what it stands on, against the JAX
package's on the same inputs.

- Guard: seeded (loss, grad_sqr, grad_var) sequences -- NaN, Inf,
  spikes, flat windows, missing statistics -- through both
  ``NumericGuard``s under every policy: the verdicts, the guard stats
  and the skip ranges each hands its loader are equal (no tolerance: the
  same float comparisons on the same floats). The rollback policy runs
  without a checkpoint here (it degrades to skip in both); the rollback
  itself is held below through both loaders and checkpoint stores, and
  through both trainers in test_torch_supervised.py.
- Faults: the same spec and seed fire at the same hits in both; the
  same malformed specs are refused.
- Wire: the eight job-facing families have the JAX package's key tuples.
- Hints: both ``validate_hints`` accept and refuse the same payloads.
- RPC: the port's urllib client and the JAX requests client, against one
  scripted local server, make the same attempts and return or raise
  alike; the circuit breaker opens after the same failures.
- Metrics: restart stats, measured and raw goodput and the guard's
  goodput hygiene agree to 1e-12 relative on the same samples.
- Checkpoint: the same sequence of saves and guard observations leaves
  the same dirs and good markers in both stores and rolls back to the
  same dir.
- Data: both loaders skip a recorded range alike and persist it; a
  checkpoint without a skip table still loads.
"""

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from adaptdl_tpu import checkpoint as jax_checkpoint
from adaptdl_tpu import collective as jax_collective
from adaptdl_tpu import faults as jax_faults
from adaptdl_tpu import guard as jax_guard
from adaptdl_tpu import metrics as jax_metrics
from adaptdl_tpu import rpc as jax_rpc
from adaptdl_tpu import sched_hints as jax_sched_hints
from adaptdl_tpu import wire as jax_wire
from adaptdl_tpu.data import AdaptiveDataLoader as JaxLoader
from adaptdl_tpu_torch import (
    _signal,
    checkpoint,
    epoch,
    faults,
    guard,
    metrics,
    rpc,
    sched_hints,
    wire,
)
from adaptdl_tpu_torch.data import AdaptiveDataLoader
from tests.torch_support import private_tempdir  # noqa: F401

SEED = 1234
POLICIES = ("off", "warn", "skip", "rollback")
SEQUENCES = ("nan", "inf", "spikes", "flat", "mixed")
JOB_ENV = ("ADAPTDL_SUPERVISOR_URL", "ADAPTDL_JOB_ID", "ADAPTDL_CHECKPOINT_PATH",
           "ADAPTDL_FAULT_SPEC")


def _reset_both():
    for reset in (
        checkpoint._reset_registry, metrics._reset_state, epoch._reset_state,
        guard._reset_state, faults.reset, rpc.reset_default_client,
        jax_guard._reset_state, jax_faults.reset, jax_metrics._reset_state,
        jax_rpc.reset_default_client,
        # An iterated JAX loader leaves a one-process reducer behind,
        # which processes forked by later tests would inherit.
        jax_collective.teardown,
    ):
        reset()
    _signal.set_exit_flag(False)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    for name in JOB_ENV:
        monkeypatch.delenv(name, raising=False)
    _reset_both()
    yield
    _reset_both()


# -- the guard ----------------------------------------------------------


def _sequence(kind, seed):
    """40 seeded observations (loss, grad_sqr, grad_var) of one kind."""
    rng = np.random.default_rng((seed, SEQUENCES.index(kind)))
    n = 40
    loss = (2.0 + 0.05 * rng.standard_normal(n)).tolist()
    sqr = np.abs(rng.normal(1.0, 0.1, n)).tolist()
    var = np.abs(rng.normal(0.5, 0.05, n)).tolist()
    picks = rng.choice(np.arange(5, n), size=6, replace=False).tolist()
    if kind == "nan":
        loss[picks[0]] = float("nan")
        sqr[picks[1]] = float("nan")
        var[picks[2]] = float("nan")
    elif kind == "inf":
        loss[picks[0]] = float("inf")
        var[picks[1]] = float("-inf")
        sqr[picks[2]] = float("inf")
    elif kind == "spikes":
        for k, factor in zip(picks, (10.0, 1.5, 1.02, 100.0, 0.1, 1.2)):
            loss[k] *= factor
    elif kind == "flat":
        loss = [2.0] * n
        for k, value in zip(picks, (2.05, 2.2, 1.5, 2.08, 2.09, 3.0)):
            loss[k] = value
    else:  # mixed: spikes, NaN and missing statistics together
        loss[picks[0]] = float("nan")
        loss[picks[1]] *= 50.0
        sqr[picks[2]] = None
        var[picks[3]] = None
        loss[picks[4]] = None
        sqr[picks[5]] = float("inf")
    return list(zip(loss, sqr, var))


class _Loader:
    """The loader face the guard uses: a span out, skip ranges in."""

    def __init__(self):
        self.index = 0
        self.skips = []

    def current_batch_span(self):
        return (0, 8 * self.index, 8 * self.index + 8)

    def add_skip_range(self, epoch, start, end):
        self.skips.append((epoch, start, end))


def _run_guard(module, observations):
    loader = _Loader()
    verdicts = []
    for k, (loss, sqr, var) in enumerate(observations):
        loader.index = k
        verdicts.append(
            module.observe_step(loss, grad_sqr=sqr, grad_var=var, dataloader=loader)
        )
    return verdicts, module.guard_stats(), loader.skips


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", SEQUENCES)
@pytest.mark.parametrize("policy", POLICIES)
def test_guard_verdicts_match_jax(policy, kind, seed, monkeypatch):
    monkeypatch.setenv("ADAPTDL_GUARD_POLICY", policy)
    # A small window and a low threshold exercise the detector's
    # trimming and its arming within 40 observations.
    monkeypatch.setenv("ADAPTDL_GUARD_WINDOW", "8")
    monkeypatch.setenv("ADAPTDL_GUARD_MIN_SAMPLES", "4")
    monkeypatch.setenv("ADAPTDL_GUARD_MAD_K", "4")
    observations = _sequence(kind, seed)
    want = _run_guard(jax_guard, observations)
    got = _run_guard(guard, observations)
    assert got == want
    if policy != "off":
        assert sum(not v["healthy"] for v in got[0]) >= 1


def test_spike_bound_of_a_flat_window_matches_jax(monkeypatch):
    monkeypatch.setenv("ADAPTDL_GUARD_MIN_SAMPLES", "4")
    ours, theirs = guard.NumericGuard(), jax_guard.NumericGuard()
    for g in (ours, theirs):
        g._window = [2.0, 2.0, 2.0, 2.0, 2.0]
    assert ours._spike_bound() == theirs._spike_bound() == 2.0 + 8.0 * 0.02


# -- faults ---------------------------------------------------------------


FAULT_SPECS = [
    ("guard.corrupt_grad=fail@3", 0),
    ("guard.loss_spike=fail@2+", 0),
    ("guard.corrupt_grad=fail%0.3", 0),
    ("guard.corrupt_grad=fail%0.3", SEED),
    ("rpc.request.send=fail%0.5;rpc.response.recv=fail@4", 7),
    ("guard.rollback=fail@1;guard.corrupt_grad=sleep:0@2;guard.loss_spike=fail%0.9", SEED),
]


def _fire_pattern(module, spec, seed, hits=20):
    module.configure(spec, seed=seed)
    points = sorted({c.split("=")[0] for c in spec.split(";")})
    fired = {}
    for point in points:
        pattern = []
        for _ in range(hits):
            try:
                module.maybe_fail(point)
                pattern.append(False)
            except module.InjectedFault:
                pattern.append(True)
        fired[point] = (pattern, module.hit_count(point))
    return fired


@pytest.mark.parametrize("spec,seed", FAULT_SPECS)
def test_fault_schedule_fires_like_jax(spec, seed):
    want = _fire_pattern(jax_faults, spec, seed)
    got = _fire_pattern(faults, spec, seed)
    assert got == want
    assert any(any(pattern) for pattern, _ in got.values())


@pytest.mark.parametrize("spec", [
    "nope=fail", "guard.corrupt_grad=boom", "guard.corrupt_grad=fail@0",
    "guard.corrupt_grad=sleep", "guard.corrupt_grad=fail:1",
    "guard.corrupt_grad=fail%2", "guard.corrupt_grad",
])
def test_malformed_fault_specs_are_refused_like_jax(spec):
    with pytest.raises(ValueError):
        jax_faults.configure(spec)
    with pytest.raises(ValueError):
        faults.configure(spec)


def test_fault_points_the_port_does_not_reach_are_refused():
    jax_faults.configure("ckpt.write.pre_rename=fail@1")
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.configure("ckpt.write.pre_rename=fail@1")
    assert set(faults.INJECTION_POINTS) <= set(jax_faults.INJECTION_POINTS)


def test_fault_schedule_loads_from_the_environment(monkeypatch):
    monkeypatch.setenv("ADAPTDL_FAULT_SPEC", "guard.corrupt_grad=fail@2")
    assert faults.is_active()
    faults.maybe_fail("guard.corrupt_grad")
    with pytest.raises(faults.InjectedFault):
        faults.maybe_fail("guard.corrupt_grad")
    assert faults.hit_count("guard.corrupt_grad") == 2
    faults.reset()
    monkeypatch.delenv("ADAPTDL_FAULT_SPEC")
    assert not faults.is_active() and faults.hit_count("guard.corrupt_grad") == 0


# -- wire and hint validation ----------------------------------------------

FAMILIES = ("sched_hints", "restart_stats", "guard_stats", "incident", "config",
            "batch_config", "heartbeat", "register")


@pytest.mark.parametrize("family", FAMILIES)
def test_wire_families_match_jax(family):
    ours, theirs = wire.WIRE_CONTRACTS[family], jax_wire.WIRE_CONTRACTS[family]
    assert ours["keys"] == theirs["keys"]
    assert ours["required"] == theirs["required"]
    assert ours["persisted"] == theirs["persisted"]


def test_wire_families_are_the_job_facing_ones():
    assert set(wire.WIRE_CONTRACTS) == set(FAMILIES)
    for name in ("SCHED_HINTS_KEYS", "CONFIG_KEYS", "BATCH_CONFIG_KEYS",
                 "HEARTBEAT_KEYS", "REGISTER_KEYS", "INCIDENT_KEYS",
                 "GUARD_STATS_KEYS"):
        assert getattr(wire, name) == getattr(jax_wire, name), name


_PERF = {"alpha_c": 0.1, "beta_c": 0.01, "alpha_n": 0.02, "beta_n": 0.003,
         "alpha_r": 0.01, "beta_r": 0.002, "gamma": 1.2}
HINT_PAYLOADS = [
    {"initBatchSize": 32},
    {"initBatchSize": 32, "perfParams": _PERF, "gradParams": {"sqr": 1, "var": 2}},
    {"initBatchSize": 32, "perfParams": dict(_PERF, alpha_sp=0.1)},
    {"initBatchSize": 32, "nonsense": 1},
    {"initBatchSize": 32, "perfParams": {"alpha_c": 0.1}},
    {"initBatchSize": 32, "perfParams": dict(_PERF, bogus=1.0)},
    {"initBatchSize": 32, "gradParams": {"sqr": 1.0}},
    {"initBatchSize": 32, "restartStats": [1, 2]},
    {"initBatchSize": 32, "guardStats": "bad"},
    {"initBatchSize": 32, "guardStats": {"policy": "rollback"}},
    {"initBatchSize": 32, "measuredGoodput": -1.0},
    {"initBatchSize": 32, "measuredGoodput": True},
    {"initBatchSize": 32, "measuredGoodput": 3.5},
    {"initBatchSize": 32, "meshShapeGrid": [[1, 1, 1, 1], [2, 1, 1, 1]]},
    {"initBatchSize": 32, "meshShapeGrid": [[1, 1, 1]]},
    {"initBatchSize": 32, "meshShapeGrid": "1,1,1,1"},
]


def _verdict(validate, payload):
    try:
        validate(payload)
        return None
    except ValueError as exc:
        return str(exc)


@pytest.mark.parametrize("payload", HINT_PAYLOADS, ids=range(len(HINT_PAYLOADS)))
def test_validate_hints_matches_jax(payload):
    assert _verdict(sched_hints.validate_hints, payload) == _verdict(
        jax_sched_hints.validate_hints, payload
    )


def test_empty_hints_match_jax():
    assert sched_hints.empty_hints() == jax_sched_hints.empty_hints()


# -- the RPC client ---------------------------------------------------------


class _Scripted:
    """A local HTTP server answering each path with a scripted list of
    statuses (the last repeats) and echoing the request."""

    def __init__(self, script):
        self.script = {path: list(statuses) for path, statuses in script.items()}
        self.hits = {}
        self.lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self):
                path, _, query = self.path.partition("?")
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length).decode() if length else ""
                with outer.lock:
                    outer.hits[path] = outer.hits.get(path, 0) + 1
                    statuses = outer.script.get(path, [404])
                    status = statuses.pop(0) if len(statuses) > 1 else statuses[0]
                if path == "/slow":
                    time.sleep(0.3)
                data = json.dumps(
                    {"method": self.command, "query": query, "body": body}
                ).encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_PUT = do_POST = _answer

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


RPC_CASES = {
    "recovers": ([503, 503, 200], {}),
    "exhausts": ([503], {}),
    "not_retried": ([404, 200], {}),
    "retry_404": ([404, 200], {"retry_statuses": rpc.RETRY_STATUSES + (404,)}),
    "one_attempt": ([500, 200], {"attempts": 1}),
}


def _rpc_outcome(client, url, statuses, kwargs, errors):
    try:
        response = client.put(
            url, json={"a": 1}, params={"group": 3}, timeout=(0.5, 2),
            **{"attempts": 3, **kwargs},
        )
    except errors as exc:
        status = exc.response.status_code if exc.response is not None else None
        return ("raised", status)
    try:
        response.raise_for_status()
        raised = False
    except Exception:  # noqa: BLE001 - requests' or the port's error
        raised = True
    return ("returned", response.status_code, response.json(), raised)


@pytest.mark.parametrize("case", sorted(RPC_CASES))
def test_rpc_client_behaves_like_jax(case):
    statuses, kwargs = RPC_CASES[case]
    server = _Scripted({"/jax": statuses, "/port": statuses})
    try:
        want = _rpc_outcome(
            jax_rpc.RpcClient(sleep=lambda s: None), server.url + "/jax",
            statuses, kwargs, jax_rpc.RpcError,
        )
        got = _rpc_outcome(
            rpc.RpcClient(sleep=lambda s: None), server.url + "/port",
            statuses, kwargs, rpc.RpcError,
        )
    finally:
        server.stop()
    assert got == want
    assert server.hits["/port"] == server.hits["/jax"]
    if got[0] == "returned":
        assert got[2] == {"method": "PUT", "query": "group=3", "body": '{"a": 1}'}


def test_rpc_circuit_opens_like_jax():
    # A port nothing listens on: every attempt fails to connect.
    server = _Scripted({})
    dead = server.url + "/x"
    server.stop()
    outcomes = []
    for module in (jax_rpc, rpc):
        client = module.RpcClient(sleep=lambda s: None)
        seen = []
        for _ in range(3):
            try:
                client.get(dead, endpoint="e", attempts=1, circuit_threshold=2,
                           circuit_cooldown=60.0, timeout=(0.5, 0.5))
            except module.CircuitOpenError:
                seen.append("open")
            except module.RpcError:
                seen.append("failed")
        outcomes.append((seen, client.circuit_state("e")[0]))
    assert outcomes[0] == outcomes[1] == (["failed", "failed", "open"], 2)


def test_rpc_timeout_pair_is_its_larger_member():
    server = _Scripted({"/slow": [200]})
    try:
        # 0.3 s to answer: within the read timeout of 1 s, past the
        # connect timeout of 0.1 s.
        response = rpc.RpcClient().get(server.url + "/slow", timeout=(0.1, 1.0))
        assert response.status_code == 200
        with pytest.raises(rpc.RpcError):
            rpc.RpcClient(sleep=lambda s: None).get(
                server.url + "/slow", timeout=0.1, attempts=2
            )
    finally:
        server.stop()


def test_rpc_request_fault_points_fire():
    server = _Scripted({"/ok": [200]})
    try:
        faults.configure("rpc.request.send=fail@1", seed=0)
        client = rpc.RpcClient(sleep=lambda s: None)
        assert client.get(server.url + "/ok", attempts=2).status_code == 200
        assert faults.hit_count("rpc.request.send") == 2
        assert server.hits["/ok"] == 1
    finally:
        server.stop()


# -- metrics: restart stats, goodput, hygiene -------------------------------


def _feed_metrics(module, port):
    module.set_batch_size_config(32, 128, (8, 64), True)
    for bsz, t in ((8, 0.010), (16, 0.018), (32, 0.034)):
        module.profile_accum_time(bsz, t)
    samples = [(16, 0, 0.02), (16, 1, 0.039), (32, 0, 0.036), (32, 1, 0.07)]
    for k, (bsz, accum, t) in enumerate(samples * 3):
        if k == 5:
            module.note_unhealthy_step()
        module.profile_step(bsz, accum, t * (1 + 0.01 * k))
    module.update_grad_params(0.25, 4.0)
    if port:
        module.record_checkpoint_save(1.25, 0.0, {}, total_bytes=4096)
    else:
        module.record_checkpoint_save(1.25, 0.0, {}, kind="full", total_bytes=4096)
    module.record_checkpoint_restore("a", 0.5)
    module.record_checkpoint_restore("b", 0.25)
    module.record_retune()
    state = module.current_state()
    return {
        "restart": module.restart_stats(),
        "measured": module.measured_goodput(),
        "raw": module.raw_goodput(),
        "ewma": module.step_time_ewma(),
        "unhealthy": module.unhealthy_steps(),
        "profile": {
            key: (e.optim_time_sum, e.optim_count, e.accum_time_sum, e.accum_count)
            for key, e in state.profile.items()
        },
    }


def test_metrics_hygiene_and_stats_match_jax(monkeypatch):
    # No refit threads: only the bookkeeping is compared here.
    monkeypatch.setattr(jax_metrics, "_maybe_fit_and_report", lambda *a, **k: None)
    monkeypatch.setattr(metrics, "_maybe_fit", lambda: None)
    want = _feed_metrics(jax_metrics, port=False)
    got = _feed_metrics(metrics, port=True)
    assert got["restart"] == want["restart"]
    assert got["unhealthy"] == want["unhealthy"] == 1
    assert got["profile"] == want["profile"]
    for key in ("measured", "raw", "ewma"):
        assert math.isclose(got[key], want[key], rel_tol=1e-12), key
    # The condemned sample entered only the raw EWMA.
    assert got["raw"] != got["measured"]


def test_metrics_checkpoint_carries_the_new_fields_and_reads_old_ones(
    tmp_path, monkeypatch
):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setattr(metrics, "_maybe_fit", lambda: None)
    metrics.ensure_checkpoint_registered()
    metrics.set_batch_size_config(32)
    metrics.note_unhealthy_step()
    metrics.profile_step(32, 0, 0.5)
    metrics.record_retune()
    checkpoint.save_all_states()
    # A payload describes the saves before it: its own seconds land
    # after it was written.
    first_save_s = metrics.current_state().ckpt_snapshot_s
    checkpoint.save_all_states()
    saved = metrics.current_state()
    checkpoint._reset_registry()
    metrics._reset_state()
    metrics.ensure_checkpoint_registered()
    state = metrics.current_state()
    assert state.unhealthy_steps == 1 and state.num_retunes == 1
    assert state.raw_examples_ewma == saved.raw_examples_ewma == 64.0
    assert first_save_s > 0 and state.ckpt_snapshot_s == first_save_s
    assert metrics.restart_stats()["saveBytes"] > 0
    # A payload from before these fields loads with their defaults.
    import io
    import pickle

    old = {name: getattr(saved, name) for name in metrics._SAVED_FIELDS}
    old["profile"] = {}
    buf = io.BytesIO()
    pickle.dump(old, buf)
    buf.seek(0)
    metrics._MetricsCheckpoint.load(None, buf)
    assert metrics.current_state().unhealthy_steps == 0
    assert metrics.current_state().raw_examples_ewma is None


# -- checkpoint: good markers and rollback ----------------------------------


class _Holder:
    def __init__(self, module, name):
        self.value = 0

        class State(module.State):
            def save(inner, fileobj):
                fileobj.write(str(self.value).encode())

            def load(inner, fileobj):
                self.value = int(fileobj.read().decode())

        self.state = State(name)


# (operation, argument) applied to both stores in turn.
CKPT_SCRIPT = [
    ("save", 1), ("healthy", None), ("healthy", None), ("save", 2),
    ("healthy", None), ("save", 3), ("healthy", None), ("healthy", None),
    ("save", 4), ("reset", None), ("healthy", None), ("save", 5),
    ("healthy", None), ("rollback", None), ("save", 6), ("healthy", None),
    ("healthy", None), ("rollback", None),
]


def _run_ckpt_script(module, root):
    import os

    holder = _Holder(module, "guard_ckpt_value")
    trace = []
    for op, arg in CKPT_SCRIPT:
        if op == "save":
            holder.value = arg
            module.save_all_states()
        elif op == "healthy":
            module.note_healthy_step()
        elif op == "reset":
            module.reset_health_confirmation()
        else:
            holder.value = -1
            trace.append(("restored", module.rollback_to_good(), holder.value))
        dirs = sorted(d for d in os.listdir(root) if d.startswith("checkpoint-"))
        good = [d for d in dirs if module.is_good_checkpoint(os.path.join(root, d))]
        trace.append((op, dirs, good))
    return trace


def test_good_markers_and_rollback_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_GUARD_CONFIRM_STEPS", "2")
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "jax"))
    want = _run_ckpt_script(jax_checkpoint, tmp_path / "jax")
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "port"))
    got = _run_ckpt_script(checkpoint, tmp_path / "port")
    assert got == want
    restored = [t for t in got if t[0] == "restored"]
    # A save prunes every older dir but the newest good one, so the
    # candidate saved just before it never earns its marker.
    assert restored == [
        ("restored", "checkpoint-0.2", 3), ("restored", "checkpoint-0.5", 6)
    ]
    assert checkpoint.last_good_age() >= 0.0


def test_rollback_without_a_good_checkpoint_restores_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    holder = _Holder(checkpoint, "guard_ckpt_value")
    holder.value = 3
    checkpoint.save_all_states()
    holder.value = 4
    assert checkpoint.rollback_to_good() is None
    assert holder.value == 4 and checkpoint.last_good_age() is None
    monkeypatch.delenv("ADAPTDL_CHECKPOINT_PATH")
    assert checkpoint.rollback_to_good() is None


def test_rollback_fault_point_fires_before_any_restore(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("ADAPTDL_GUARD_CONFIRM_STEPS", "1")
    holder = _Holder(checkpoint, "guard_ckpt_value")
    holder.value = 7
    checkpoint.save_all_states()
    checkpoint.note_healthy_step()
    holder.value = 8
    faults.configure("guard.rollback=fail@1", seed=0)
    with pytest.raises(faults.InjectedFault):
        checkpoint.rollback_to_good()
    assert holder.value == 8
    assert checkpoint.rollback_to_good() == "checkpoint-0.0" and holder.value == 7


# -- the loaders' skip table and the guarded chaos run ----------------------


def _spans(module_loader, skip, size=128, batch=8):
    loader = module_loader({"x": np.arange(size, dtype=np.float64)}, batch_size=batch)
    if skip is not None:
        loader.add_skip_range(*skip)
    spans = []
    for _ in loader:
        spans.append(loader.current_batch_span())
    return spans, list(loader._skip_ranges)


@pytest.mark.parametrize("skip", [None, (0, 16, 24), (0, 20, 44), (0, 120, 128), (1, 0, 8)])
def test_loader_skips_like_jax(skip):
    want = _spans(JaxLoader, skip)
    checkpoint._reset_registry()
    jax_checkpoint._reset_registry()
    got = _spans(AdaptiveDataLoader, skip)
    assert got == want
    if skip is not None and skip[0] == 0:
        assert all(e <= skip[1] or s >= skip[2] for _, s, e in got[0])


def test_loader_checkpoint_carries_the_skip_table(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    data = {"x": np.arange(64, dtype=np.float64)}
    loader = AdaptiveDataLoader(data, batch_size=8)
    loader.add_skip_range(0, 8, 16)
    loader.add_skip_range(0, 8, 16)  # recorded once
    checkpoint.save_all_states()
    checkpoint._reset_registry()
    restored = AdaptiveDataLoader(data, batch_size=8)
    assert restored._skip_ranges == [(0, 8, 16)]
    # A payload from before the skip table loads with none.
    import io
    import pickle

    buf = io.BytesIO()
    pickle.dump({"epoch": 0, "index": 16, "loops_finished": {},
                 "atomic_bsz": 8, "accum_steps": 0}, buf)
    buf.seek(0)
    restored._checkpoint.load(buf)
    assert restored._skip_ranges == [] and restored.sampler.index == 16


class _Weights:
    """Deterministic trained state of one package: the update depends
    only on (weights, batch), so a correct rollback and skip replay the
    skip-configured trajectory bit for bit."""

    def __init__(self, module):
        self.w = np.zeros(4, dtype=np.float64)
        outer = self

        class State(module.State):
            def save(inner, fileobj):
                np.save(fileobj, outer.w, allow_pickle=False)

            def load(inner, fileobj):
                outer.w = np.load(fileobj, allow_pickle=False)

        State("guard_chaos_w")


def _guarded_sim(ckpt_mod, guard_mod, faults_mod, loader_cls, poison_at, skip=None):
    weights = _Weights(ckpt_mod)
    loader = loader_cls({"x": np.arange(128, dtype=np.float64)}, batch_size=8)
    if skip is not None:
        loader.add_skip_range(*skip)
    if poison_at is not None:
        faults_mod.configure(f"guard.corrupt_grad=fail@{poison_at}", seed=SEED)
    incidents = []
    for batch in loader:
        weights.w = weights.w * 0.9 + 0.1 * np.sin(np.mean(batch["x"]) + np.sum(weights.w))
        verdict = guard_mod.observe_step(1.0, grad_sqr=1.0, dataloader=loader)
        if not verdict["healthy"]:
            incidents.append(verdict)
    faults_mod.configure(None)
    stats = guard_mod.guard_stats()
    stats.pop("lastGoodAge")  # seconds on the wall clock
    return weights.w, incidents, list(loader._skip_ranges), stats


def test_guarded_rollback_through_loader_and_store_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CKPT_EVERY_STEPS", "1")
    monkeypatch.setenv("ADAPTDL_GUARD_CONFIRM_STEPS", "1")
    # The JAX loader's periodic saves write in the background; blocking
    # writes register each good-marker candidate before the next
    # observation, as the port's blocking saves do.
    real_save = jax_checkpoint.save_all_states
    monkeypatch.setattr(
        jax_checkpoint, "save_all_states",
        lambda **kw: real_save(**{**kw, "wait": True}),
    )
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "jax"))
    want = _guarded_sim(jax_checkpoint, jax_guard, jax_faults, JaxLoader, 5)
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "port"))
    got = _guarded_sim(checkpoint, guard, faults, AdaptiveDataLoader, 5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert [v["action"] for v in got[1]] == ["rollback"] and got[1][0]["restored"]
    # Bit-equal to a port run that skipped the poisoned span from the
    # start (the rollback replayed the batches it rewound exactly).
    checkpoint._reset_registry()
    guard._reset_state()
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path / "skip"))
    base = _guarded_sim(checkpoint, guard, faults, AdaptiveDataLoader, None,
                        skip=got[2][0])
    np.testing.assert_array_equal(base[0], got[0])
    assert base[1] == []
