"""Supervisor: the cluster's REST face toward running jobs.

The port's copy of ``adaptdl_tpu.sched.supervisor``, on the standard
library's threading HTTP server (``sched.http_server``). Every route the
port's job side calls answers with the JAX supervisor's status codes and
JSON bodies, so either control plane drives either job side:

- ``GET /discover/{namespace}/{name}/{group}?replicas=N`` long-polls
  until N workers of restart group ``group`` have registered, then
  returns their addresses by rank (the rank-0 rendezvous); 408 after
  300 s. The wait is on the cluster state's condition variable, woken
  by each registration, with a deadline.
- ``PUT /register/{namespace}/{name}/{group}/{rank}``: worker
  self-registration (``{"address", "processes"}``).
- ``PUT /heartbeat/{namespace}/{name}/{rank}[?group=N]``: lease renewal.
- ``PUT`` / ``GET /hints/{namespace}/{name}``: validated sched-hints
  intake (400 on a malformed payload) and readback.
- ``GET /config/{namespace}/{name}``: the job's current decision.
- ``POST /preempt/...``, ``POST /incident/...``: reclaim-notice and
  numeric-incident intake.
- ``PUT`` / ``GET /handoff/...``, ``GET /candidate/...``: handoff
  advertisements and the predicted next launch config.
- ``PUT`` / ``GET /trace/{namespace}/{name}``: worker span intake (a
  bounded, de-duplicated store per job) and the stitched timeline.
- ``GET /healthz``, ``GET /status``.

Durability: with a journaled ``ClusterState`` (``state_dir``) every
mutating request fsyncs its journal record under the state's condition
before it applies, as the JAX supervisor's executor threads do. Each
request runs on a thread of its own, so another request waits at most
for that one fsync, and a ``/discover`` long poll holds the condition
only while it tests its predicate. A supervisor restarted on the same
``state_dir`` recovers the job table; its workers' re-registrations and
beats land in the same restart group, and no lease expires and no epoch
rolls back within the reconciliation window.

Liveness: each worker rank holds a lease of ``lease_ttl`` seconds; a
sweeper thread expires stale leases (the job is marked degraded and its
allocation withdrawn for re-placement) and rolls back allocation epochs
that missed their commit deadline. Handlers are fault-injection points
(``sup.*.pre``) whose injected faults become 500s.

Not ported yet (ROADMAP Queue 1): ``/watch``, ``/explain``, ``/metrics``
and the ``/shard/*`` routes with their reshard gate.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from adaptdl_tpu_torch import env, sched_hints, trace
from adaptdl_tpu_torch.sched.http_server import (
    Request,
    Response,
    ThreadedHttpServer,
    error_response,
    faultable as _faultable,
    json_response,
)
from adaptdl_tpu_torch.sched.state import ClusterState

LOG = logging.getLogger(__name__)

_DISCOVER_TIMEOUT = 300.0


def _group_param(request: Request) -> int | None:
    """The worker's restart group, when the request reports it."""
    raw = request.query.get("group")
    return int(raw) if raw not in (None, "") else None


def _job_key(request: Request) -> str:
    return "{namespace}/{name}".format(**request.match_info)


def _body_dict(request: Request) -> dict:
    """The JSON body when it is an object, else ``{}``."""
    try:
        body = request.json()
    except ValueError:
        body = {}
    return body if isinstance(body, dict) else {}


class Supervisor(ThreadedHttpServer):
    def __init__(
        self,
        state: ClusterState,
        host="127.0.0.1",
        port=0,
        lease_ttl: float | None = None,
        sweep_interval: float | None = None,
    ):
        super().__init__(host=host, port=port)
        self._state = state
        self._lease_ttl = env.lease_ttl() if lease_ttl is None else lease_ttl
        # Per-job store of worker-posted trace spans, bounded.
        self._trace_lock = threading.Lock()
        self._trace_store: dict[str, deque] = {}  # guarded-by: _trace_lock
        # Default cadence: a quarter of whichever expiry clock is
        # active (lease TTL, else the allocation-commit timeout).
        clock = self._lease_ttl
        if clock <= 0:
            clock = state.alloc_commit_timeout
        self._sweep_interval = (
            sweep_interval
            if sweep_interval is not None
            else max(min(clock / 4.0, 5.0), 0.05)
        )
        self._stopping = threading.Event()
        self._sweeper: threading.Thread | None = None

    def _renew(self, key: str, rank: int, group: int | None = None) -> None:
        """Piggybacked lease renewal: any traffic from a worker proves it
        alive. ``group`` gets the same stale-incarnation guard as a
        heartbeat."""
        self._state.renew_lease(key, rank, self._lease_ttl, group=group)

    # -- handlers -----------------------------------------------------------

    @_faultable("sup.discover.pre")
    def _discover(self, request: Request) -> Response:
        key = _job_key(request)
        group = int(request.match_info["group"])
        want = int(request.query.get("replicas", "0"))
        found: dict = {}

        def ready(jobs) -> bool:
            if self._stopping.is_set():
                return True
            record = jobs.get(key)
            if record is None or record.group != group:
                return False
            workers = record.workers
            if (want and len(workers) >= want) or (not want and workers):
                found["workers"] = dict(workers)
                return True
            return False

        self._state.wait_for(ready, timeout=_DISCOVER_TIMEOUT)
        workers = found.get("workers")
        if workers is None:
            return error_response("discover timeout", 408)
        return json_response(
            {str(rank): addr for rank, addr in workers.items()}
        )

    @_faultable("sup.register.pre")
    def _register(self, request: Request) -> Response:
        key = _job_key(request)
        group = int(request.match_info["group"])
        rank = int(request.match_info["rank"])
        body = request.json()
        if self._state.get_job(key) is None:
            return error_response("no such job", 404)
        if self._state.register_worker(
            key, group, rank, body["address"],
            # The reported process count is the commit quorum of a
            # pending allocation epoch.
            processes=body.get("processes"),
        ):
            # Only an ACCEPTED registration earns a lease: a stale
            # group's retry must not plant a phantom lease.
            self._renew(key, rank)
        return json_response({"ok": True})

    @_faultable("sup.heartbeat.pre")
    def _heartbeat(self, request: Request) -> Response:
        key = _job_key(request)
        rank = int(request.match_info["rank"])
        group = _group_param(request)
        # A beat's body may carry the rank's step-time EWMA, which the
        # JAX supervisor hands its watch store (not ported): a beat is
        # a lease renewal here whatever it carries.
        if not self._state.renew_lease(key, rank, self._lease_ttl, group=group):
            return error_response("no such job", 404)
        return json_response({"ok": True, "ttl": self._lease_ttl})

    @_faultable("sup.hints.pre")
    def _put_hints(self, request: Request) -> Response:
        key = _job_key(request)
        hints = request.json()
        try:
            sched_hints.validate_hints(hints)
        except ValueError as exc:
            return error_response(str(exc), 400)
        group = _group_param(request)
        if self._state.get_job(key) is None:
            return error_response("no such job", 404)
        self._state.update(key, hints=hints)
        # Hints are posted from rank 0's fit thread: a liveness beat.
        self._renew(key, 0, group=group)
        return json_response({"ok": True})

    @_faultable("sup.hints.get.pre")
    def _get_hints(self, request: Request) -> Response:
        record = self._state.get_job(_job_key(request))
        if record is None:
            return error_response("no such job", 404)
        return json_response(record.hints or {})

    @_faultable("sup.config.pre")
    def _get_config(self, request: Request) -> Response:
        """The job's current decision as one snapshot: allocation and
        topology (a change means checkpoint-restart), batch config and
        re-tune counter (adopted live)."""
        key = _job_key(request)
        group = _group_param(request)
        snapshot = self._state.get_config_snapshot(key)
        if snapshot is None:
            return error_response("no such job", 404)
        self._renew(key, 0, group=group)
        return json_response(snapshot)

    @_faultable("sup.preempt.pre")
    def _preempt(self, request: Request) -> Response:
        """Reclaim-notice intake: the doomed slots leave the inventory
        and the allocator is kicked, so the successor's epoch opens
        during the notice window. Idempotent per drain."""
        key = _job_key(request)
        body = _body_dict(request)
        if self._state.get_job(key) is None:
            return error_response("no such job", 404)
        accepted = self._state.report_preemption(
            key,
            group=body.get("group"),
            rank=body.get("rank"),
            slot=body.get("slot"),
            notice_s=body.get("noticeS"),
            trace_parent=body.get("traceParent"),
        )
        if accepted and body.get("rank") is not None:
            self._renew(key, int(body["rank"]), group=body.get("group"))
        return json_response({"ok": True, "draining": bool(accepted)})

    @_faultable("sup.incident.pre")
    def _incident(self, request: Request) -> Response:
        """Numeric-incident intake: journalled once per (group, step,
        kind), blame classified, the allocator kicked."""
        key = _job_key(request)
        group = _group_param(request)
        body = _body_dict(request)
        kind = body.get("kind")
        if not kind:
            return error_response("kind required", 400)
        if self._state.get_job(key) is None:
            return error_response("no such job", 404)
        verdict = self._state.report_incident(
            key,
            str(kind),
            group=group,
            rank=body.get("rank"),
            step=body.get("step"),
            data=body.get("data"),
            action=body.get("action"),
        )
        if body.get("rank") is not None:
            self._renew(key, int(body["rank"]), group=group)
        if verdict is None:
            return json_response({"ok": True, "duplicate": True})
        blame, slot = verdict
        return json_response(
            {"ok": True, "duplicate": False, "blame": blame, "slot": slot}
        )

    @_faultable("sup.handoff.pre")
    def _put_handoff(self, request: Request) -> Response:
        """A draining incarnation's shard server advertises its URL and
        restart group for the successor."""
        key = _job_key(request)
        body = _body_dict(request)
        url = body.get("url")
        if not url:
            return error_response("url required", 400)
        try:
            group = int(body.get("group", 0))
        except (TypeError, ValueError):
            return error_response("group must be an integer", 400)
        if not self._state.advertise_handoff(key, str(url), group):
            return error_response("no such job (or stale group)", 404)
        return json_response({"ok": True})

    @_faultable("sup.handoff.get.pre")
    def _get_handoff(self, request: Request) -> Response:
        key = _job_key(request)
        if self._state.get_job(key) is None:
            return error_response("no such job", 404)
        return json_response(self._state.get_handoff(key) or {})

    @_faultable("sup.candidate.pre")
    def _get_candidate(self, request: Request) -> Response:
        """The allocator's predicted next launch config; 404 when none
        is published."""
        key = _job_key(request)
        if self._state.get_job(key) is None:
            return error_response("no such job", 404)
        candidate = self._state.get_candidate(key)
        if candidate is None:
            return error_response("no candidate", 404)
        return json_response(candidate)

    def _healthz(self, request: Request) -> Response:
        return json_response({"ok": True})

    @_faultable("sup.status.pre")
    def _status(self, request: Request) -> Response:
        """Operator view: per-job phase, degraded flag, allocation epoch
        and state, lease ages; slot strikes and quarantine; recovery,
        preemption and incident sections."""
        return json_response(self._status_payload())

    def _status_payload(self) -> dict:
        payload = self._state.status_snapshot()
        for job in payload["jobs"].values():
            # Remaining seconds -> age since the last renewal.
            job["leaseAgeS"] = {
                rank: round(max(self._lease_ttl - remaining, 0.0), 3)
                for rank, remaining in job.pop("leaseRemainingS").items()
            }
        health = self._state.slot_health()
        payload["slotStrikes"] = health["strikes"]
        payload["quarantinedSlots"] = {
            slot: round(remaining, 3)
            for slot, remaining in health["quarantined"].items()
        }
        payload["rollbacks"] = health["rollbacks"]
        payload["recovery"] = self._state.recovery_info()
        preempt = self._state.preemption_info()
        payload["drainingSlots"] = {
            slot: round(remaining, 3)
            for slot, remaining in preempt["drainingSlots"].items()
        }
        payload["hazardRates"] = {
            kind: round(rate, 9)
            for kind, rate in preempt["hazardRates"].items()
        }
        payload["preemptionNotices"] = preempt["noticesByKind"]
        incidents = self._state.incident_info()
        payload["incidentsByKind"] = incidents["incidentsByKind"]
        payload["incidentSlotBlame"] = incidents["slotBlame"]
        payload["incidentDataBlame"] = incidents["dataBlame"]
        return payload

    # -- worker span intake and the stitched per-job timeline ----------------

    @staticmethod
    def _valid_span_record(rec) -> bool:
        """A poison record bounces as a 400 here instead of failing
        every later GET."""
        return (
            isinstance(rec, dict)
            and isinstance(rec.get("name"), str)
            and bool(rec.get("name"))
            and isinstance(rec.get("dur", 0.0), (int, float))
            and isinstance(rec.get("ts", 0.0), (int, float))
        )

    @_faultable("sup.trace.pre")
    def _put_trace(self, request: Request) -> Response:
        key = _job_key(request)
        try:
            body = request.json()
        except ValueError:
            return error_response("body must be JSON", 400)
        spans = (body or {}).get("spans")
        if not isinstance(spans, list) or not all(
            self._valid_span_record(rec) for rec in spans
        ):
            return error_response('body must be {"spans": [{...}, ...]}', 400)
        if self._state.get_job(key) is None:
            return error_response("no such job", 404)
        # Idempotent intake: a re-sent batch appends only spans not
        # already stored.
        with self._trace_lock:
            store = self._trace_store.get(key)
            if store is None:
                store = deque(maxlen=trace.BUFFER_SIZE)
                self._trace_store[key] = store
            seen = {rec.get("span") for rec in store}
            fresh = []
            for rec in spans:
                span_id = rec.get("span")
                if span_id is not None and span_id in seen:
                    continue
                seen.add(span_id)
                fresh.append(rec)
            store.extend(fresh)
        return json_response({"ok": True, "accepted": len(fresh)})

    def _job_trace_spans(self, key: str) -> list[dict]:
        """Worker-posted spans merged with this process's own spans for
        the job (tagged with it, or sharing a trace id with its spans or
        its decision), de-duplicated by span id, in time order."""
        with self._trace_lock:
            store = self._trace_store.get(key)
            merged = list(store) if store else []
        seen = {rec.get("span") for rec in merged}
        local = trace.snapshot_spans()
        tagged = [
            rec
            for rec in local
            if (rec.get("attrs") or {}).get("job") == key
            and rec.get("span") not in seen
        ]
        merged.extend(tagged)
        seen.update(rec.get("span") for rec in tagged)
        trace_ids = {rec.get("trace") for rec in merged}
        record = self._state.get_job(key)
        if record is not None and record.trace_parent:
            parsed = trace.parse_traceparent(record.trace_parent)
            if parsed is not None:
                trace_ids.add(parsed[0])
        merged.extend(
            rec
            for rec in local
            if rec.get("trace") in trace_ids and rec.get("span") not in seen
        )
        merged.sort(key=lambda rec: float(rec.get("ts", 0.0)))
        return merged

    @_faultable("sup.trace.get.pre")
    def _get_trace(self, request: Request) -> Response:
        key = _job_key(request)
        record = self._state.get_job(key)
        if record is None:
            return error_response("no such job", 404)
        return json_response(
            {
                "job": key,
                "traceParent": record.trace_parent,
                "spans": self._job_trace_spans(key),
            }
        )

    # -- lifecycle ----------------------------------------------------------

    def _sweep_loop(self) -> None:
        """Expire stale worker leases and overdue allocation epochs on a
        fixed cadence."""
        while not self._stopping.wait(self._sweep_interval):
            try:
                expired = (
                    self._state.expire_stale_leases()
                    if self._lease_ttl > 0
                    else []
                )
                rolled = self._state.expire_overdue_allocations()
            except Exception:  # noqa: BLE001 - the sweeper must survive
                LOG.exception("lease/epoch sweep failed")
                continue
            for key, rank in expired:
                LOG.warning(
                    "lease expired for %s rank %d: job marked degraded, "
                    "allocation withdrawn for re-placement", key, rank,
                )
            for key in rolled:
                LOG.warning(
                    "allocation epoch for %s missed its commit deadline: "
                    "rolled back to the last-committed allocation", key,
                )

    def on_start(self) -> None:
        self._stopping.clear()
        if self._lease_ttl <= 0 and self._state.alloc_commit_timeout <= 0:
            return
        self._sweeper = threading.Thread(
            target=self._sweep_loop, name="adaptdl-torch-sweeper", daemon=True
        )
        self._sweeper.start()

    def on_stop(self) -> None:
        self._stopping.set()
        # Release every long poll parked on the state's condition.
        self._state.notify_all()
        if self._sweeper is not None:
            self._sweeper.join(timeout=10)
            self._sweeper = None

    def _timed(self, handler):
        """Record each request as a ``sup.endpoint.<segment>`` span."""

        def run(request: Request) -> Response:
            start = time.monotonic()
            try:
                return handler(request)
            finally:
                parts = request.path.split("/", 2)
                segment = parts[1] if len(parts) > 1 and parts[1] else "root"
                trace.record_span(
                    f"sup.endpoint.{segment}", time.monotonic() - start
                )

        return run

    def routes(self):
        table = [
            ("GET", "/discover/{namespace}/{name}/{group}", self._discover),
            ("PUT", "/register/{namespace}/{name}/{group}/{rank}", self._register),
            ("PUT", "/heartbeat/{namespace}/{name}/{rank}", self._heartbeat),
            ("PUT", "/hints/{namespace}/{name}", self._put_hints),
            ("GET", "/hints/{namespace}/{name}", self._get_hints),
            ("GET", "/config/{namespace}/{name}", self._get_config),
            ("PUT", "/trace/{namespace}/{name}", self._put_trace),
            ("GET", "/trace/{namespace}/{name}", self._get_trace),
            ("POST", "/preempt/{namespace}/{name}", self._preempt),
            ("POST", "/incident/{namespace}/{name}", self._incident),
            ("PUT", "/handoff/{namespace}/{name}", self._put_handoff),
            ("GET", "/handoff/{namespace}/{name}", self._get_handoff),
            ("GET", "/candidate/{namespace}/{name}", self._get_candidate),
            ("GET", "/healthz", self._healthz),
            ("GET", "/status", self._status),
        ]
        return [(m, p, self._timed(h)) for m, p, h in table]
