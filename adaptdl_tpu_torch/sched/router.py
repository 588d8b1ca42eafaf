"""The thin stateless router in front of supervisor shards.

The port's copy of ``adaptdl_tpu.sched.router``, on the port's threaded
HTTP server and its urllib ``rpc`` client (no aiohttp, no requests). The
router owns NO cluster state: it holds a :class:`ShardMap` (kept on disk
by whoever operates the shard set), picks the owning shard of
``{namespace}/{name}`` by rendezvous hash, and forwards the worker-facing
hot path verbatim (heartbeat, hints, config, trace, preempt, handoff,
candidate, discover, register, explain), one proxy hop from the shard
that journals them. ``/status``, ``/watch`` and ``/metrics`` fan out to
every shard and merge, so ``cli status`` / ``top`` and a Prometheus
scrape see one cluster with a ``shard`` label.

Failure semantics:

- Forwards ride the retrying rpc client with a **per-shard circuit**
  (``endpoint="router/shard{id}"``): a dead shard costs its own workers
  a cheap 503 and costs sibling shards nothing.
- On a failed forward, or a live-resharding ``409 moved`` from a
  tenant's old owner, the router reloads the map from disk. Every extra
  hop needs a STRICTLY newer map version naming a DIFFERENT owner, so a
  stale map costs exactly one re-forward (even across a double flip)
  and never loops; otherwise the worker gets the 503 (or the 409) and
  its own rpc client keeps retrying, as workers already ride out a
  supervisor restart. A shard kill therefore restarts no job.
- Downstream statuses and bodies pass through verbatim; any 409 other
  than "moved" is the worker's to see.
- The router is restartable at will: all it knows is the map file and
  what the shards serve.
"""

from __future__ import annotations

import json
import re
import threading

from adaptdl_tpu_torch import rpc
from adaptdl_tpu_torch.sched.http_server import (
    Request,
    Response,
    ThreadedHttpServer,
    faultable as _faultable,
    json_response,
)
from adaptdl_tpu_torch.sched.shard import ShardMap

# Sample line of a Prometheus exposition: name, optional {labels},
# then the value/timestamp tail that is passed through untouched.
_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?( .*)$"
)


def _label_sample(line: str, shard_id: int) -> str:
    """Inject ``shard="N"`` as the first label of one sample line."""
    m = _SAMPLE_RE.match(line)
    if m is None:
        return line
    name, labels, tail = m.group(1), m.group(2), m.group(3)
    if labels:
        inner = labels[1:-1]
        merged = (
            f'shard="{shard_id}",{inner}' if inner else f'shard="{shard_id}"'
        )
        return f"{name}{{{merged}}}{tail}"
    return f'{name}{{shard="{shard_id}"}}{tail}'


def merge_metrics(per_shard: list[tuple[int, str]]) -> str:
    """Merge per-shard Prometheus expositions into one, tagging every
    sample with its ``shard`` label.

    Families keep first-appearance order; each family's HELP/TYPE is
    emitted exactly once, before any of its samples (the strict
    exposition rules ``tests/promcheck.py`` enforces). Samples keep
    their per-shard label sets disjoint via the injected label, so
    histogram bucket invariants hold per shard series."""
    order: list[str] = []
    help_lines: dict[str, str] = {}
    type_lines: dict[str, str] = {}
    samples: dict[str, list[str]] = {}
    for shard_id, text in per_shard:
        family = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                family = line.split(None, 3)[2]
                if family not in order:
                    order.append(family)
                target = (
                    help_lines
                    if line.startswith("# HELP ")
                    else type_lines
                )
                target.setdefault(family, line)
            elif line.startswith("#"):
                continue
            elif family is not None:
                samples.setdefault(family, []).append(
                    _label_sample(line, shard_id)
                )
    out: list[str] = []
    for family in order:
        if family in help_lines:
            out.append(help_lines[family])
        if family in type_lines:
            out.append(type_lines[family])
        out.extend(samples.get(family, ()))
    return "\n".join(out) + "\n"


def merge_status(per_shard: dict[int, dict]) -> dict:
    """Merge per-shard ``/status`` payloads into the unsharded shape
    plus a ``shards`` section. Tenants partition by shard, so the
    job/slot tables union without collisions; numeric recovery
    counters sum; per-kind hazard estimates merge by max (the
    conservative bound an operator wants)."""
    merged: dict = {
        "jobs": {},
        "slotStrikes": {},
        "quarantinedSlots": {},
        "rollbacks": {},
        "drainingSlots": {},
        "hazardRates": {},
        "preemptionNotices": {},
        "recovery": {
            "recoveries": 0,
            "lastRecoveryS": 0.0,
            "tornRecords": 0,
            "reconcileRemainingS": 0.0,
        },
        "shards": {},
    }
    for sid in sorted(per_shard):
        payload = per_shard[sid]
        summary = {"jobs": 0, "error": payload.get("error")}
        if "error" not in payload:
            merged["jobs"].update(payload.get("jobs", {}))
            summary["jobs"] = len(payload.get("jobs", {}))
            for table in (
                "slotStrikes",
                "quarantinedSlots",
                "rollbacks",
                "drainingSlots",
            ):
                merged[table].update(payload.get(table, {}))
            for kind, rate in (payload.get("hazardRates") or {}).items():
                merged["hazardRates"][kind] = max(
                    merged["hazardRates"].get(kind, 0.0), rate
                )
            for kind, count in (
                payload.get("preemptionNotices") or {}
            ).items():
                merged["preemptionNotices"][kind] = (
                    merged["preemptionNotices"].get(kind, 0) + count
                )
            recovery = payload.get("recovery") or {}
            merged["recovery"]["recoveries"] += recovery.get(
                "recoveries", 0
            )
            merged["recovery"]["tornRecords"] += recovery.get(
                "tornRecords", 0
            )
            for field in ("lastRecoveryS", "reconcileRemainingS"):
                merged["recovery"][field] = max(
                    merged["recovery"][field],
                    recovery.get(field) or 0.0,
                )
            summary["recovery"] = recovery
        merged["shards"][str(sid)] = summary
    return merged


def merge_watch(per_shard: dict[int, dict]) -> dict:
    """Merge per-shard ``/watch`` payloads: tenant/job/suspect tables
    union (tenants partition by shard), sample counters sum, and the
    cluster line is re-synthesized by summing each shard's latest
    utilization sample."""
    merged: dict = {
        "samples": 0,
        "cluster": [],
        "tenants": {},
        "jobs": {},
        "suspectSlots": {},
        "cycles": [],
        "overhead": {"sampleS": 0.0, "cycleS": 0.0},
        "shards": sorted(per_shard),
    }
    latest = {"jobs": 0, "chipsAllocated": 0, "chipsTotal": 0}
    saw_cluster = False
    for sid in sorted(per_shard):
        payload = per_shard[sid]
        if "error" in payload:
            continue
        merged["samples"] += payload.get("samples", 0)
        merged["tenants"].update(payload.get("tenants") or {})
        merged["jobs"].update(payload.get("jobs") or {})
        merged["suspectSlots"].update(payload.get("suspectSlots") or {})
        merged["cycles"].extend(payload.get("cycles") or ())
        overhead = payload.get("overhead") or {}
        merged["overhead"]["sampleS"] += overhead.get("sampleS", 0.0)
        merged["overhead"]["cycleS"] += overhead.get("cycleS", 0.0)
        cluster = payload.get("cluster") or []
        if cluster:
            saw_cluster = True
            last = cluster[-1]
            latest["jobs"] += last.get("jobs", 0)
            latest["chipsAllocated"] += last.get("chipsAllocated", 0)
            latest["chipsTotal"] += last.get("chipsTotal", 0)
    if saw_cluster:
        latest["utilization"] = round(
            latest["chipsAllocated"] / latest["chipsTotal"], 6
        ) if latest["chipsTotal"] else 0.0
        merged["cluster"] = [latest]
    return merged


class Router(ThreadedHttpServer):
    """Thin stateless forwarder over a :class:`ShardMap`."""

    def __init__(
        self,
        shard_map: ShardMap,
        host: str = "127.0.0.1",
        port: int = 0,
        map_path: str | None = None,
        client: rpc.RpcClient | None = None,
        forward_attempts: int = 2,
        forward_deadline: float = 8.0,
        circuit_cooldown: float = 5.0,
    ):
        super().__init__(host=host, port=port)
        self._map_lock = threading.Lock()
        self._map = shard_map  # guarded-by: _map_lock
        self._map_path = map_path
        self._client = client if client is not None else rpc.default_client()
        self._forward_attempts = forward_attempts
        self._forward_deadline = forward_deadline
        # Per-shard circuit cadence, shorter than the client's default: a
        # recovered shard should see its first probe within seconds (the
        # 503s the open circuit serves meanwhile are what worker clients
        # already retry through).
        self._circuit_cooldown = circuit_cooldown

    # -- shard map ----------------------------------------------------

    def current_map(self) -> ShardMap:
        with self._map_lock:
            return self._map

    def set_map(self, shard_map: ShardMap) -> None:
        with self._map_lock:
            self._map = shard_map

    def _reload_map(self) -> bool:
        """Reload the map from disk; True when a NEWER version replaced
        the one in memory (the stale-map signal)."""
        if not self._map_path:
            return False
        try:
            fresh = ShardMap.load(self._map_path)
        except (OSError, ValueError, KeyError):
            return False
        with self._map_lock:
            if fresh.version > self._map.version:
                self._map = fresh
                return True
        return False

    # -- forwarding ---------------------------------------------------

    # Hop budget of one forwarded request. Every extra hop needs a
    # strictly newer map naming a different owner, so only genuine
    # concurrent flips spend it: a stale map resolves in one re-forward,
    # and a double flip too, since the reload jumps to the newest map.
    _MAX_FORWARD_HOPS = 4

    @staticmethod
    def _moved_owner_hint(text: str):
        """The payload of a live-resharding 409 (the old owner of a
        migrated tenant answers ``{"error": "moved", ...}``), or None
        for any other 409, which the worker must see verbatim."""
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return None
        if isinstance(payload, dict) and payload.get("error") == "moved":
            return payload
        return None

    def _forward_sync(
        self, method: str, key: str, path_qs: str, body
    ) -> tuple[int, str]:
        shard_map = self.current_map()
        sid = shard_map.assign(key)
        for _hop in range(self._MAX_FORWARD_HOPS):
            try:
                resp = self._request_shard(
                    method, shard_map.shards[sid], sid, path_qs, body
                )
            except (rpc.CircuitOpenError, rpc.RpcError):
                # Stale-map retry: only a strictly newer map naming a
                # different owner earns a re-forward; otherwise the
                # worker gets 503 and its rpc client retries through
                # the shard's recovery.
                self._reload_map()
                fresh = self.current_map()
                new_sid = fresh.assign(key)
                if fresh.version > shard_map.version and new_sid != sid:
                    shard_map, sid = fresh, new_sid
                    continue
                return 503, (
                    '{"error": "shard unavailable", '
                    f'"shard": {sid}}}'
                )
            if resp.status_code == 409 and self._moved_owner_hint(resp.text):
                # The tenant flipped while this request was in flight:
                # reload and re-forward, at most once per map bump (two
                # shards never both claim the tenant moved under one
                # version).
                self._reload_map()
                fresh = self.current_map()
                new_sid = fresh.assign(key)
                if fresh.version > shard_map.version and new_sid != sid:
                    shard_map, sid = fresh, new_sid
                    continue
            return resp.status_code, resp.text
        return resp.status_code, resp.text

    def _request_shard(
        self, method: str, base_url: str, sid: int, path_qs: str, body
    ):
        return self._client.request(
            method,
            f"{base_url}{path_qs}",
            json=body,
            endpoint=f"router/shard{sid}",
            timeout=(2, 10),
            attempts=self._forward_attempts,
            deadline=self._forward_deadline,
            circuit_cooldown=self._circuit_cooldown,
        )

    @_faultable("router.forward.pre")
    def _forward(self, request: Request) -> Response:
        """The generic hot-path proxy: every ``{namespace}/{name}`` route
        lands here, is rendezvous-routed, and is replayed verbatim at
        the owning shard. Idempotency is the downstream handler's (every
        shard PUT/POST folds retries), so replaying a forward is as safe
        as replaying the worker's request."""
        key = "{namespace}/{name}".format(**request.match_info)
        body = request.json() if request.can_read_body else None
        status, text = self._forward_sync(
            request.method, key, request.path_qs, body
        )
        return Response(status, text.encode("utf-8"))

    # -- aggregation --------------------------------------------------

    def _get_shard(self, shard_map: ShardMap, sid: int, path: str):
        return self._client.get(
            f"{shard_map.shards[sid]}{path}",
            endpoint=f"router/shard{sid}",
            timeout=(2, 10),
            attempts=self._forward_attempts,
            deadline=self._forward_deadline,
            circuit_cooldown=self._circuit_cooldown,
        )

    def _fanout_sync(self, path: str) -> dict[int, dict]:
        """GET ``path`` on every shard; a dead shard contributes an
        ``{"error": ...}`` marker instead of failing the merge."""
        shard_map = self.current_map()
        out: dict[int, dict] = {}
        for sid in shard_map.shard_ids():
            try:
                out[sid] = self._get_shard(shard_map, sid, path).json()
            except (rpc.CircuitOpenError, rpc.RpcError) as exc:
                out[sid] = {"error": str(exc)}
        return out

    def _fanout_text_sync(self, path: str) -> list[tuple[int, str]]:
        shard_map = self.current_map()
        out: list[tuple[int, str]] = []
        for sid in shard_map.shard_ids():
            try:
                out.append((sid, self._get_shard(shard_map, sid, path).text))
            except (rpc.CircuitOpenError, rpc.RpcError):
                continue
        return out

    @_faultable("router.forward.pre")
    def _status(self, request: Request) -> Response:
        return json_response(merge_status(self._fanout_sync("/status")))

    @_faultable("router.forward.pre")
    def _watch(self, request: Request) -> Response:
        return json_response(merge_watch(self._fanout_sync("/watch")))

    @_faultable("router.forward.pre")
    def _metrics(self, request: Request) -> Response:
        return Response(
            200,
            merge_metrics(self._fanout_text_sync("/metrics")).encode("utf-8"),
            {"Content-Type": "text/plain; charset=utf-8"},
        )

    @_faultable("router.forward.pre")
    def _shardmap(self, request: Request) -> Response:
        return json_response(self.current_map().to_payload())

    def _healthz(self, request: Request) -> Response:
        return json_response({"ok": True})

    def routes(self):
        forward = self._forward
        return [
            # Worker-facing hot path: one proxy hop to the tenant's
            # shard. The templates are the supervisor's, so the router
            # is transparent.
            ("GET", "/discover/{namespace}/{name}/{group}", forward),
            ("PUT", "/register/{namespace}/{name}/{group}/{rank}", forward),
            ("PUT", "/heartbeat/{namespace}/{name}/{rank}", forward),
            ("PUT", "/hints/{namespace}/{name}", forward),
            ("GET", "/hints/{namespace}/{name}", forward),
            ("GET", "/config/{namespace}/{name}", forward),
            ("PUT", "/trace/{namespace}/{name}", forward),
            ("GET", "/trace/{namespace}/{name}", forward),
            ("POST", "/preempt/{namespace}/{name}", forward),
            ("PUT", "/handoff/{namespace}/{name}", forward),
            ("GET", "/handoff/{namespace}/{name}", forward),
            ("GET", "/candidate/{namespace}/{name}", forward),
            ("GET", "/explain/{namespace}/{name}", forward),
            # Aggregation: fan out and merge.
            ("GET", "/status", self._status),
            ("GET", "/watch", self._watch),
            ("GET", "/metrics", self._metrics),
            # Router-local.
            ("GET", "/shardmap", self._shardmap),
            ("GET", "/healthz", self._healthz),
        ]
