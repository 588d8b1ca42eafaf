"""The port's shard router against the JAX package's, request for request.

A JAX router before JAX shards and a port router before port shards take
one scripted request sequence, each on a frozen clock: forwarding,
passthrough of downstream statuses, a fault point turning into a 500,
the merged ``/status`` with a dead shard's error marker, a stale-map
retry and the 503 without a newer map, the double-flip single
re-forward, a ``moved`` 409 without a newer map, and a non-moved 409
passed through verbatim. Statuses, bodies and the per-request shard hops
must be equal; only error texts (transport messages differ by client
library), lease ages and timestamps are masked.
"""

from __future__ import annotations

import json
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import adaptdl_tpu.faults as jax_faults
import adaptdl_tpu.rpc as jax_rpc
from adaptdl_tpu.sched import router as jax_router
from adaptdl_tpu.sched import shard as jax_shard
from adaptdl_tpu_torch import faults as port_faults
from adaptdl_tpu_torch import rpc as port_rpc
from adaptdl_tpu_torch.sched import router as port_router
from adaptdl_tpu_torch.sched import shard as port_shard
from tests.torch_support import private_tempdir  # noqa: F401

HINTS = {"initBatchSize": 128, "maxBatchSize": 1280}

PACKAGES = {
    "jax": types.SimpleNamespace(
        faults=jax_faults, rpc=jax_rpc, router=jax_router, shard=jax_shard
    ),
    "port": types.SimpleNamespace(
        faults=port_faults, rpc=port_rpc, router=port_router,
        shard=port_shard,
    ),
}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for pkg in PACKAGES.values():
        pkg.faults.reset()
        pkg.rpc.reset_default_client()
    yield
    for pkg in PACKAGES.values():
        pkg.faults.reset()
        pkg.rpc.reset_default_client()


class _FrozenClock:
    @staticmethod
    def monotonic() -> float:
        return 1000.0

    @staticmethod
    def time() -> float:
        return 1_700_000_000.0


class _CountingClient:
    """Delegates to a package's rpc client and records each request's
    endpoint label: the router's per-hop audit trail."""

    def __init__(self, inner):
        self._inner = inner
        self.endpoints = []

    def request(self, method, url, **kwargs):
        self.endpoints.append(kwargs.get("endpoint"))
        return self._inner.request(method, url, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def hops(self):
        return [e for e in self.endpoints if e and e.startswith("router/shard")]


class _ConflictShard:
    """A stub downstream that answers every request with an application
    409 (not a ``moved`` one)."""

    BODY = b'{"error": "conflict", "detail": "stale generation"}'

    def __init__(self):
        body = self.BODY

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _serve(self):
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)
                self.send_response(409)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_PUT = do_POST = _serve  # noqa: N815

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def _tenant_for(shard_map, sid):
    for i in range(1000):
        tenant = f"tenant-{i}"
        if shard_map.assign(f"{tenant}/j") == sid:
            return tenant
    raise AssertionError("no tenant found")


def _mask(value):
    """Mask what legitimately differs between runs or client libraries:
    free-text errors (an error code word such as "moved" stays), lease
    ages, wall or monotonic stamps and the shards' ports."""
    if isinstance(value, dict):
        out = {}
        for key, item in value.items():
            if key == "error" and isinstance(item, str) and " " in item:
                out[key] = "<error>"
            elif key in ("leaseAges", "leases") or key.endswith(("Ts", "AgeS")):
                out[key] = "<time>"
            else:
                out[key] = _mask(item)
        return out
    if isinstance(value, list):
        return [_mask(item) for item in value]
    if isinstance(value, str) and value.startswith("http://127.0.0.1:"):
        return "<url>"
    return value


def _body(resp):
    try:
        return _mask(resp.json())
    except ValueError:
        return resp.text


def _call(url, method, path, **kwargs):
    """One request from a worker's side, never retried (the port's client
    for both routers: the wire is what is compared)."""
    return port_rpc.RpcClient().request(
        method, f"{url}{path}", endpoint="test/router", attempts=1,
        retry_statuses=(), use_circuit=False, **kwargs,
    )


def _script(pkg, tmp_path) -> list:
    """The scripted request sequence against one package's router and
    shards; returns ``(label, status, body, hops)`` in order."""
    out = []
    tmp_path.mkdir()
    map_path = str(tmp_path / "map.json")
    cluster = pkg.shard.ShardedCluster(
        3, lease_ttl=30.0, sweep_interval=3600.0, map_path=map_path,
        state_kwargs={"clock": _FrozenClock()},
    )
    v1 = cluster.start()
    routers = []
    conflict = _ConflictShard()

    def router(shard_map, **kwargs):
        r = pkg.router.Router(shard_map, **kwargs)
        r.start()
        routers.append(r)
        return r

    def record(label, resp, counting=None):
        out.append(
            (label, resp.status_code, _body(resp),
             None if counting is None else counting.hops())
        )

    try:
        t0, t1 = _tenant_for(v1, 0), _tenant_for(v1, 1)
        counting = _CountingClient(pkg.rpc.default_client())
        main = router(v1, map_path=map_path, client=counting,
                      circuit_cooldown=0.2, forward_deadline=2.0)
        # Forwarding: each tenant's hot path lands on its own shard.
        for key in (f"{t0}/j0", f"{t1}/j1"):
            cluster.create_job(key, {})
            record("register", _call(
                main.url, "PUT", f"/register/{key}/0/0",
                json={"address": "10.0.0.1:1", "processes": 1}))
            record("hints", _call(main.url, "PUT", f"/hints/{key}", json=HINTS))
            record("heartbeat", _call(
                main.url, "PUT", f"/heartbeat/{key}/0",
                json={"stepTimeEwma": 0.5}))
            record("get_hints", _call(main.url, "GET", f"/hints/{key}"))
            record("config", _call(main.url, "GET", f"/config/{key}"))
        out.append(("hops", counting.hops()))
        # Passthrough of a downstream status.
        record("missing", _call(main.url, "GET", f"/hints/{t0}/missing"))
        # A fault point turns into a 500.
        pkg.faults.configure("router.forward.pre=fail@1", seed=1234)
        record("fault", _call(main.url, "PUT", f"/heartbeat/{t0}/j0/0", json={}))
        pkg.faults.configure(None)
        # The merged /status, then a dead shard's error marker.
        record("status", _call(main.url, "GET", "/status"))
        cluster.kill_shard(2)
        record("status_dead", _call(main.url, "GET", "/status"))
        cluster.restart_shard(2)
        # Stale-map retry: the file holds a newer map than the router's
        # (whose shard 0 is a dead address).
        pkg.shard.ShardMap(dict(v1.shards), version=2).save(map_path)
        dead = pkg.shard.ShardMap(
            {**v1.shards, 0: "http://127.0.0.1:9"}, version=1
        )
        stale = router(dead, map_path=map_path, circuit_cooldown=0.2,
                       forward_deadline=1.0)
        # The failed forward reloads the map and answers 503 (the owner
        # did not change); the worker's retry lands on the new address.
        record("stale_first", _call(
            stale.url, "PUT", f"/heartbeat/{t0}/j0/0", json={}))
        record("stale_retry", _call(
            stale.url, "PUT", f"/heartbeat/{t0}/j0/0", json={}))
        out.append(("stale_version", stale.current_map().version))
        lone = router(dead, circuit_cooldown=0.2, forward_deadline=1.0)
        record("no_newer_map", _call(
            lone.url, "PUT", f"/heartbeat/{t0}/j0/0", json={}))
        # Double flip: t0 moves 0 -> 1 -> 2 while a router holds v2.
        v2 = pkg.shard.ShardMap.load(map_path)
        cluster.map = v2
        v3 = pkg.shard.migrate_tenant(v2, t0, 0, 1, map_path=map_path)
        v4 = pkg.shard.migrate_tenant(v3, t0, 1, 2, map_path=map_path)
        cluster.map = v4
        counting = _CountingClient(pkg.rpc.default_client())
        flipped = router(v2, map_path=map_path, client=counting)
        record("double_flip", _call(
            flipped.url, "PUT", f"/hints/{t0}/j0", json=HINTS), counting)
        out.append(("double_flip_version", flipped.current_map().version))
        # A moved 409 with no newer map to reload is the worker's to see.
        counting = _CountingClient(pkg.rpc.default_client())
        blind = router(v2, client=counting)
        record("moved_verbatim", _call(
            blind.url, "PUT", f"/hints/{t0}/j0", json=HINTS), counting)
        # A non-moved 409 passes through verbatim, in one hop.
        counting = _CountingClient(pkg.rpc.default_client())
        app = router(pkg.shard.ShardMap({0: conflict.url}), client=counting)
        record("conflict", _call(app.url, "PUT", f"/hints/{t0}/j0", json=HINTS),
               counting)
        record("shardmap", _call(flipped.url, "GET", "/shardmap"))
    finally:
        for r in routers:
            r.stop()
        cluster.stop()
        conflict.stop()
    return out


def test_router_sequence_equals_the_jax_router(tmp_path):
    jax_run = _script(PACKAGES["jax"], tmp_path / "jax")
    port_run = _script(PACKAGES["port"], tmp_path / "port")
    labels = [entry[0] for entry in port_run]
    assert labels == [entry[0] for entry in jax_run]
    for jax_entry, port_entry in zip(jax_run, port_run):
        assert port_entry == jax_entry, port_entry[0]
    # The contracts themselves, on the port's run.
    by_label = {}
    for entry in port_run:
        by_label.setdefault(entry[0], entry)
    assert by_label["missing"][1] == 404
    assert by_label["fault"][1] == 500
    assert by_label["status_dead"][2]["shards"]["2"]["error"] == "<error>"
    assert by_label["stale_first"][1] == 503
    assert by_label["stale_retry"][1] == 200
    assert by_label["stale_version"][1] == 2
    assert by_label["no_newer_map"][1] == 503
    assert by_label["double_flip"][1] == 200
    assert by_label["double_flip"][3] == ["router/shard0", "router/shard2"]
    assert by_label["moved_verbatim"][1] == 409
    assert by_label["moved_verbatim"][2]["error"] == "moved"
    assert by_label["moved_verbatim"][3] == ["router/shard0"]
    assert by_label["conflict"][1] == 409
    assert by_label["conflict"][2] == json.loads(_ConflictShard.BODY)
    assert by_label["conflict"][3] == ["router/shard0"]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_router_circuit_is_per_shard(tmp_path, name):
    """A dead shard opens its own circuit only: the sibling's requests
    through the same router keep succeeding, in either package."""
    pkg = PACKAGES[name]
    cluster = pkg.shard.ShardedCluster(2, lease_ttl=30.0, sweep_interval=3600.0)
    shard_map = cluster.start()
    router = pkg.router.Router(
        shard_map, circuit_cooldown=30.0, forward_attempts=1,
        forward_deadline=1.0,
    )
    router.start()
    try:
        live, dead = _tenant_for(shard_map, 0), _tenant_for(shard_map, 1)
        for key in (f"{live}/j", f"{dead}/j"):
            cluster.create_job(key, {})
        cluster.kill_shard(1)
        statuses = [
            _call(router.url, "PUT", f"/heartbeat/{dead}/j/0", json={}).status_code
            for _ in range(4)
        ]
        assert statuses == [503] * 4
        for _ in range(4):
            resp = _call(router.url, "PUT", f"/heartbeat/{live}/j/0", json={})
            assert resp.status_code == 200
    finally:
        router.stop()
        cluster.stop()
