"""Peer-to-peer state handoff for planned rescales, the port of
``adaptdl_tpu.handoff``.

A planned rescale stops the job (SIGTERM, final save, exit 143) and
starts its successor, which would read back from storage every byte the
stopping incarnation held a moment before. Here the stopping incarnation
leaves a small HTTP *shard server* behind that holds the final save's
bytes, and the successor pulls its states from it, each chunk checked
against its sha256. Any failure (the peer gone, a timeout, a hash
mismatch, an injected fault) makes :func:`try_restore` return False, and
``checkpoint.load_state`` reads the durable checkpoint: the served bytes
are the final save's, so both sources hold one version.

Server side (the stopping incarnation):

- :func:`collect_chunks` splits every registered state into chunks: one
  per tensor for a state that implements ``snapshot_chunks`` (the
  trainer's), one opaque ``__payload__`` for the rest;
- :class:`HandoffServer` serves ``GET /manifest`` (chunk order, sha256
  and size of each), ``GET /chunk/{state}/{chunk}`` and ``POST /done``
  (one successor rank is finished) on the standard library's
  ``ThreadingHTTPServer``;
- :func:`spawn_server` starts the server as a detached child, ``python
  -m adaptdl_tpu_torch.handoff``, which reads the chunks from its stdin
  and holds only host bytes (it imports no torch and never touches the
  card). It survives its parent's exit 143, writes a descriptor beside
  the checkpoints, advertises itself to the supervisor (``PUT
  /handoff/{job}``), and exits after ``/done`` or ``ADAPTDL_HANDOFF_TTL_S``.

Client side (the successor): discovery goes ``set_source`` /
``ADAPTDL_HANDOFF_URL``, then the supervisor (``GET /handoff/{job}``),
then the descriptor; the last two must name this incarnation's
immediate predecessor. Fetches share one deadline
(``ADAPTDL_HANDOFF_TIMEOUT_S``). The seconds and bytes moved feed
``metrics.record_handoff``. Each successor rank posts ``/done`` (with
its rank and the successor's replica count) once it is finished with the
peer, restored or not, and the server stops when every rank has.

A warm successor (``sched/warmup.py``) pulls the incumbent's chunks
into a warm cache before its final drain (:func:`warm_prefetch`); the
restore then reuses every cached chunk whose sha256 still matches the
final manifest and fetches only the rest (the differential pull,
``ADAPTDL_HANDOFF_DIFF``; ``fetch_stats()["reused"]`` counts its bytes).

The JAX module's row-part range pulls serve resharding successors; the
port's data-parallel state is whole on every rank, and they are not
part of it.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from adaptdl_tpu_torch import env, faults, rpc, trace

LOG = logging.getLogger(__name__)

# The chunk id of a state served whole.
RAW_CHUNK = "__payload__"
DESCRIPTOR_NAME = ".handoff.json"
# Concurrent chunk fetches of the successor.
_FETCH_THREADS = 4


def chunk_sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _descriptor_path(root: str | None = None) -> str | None:
    root = root if root is not None else env.checkpoint_path()
    return os.path.join(root, DESCRIPTOR_NAME) if root else None


# ---- server side -------------------------------------------------------


def collect_chunks(states=None, snapshots=None) -> dict[str, dict]:
    """``{name: {"order": [ids], "chunks": {id: bytes}}}`` for every
    registered state. ``snapshots`` ({name: snapshot}, a
    ``retain_snapshots`` save's) reuses the host copies the durable write
    serialized, so both hold the same bytes."""
    # Imported here and in try_restore, not at the top: the spawned
    # server imports this module and must not load torch.
    from adaptdl_tpu_torch import checkpoint

    if states is None:
        states = list(checkpoint._registry.values())
    payload: dict[str, dict] = {}
    for state in states:
        if snapshots is not None and state.name in snapshots:
            snap = snapshots[state.name]
        else:
            snap = state.snapshot()
        chunks = state.snapshot_chunks(snap)
        if chunks is None:
            buf = io.BytesIO()
            state.write_snapshot(snap, buf)
            chunks = [(RAW_CHUNK, buf.getvalue())]
        payload[state.name] = {
            "order": [cid for cid, _ in chunks],
            "chunks": dict(chunks),
        }
    return payload


class _Handler(BaseHTTPRequestHandler):
    server: "_Server"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        LOG.debug("handoff server: " + format, *args)

    def _reply(self, status: int, body: bytes, kind: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", kind)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, obj) -> None:
        self._reply(status, json.dumps(obj).encode(), "application/json")

    def _serve(self, method: str, request: bytes = b"") -> None:
        try:
            faults.maybe_fail("handoff.serve")
            status, body = self.server.owner.handle(method, self.path, request)
        except faults.InjectedFault as exc:
            status, body = 500, {"error": str(exc)}
        if isinstance(body, bytes):
            self._reply(status, body, "application/octet-stream")
        else:
            self._json(status, body)

    def do_GET(self):  # noqa: N802 - stdlib name
        self._serve("GET")

    def do_POST(self):  # noqa: N802 - stdlib name
        length = int(self.headers.get("Content-Length") or 0)
        self._serve("POST", self.rfile.read(length) if length else b"")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    owner: "HandoffServer"


class HandoffServer:
    """A stopping incarnation's chunks behind three endpoints, on a
    thread. The chunks' sha256 table is computed here, in the server (the
    spawned child, off the stopping incarnation's exit path). The payload
    is complete before :meth:`start` and never changes, so handlers read
    it without locks; only the ``/done`` tally takes one."""

    def __init__(
        self, payload: dict[str, dict], group: int | None = None,
        host: str = "127.0.0.1", port: int = 0,
    ):
        for entry in payload.values():
            entry["sha"] = {
                cid: chunk_sha(data) for cid, data in entry["chunks"].items()
            }
        self._payload = payload
        self.group = env.num_restarts() if group is None else int(group)
        self.done = threading.Event()
        self._done_lock = threading.Lock()
        self._done_ranks: set[int] = set()  # guarded-by: _done_lock
        self._httpd = _Server((host, port), _Handler)
        self._httpd.owner = self
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        host = "127.0.0.1" if host in ("0.0.0.0", "") else host
        return f"http://{host}:{self.port}"

    def handle(self, method: str, path: str, body: bytes = b""):
        parts = [urllib.parse.unquote(p) for p in path.split("?")[0].split("/")[1:]]
        if method == "GET" and parts == ["manifest"]:
            return 200, {
                "group": self.group,
                "states": {
                    name: {
                        "order": entry["order"],
                        "sha": entry["sha"],
                        "bytes": {
                            cid: len(entry["chunks"][cid])
                            for cid in entry["order"]
                        },
                    }
                    for name, entry in self._payload.items()
                },
            }
        if method == "GET" and len(parts) == 3 and parts[0] == "chunk":
            entry = self._payload.get(parts[1])
            data = None if entry is None else entry["chunks"].get(parts[2])
            if data is None:
                return 404, {"error": "no such chunk"}
            return 200, data
        if method == "POST" and parts == ["done"]:
            self._note_done(body)
            return 200, {"ok": True}
        return 404, {"error": "no such route"}

    def _note_done(self, body: bytes) -> None:
        """One successor rank is finished with this server; it is done
        once every rank of the successor is. A post that names no rank
        (the JAX client's, one per host) speaks for the whole successor."""
        try:
            info = json.loads(body or b"{}")
            rank, replicas = int(info["rank"]), int(info["replicas"])
        except (ValueError, KeyError, TypeError):
            self.done.set()
            return
        with self._done_lock:
            self._done_ranks.add(rank)
            if len(self._done_ranks) >= replicas:
                self.done.set()

    def start(self) -> str:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="adaptdl-torch-handoff",
            daemon=True,
        )
        self._thread.start()
        return self.url

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)


def serve_states(group: int | None = None, states=None) -> HandoffServer:
    """Collect the registered states and serve them in this process
    (tests; the spawned child builds on the same server)."""
    server = HandoffServer(collect_chunks(states), group=group)
    server.start()
    return server


def _routable_address() -> str:
    """The address a successor on another host reaches this one at:
    ``ADAPTDL_POD_IP``, else the host name's address, else loopback."""
    address = os.environ.get("ADAPTDL_POD_IP")
    if address:
        return address
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _advertise(url: str, group: int) -> None:
    """The descriptor beside the checkpoints and the supervisor's ``PUT
    /handoff/{job}``, each best effort."""
    descriptor = _descriptor_path()
    if descriptor:
        try:
            tmp = descriptor + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {"url": url, "group": group, "pid": os.getpid(),
                     "ts": time.time()}, f,
                )
            os.replace(tmp, descriptor)
        except OSError:
            LOG.warning("could not write the handoff descriptor", exc_info=True)
    sup, job = env.supervisor_url(), env.job_id()
    if sup and job:
        try:
            rpc.default_client().put(
                f"{sup}/handoff/{job}",
                endpoint=f"handoff/{job}",
                json={"url": url, "group": group},
                timeout=(2, 5),
                attempts=2,
                deadline=5.0,
                use_circuit=False,
            ).raise_for_status()
        except Exception:  # noqa: BLE001 - advertisement is best effort
            LOG.warning("could not advertise the handoff", exc_info=True)


def _withdraw_descriptor() -> None:
    """Remove the descriptor if it still names this server: a later
    incarnation's server may have replaced it."""
    descriptor = _descriptor_path()
    if descriptor:
        try:
            with open(descriptor, encoding="utf-8") as f:
                if json.load(f).get("pid") != os.getpid():
                    return
            os.remove(descriptor)
        except (OSError, ValueError, AttributeError):
            pass


def spawn_server(states=None, snapshots=None) -> subprocess.Popen | None:
    """Start the shard server as a detached child that outlives this
    process's exit 143, holding one serialized copy of the registered
    states (``snapshots`` reuses a retained save's host copies). Rank 0
    only; returns the child (nobody need wait for it) or None when the
    handoff is off, this is not rank 0, or nothing could be collected."""
    if not env.handoff_enabled() or env.replica_rank() != 0:
        return None
    with trace.span("handoff.spawn") as attrs:
        proc = _spawn(states, snapshots)
        attrs["spawned"] = proc is not None
    return proc


def _spawn(states, snapshots) -> subprocess.Popen | None:
    try:
        payload = collect_chunks(states, snapshots=snapshots)
    except Exception:  # noqa: BLE001 - the handoff is an optimization
        LOG.warning("handoff snapshot failed; the successor reads storage",
                    exc_info=True)
        return None
    if not payload:
        return None
    package_root = str(Path(__file__).resolve().parents[1])
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (package_root, child_env.get("PYTHONPATH")) if p
    )
    try:
        proc = subprocess.Popen(  # detached: the handoff shard server
            [sys.executable, "-m", "adaptdl_tpu_torch.handoff"],
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,
            env=child_env,
        )
        pickle.dump(
            {"group": env.num_restarts(), "states": payload}, proc.stdin,
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        proc.stdin.close()
    except Exception:  # noqa: BLE001 - the handoff is an optimization
        LOG.warning("could not spawn the handoff server", exc_info=True)
        return None
    LOG.info("handoff shard server spawned (pid %d, %d states)",
             proc.pid, len(payload))
    return proc


def _serve_main() -> int:
    """The spawned child: read the chunks, serve, advertise, and wait for
    ``/done`` or the TTL. With a supervisor (the successor may start on
    another host) it binds every interface and advertises this host's
    address; without one it stays on loopback."""
    payload = pickle.load(sys.stdin.buffer)
    cluster = bool(env.supervisor_url())
    server = HandoffServer(
        payload["states"], group=int(payload["group"]),
        host="0.0.0.0" if cluster else "127.0.0.1",
    )
    server.start()
    url = f"http://{_routable_address()}:{server.port}" if cluster else server.url
    _advertise(url, server.group)
    try:
        server.done.wait(env.handoff_ttl_s())
        if server.done.is_set():
            time.sleep(0.2)  # chunk fetches racing the /done post
    finally:
        _withdraw_descriptor()
        server.stop()
    return 0


# ---- client side -------------------------------------------------------

# Discovery and the manifest may race between the restore path and
# bootstrap's prefetch thread: both go through _ensure_manifest.
_manifest_lock = threading.Lock()
_source_url: str | None = None  # guarded-by: _manifest_lock
_manifest: dict | None = None  # guarded-by: _manifest_lock
_manifest_url: str | None = None  # guarded-by: _manifest_lock
_unavailable = False  # guarded-by: _manifest_lock (sticky)
_fetch_stats = {"bytes": 0, "seconds": 0.0, "reused": 0}
_states_applied: set[str] = set()
# The warm successor's chunk cache, ``{state: {chunk_id: (sha, bytes)}}``,
# filled by warm_prefetch before the incumbent's final drain. A cached
# chunk is reused only while its sha matches the final manifest, so a
# stale cache degrades to the full pull with the same bytes.
_warm_cache: dict[str, dict[str, tuple[str, bytes]]] = {}  # guarded-by: _manifest_lock


def _reset_client_state() -> None:
    """Forget the manifest, the sticky verdict and the warm cache
    (tests)."""
    global _source_url, _manifest, _manifest_url, _unavailable
    with _manifest_lock:
        _source_url = None
        _manifest = None
        _manifest_url = None
        _unavailable = False
        _warm_cache.clear()
    _fetch_stats.update(bytes=0, seconds=0.0, reused=0)
    _states_applied.clear()


def fetch_stats() -> dict:
    """Bytes fetched, seconds spent and bytes reused from the warm cache
    by this process's handoff so far."""
    return dict(_fetch_stats)


def _warm_chunks(name: str, sha_table: dict) -> dict[str, bytes]:
    """The warm-cache chunks of ``name`` whose sha256 still matches the
    authoritative manifest's: exactly the chunks a differential pull
    may skip. Empty with ``ADAPTDL_HANDOFF_DIFF`` off or nothing
    cached."""
    if not env.handoff_diff_enabled():
        return {}
    with _manifest_lock:
        cached = _warm_cache.get(name)
        if not cached:
            return {}
        return {
            cid: data
            for cid, (sha, data) in cached.items()
            if sha is not None and sha == sha_table.get(cid)
        }


def set_source(url: str | None) -> None:
    """Point the restore path at a known shard server (tests)."""
    global _source_url, _unavailable
    with _manifest_lock:
        _source_url = url
        _unavailable = False


def _advertised_group(body) -> int | None:
    try:
        return int(body.get("group"))
    except (TypeError, ValueError, AttributeError):
        return None


def discover_url() -> str | None:
    """The predecessor's shard server: ``set_source`` or
    ``ADAPTDL_HANDOFF_URL``, else the supervisor's advertisement, else
    the descriptor file. The last two must name exactly the immediate
    predecessor (group ``num_restarts - 1``): an older server's state
    may predate newer durable checkpoints."""
    with _manifest_lock:
        if _source_url:
            return _source_url
    if not env.handoff_enabled():
        return None
    if env.handoff_url():
        return env.handoff_url()
    predecessor = env.num_restarts() - 1
    sup, job = env.supervisor_url(), env.job_id()
    if sup and job:
        try:
            response = rpc.default_client().get(
                f"{sup}/handoff/{job}",
                endpoint=f"handoff/{job}",
                timeout=(2, 5),
                attempts=2,
                deadline=5.0,
                use_circuit=False,
            )
            body = response.json() if response.status_code == 200 else None
            if (
                isinstance(body, dict) and body.get("url")
                and _advertised_group(body) == predecessor
            ):
                return body["url"]
        except Exception:  # noqa: BLE001 - discovery is best effort
            LOG.debug("supervisor handoff discovery failed", exc_info=True)
    descriptor = _descriptor_path()
    if descriptor and os.path.isfile(descriptor):
        try:
            with open(descriptor, encoding="utf-8") as f:
                body = json.load(f)
            if (
                isinstance(body, dict) and body.get("url")
                and _advertised_group(body) == predecessor
            ):
                return body["url"]
        except (OSError, ValueError):
            LOG.debug("unreadable handoff descriptor", exc_info=True)
    return None


def _fetch_manifest(url: str, deadline_s: float) -> dict | None:
    response = rpc.default_client().get(
        f"{url}/manifest",
        endpoint="handoff/manifest",
        timeout=(2, deadline_s),
        attempts=2,
        deadline=deadline_s,
        use_circuit=False,
    )
    if response.status_code != 200:
        return None
    states = response.json().get("states")
    return states if isinstance(states, dict) else None


def _ensure_manifest() -> tuple[dict, str] | None:
    """Discover the peer and fetch its manifest, once; None (sticky)
    when there is no peer or it did not answer."""
    global _manifest, _manifest_url, _unavailable
    with _manifest_lock:
        if _unavailable:
            return None
        if _manifest is not None:
            return _manifest, _manifest_url
    url = discover_url()
    if url is None:
        with _manifest_lock:
            _unavailable = True
        return None
    t0 = time.monotonic()
    try:
        fetched = _fetch_manifest(url, env.handoff_timeout_s())
    except Exception:  # noqa: BLE001 - the peer is gone: storage
        LOG.info("handoff peer at %s unreachable; reading storage", url)
        fetched = None
    with _manifest_lock:
        if fetched is None:
            _unavailable = True
            return None
        if _manifest is None:
            _manifest, _manifest_url = fetched, url
            _fetch_stats["seconds"] += time.monotonic() - t0
        return _manifest, _manifest_url


def _fetch_chunk(url: str, name: str, chunk_id: str, deadline: float) -> bytes:
    remaining = deadline - time.monotonic()
    if remaining <= 0:
        raise TimeoutError("handoff fetch deadline exceeded")
    faults.maybe_fail("handoff.fetch")
    response = rpc.default_client().get(
        f"{url}/chunk/{urllib.parse.quote(name, safe='')}/"
        f"{urllib.parse.quote(chunk_id, safe='')}",
        endpoint=f"handoff/chunk/{name}",
        timeout=(2, max(remaining, 0.1)),
        attempts=2,
        deadline=remaining,
        use_circuit=False,
        traced=False,
    )
    if response.status_code != 200:
        raise RuntimeError(
            f"handoff chunk {name}/{chunk_id} returned {response.status_code}"
        )
    return response.content


def _fetch_state_chunks(
    url: str, name: str, entry: dict, deadline: float
) -> tuple[list[tuple[str, bytes]], int, int]:
    """One state's chunks in order, each checked against the manifest's
    sha256; returns ``(chunks, fetched_bytes, reused_bytes)``. A chunk
    whose sha sits in the warm cache is reused (the differential pull);
    the rest are fetched and hashed on ``_FETCH_THREADS`` threads
    (socket reads and sha256 release the interpreter lock). Raises on
    any failure."""
    sha_table = entry.get("sha") or {}
    cached = _warm_chunks(name, sha_table)

    def fetch(cid: str) -> tuple[str, bytes]:
        if cid in cached:
            return cid, cached[cid]
        data = _fetch_chunk(url, name, cid, deadline)
        if chunk_sha(data) != sha_table.get(cid):
            raise ValueError(f"handoff chunk {name}/{cid} failed sha256")
        return cid, data

    with ThreadPoolExecutor(
        max_workers=_FETCH_THREADS, thread_name_prefix="adaptdl-torch-handoff"
    ) as pool:
        chunks = list(pool.map(fetch, entry["order"]))
    reused = sum(len(data) for cid, data in chunks if cid in cached)
    return chunks, sum(len(data) for _, data in chunks) - reused, reused


def _signal_done(url: str) -> None:
    """Tell the server this rank is finished with it."""
    try:
        rpc.default_client().post(
            f"{url}/done", endpoint="handoff/done", timeout=(2, 2),
            json={"rank": env.replica_rank(), "replicas": env.num_replicas()},
            attempts=1, use_circuit=False,
        )
    except Exception:  # noqa: BLE001 - a courtesy: the TTL ends it anyway
        pass


def prefetch() -> bool:
    """Discover the peer and fetch its manifest ahead of the restore
    (bootstrap's side thread). Best effort."""
    return _ensure_manifest() is not None


def warm_prefetch(url: str | None = None) -> int:
    """A warm successor's chunk prefetch: pull the peer's current
    manifest and every chunk it lists into the warm cache, so that the
    restore after the cutover fetches only the chunks that changed
    before the incumbent's final drain. It leaves the restore path's
    manifest and its sticky verdict alone: the cached chunks are
    provisional (the restore fetches the authoritative manifest and
    reuses a chunk only on a sha match), and a failed speculation must
    not spoil the real restore. Returns the bytes cached; best effort,
    any failure keeps what was cached so far."""
    if url is None:
        url = discover_url()
    if url is None:
        return 0
    total = 0
    try:
        faults.maybe_fail("warmup.prefetch")
        with trace.span("warmup.prefetch") as attrs:
            manifest = _fetch_manifest(url, env.handoff_timeout_s())
            if manifest is None:
                return 0
            deadline = time.monotonic() + env.handoff_timeout_s()
            for name, entry in manifest.items():
                chunks, nbytes, reused = _fetch_state_chunks(
                    url, name, entry, deadline
                )
                sha_table = entry.get("sha") or {}
                with _manifest_lock:
                    _warm_cache[name] = {
                        cid: (sha_table.get(cid), data) for cid, data in chunks
                    }
                total += nbytes + reused
            attrs["bytes"] = total
            attrs["states"] = len(manifest)
    except Exception:  # noqa: BLE001 - speculation is best effort
        LOG.debug("warm prefetch from %s failed", url, exc_info=True)
    return total


def mark_unavailable() -> None:
    """Serve no further restores from the peer (storage proved corrupt
    and the states are being reconciled from storage)."""
    global _unavailable
    with _manifest_lock:
        _unavailable = True


def try_restore(state) -> bool:
    """Restore one state from the predecessor's shard server; False when
    there is no peer, the peer lacks the state, or anything fails (one
    failure makes the peer unavailable for the rest of the process, and
    this rank posts ``/done``). ``checkpoint.load_state`` then reads
    storage."""
    global _unavailable
    found = _ensure_manifest()
    if found is None:
        return False
    manifest, url = found
    entry = manifest.get(state.name)
    if entry is None:
        return False
    deadline = time.monotonic() + env.handoff_timeout_s()
    t0 = time.monotonic()
    try:
        with trace.span("handoff.fetch", state=state.name) as attrs:
            chunks, nbytes, reused = _fetch_state_chunks(
                url, state.name, entry, deadline
            )
            attrs["bytes"] = nbytes
            attrs["reused"] = reused
            with trace.span("handoff.restore", state=state.name):
                if [cid for cid, _ in chunks] == [RAW_CHUNK]:
                    state.load(io.BytesIO(chunks[0][1]))
                else:
                    state.load_chunks(chunks)
    except Exception:  # noqa: BLE001 - any failure: storage
        LOG.warning(
            "handoff fetch failed for state %r; reading the durable "
            "checkpoint", state.name, exc_info=True,
        )
        with _manifest_lock:
            _unavailable = True
        _signal_done(url)
        return False
    elapsed = time.monotonic() - t0
    _fetch_stats["bytes"] += nbytes
    _fetch_stats["reused"] += reused
    _fetch_stats["seconds"] += elapsed
    _states_applied.add(state.name)
    from adaptdl_tpu_torch import metrics

    metrics.record_handoff(_fetch_stats["seconds"], _fetch_stats["bytes"])
    metrics.record_checkpoint_restore(state.name, elapsed)
    if _states_applied >= set(manifest):
        _signal_done(url)
    return True


if __name__ == "__main__":
    sys.exit(_serve_main())
