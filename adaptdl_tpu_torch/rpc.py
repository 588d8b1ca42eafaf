"""Resilient HTTP client for the job <-> supervisor control plane.

The port of ``adaptdl_tpu.rpc``, built on the standard library's
``urllib.request`` (the JAX package's client uses ``requests``, which
the port does not depend on). Every call to the supervisor goes
through it and gets:

- **retries with exponential backoff and jitter** on transport errors
  and retryable HTTP statuses (5xx, 408, 429), never on other 4xx;
- **a deadline** over all attempts;
- **a per-endpoint circuit breaker**: after ``circuit_threshold``
  consecutive failed calls the endpoint is skipped for
  ``circuit_cooldown`` seconds (one probe is admitted when the cooldown
  lapses), so a dead supervisor costs each best-effort caller one cheap
  :class:`CircuitOpenError` per cadence;
- **fault-injection points** ``rpc.request.send`` and
  ``rpc.response.recv``;
- **a trace span** ``rpc.request`` per call, whose context rides the
  ``traceparent`` header (``traced=False`` opts out: the trace flush).

``urllib`` takes one timeout per attempt where ``requests`` takes a
(connect, read) pair: a pair is given as its larger member. Proxy
settings in the environment are ignored, so a call goes only to the
URL it names. A call returns a :class:`Response` with ``status_code``,
``json()`` and ``raise_for_status()``.
"""

from __future__ import annotations

import http.client
import json as json_lib
import logging
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from adaptdl_tpu_torch import faults, trace

LOG = logging.getLogger(__name__)

# HTTP statuses worth retrying: transient server states, not client
# errors (a 404 job or 400 payload will not improve with retries).
RETRY_STATUSES = (408, 429, 500, 502, 503, 504)

_DEFAULT_TIMEOUT = (2.0, 10.0)  # (connect, read) seconds per attempt
# Exponential backoff between attempts: the first delay, then its cap.
_BACKOFF = 0.1
_MAX_BACKOFF = 5.0

# No ProxyHandler entries: requests go straight to the supervisor.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class RpcError(RuntimeError):
    """All attempts failed (transport error or retryable status)."""

    def __init__(self, message: str, response=None):
        super().__init__(message)
        self.response = response  # last response, when one arrived


class CircuitOpenError(RpcError):
    """The endpoint's circuit is open; no attempt was made."""


class HTTPStatusError(RuntimeError):
    """``raise_for_status`` on a 4xx or 5xx response."""

    def __init__(self, message: str, response: "Response"):
        super().__init__(message)
        self.response = response


class Response:
    """What one HTTP attempt returned: the status, the body and the
    headers."""

    def __init__(
        self, status_code: int, content: bytes, url: str, headers=None
    ):
        self.status_code = status_code
        self.content = content
        self.url = url
        self.headers = dict(headers or {})

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return json_lib.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPStatusError(
                f"{self.status_code} for {self.url}: {self.text[:200]}",
                response=self,
            )


def _timeout_seconds(timeout) -> float:
    if isinstance(timeout, (tuple, list)):
        return float(max(timeout))
    return float(timeout)


def _send(method, url, params, json, timeout, headers=None) -> Response:
    """One HTTP attempt. An HTTP error status is a response, not an
    exception; transport failures raise ``OSError`` or
    ``http.client.HTTPException``."""
    if params:
        query = urllib.parse.urlencode(params)
        url = f"{url}{'&' if '?' in url else '?'}{query}"
    data, headers = None, dict(headers or {})
    if json is not None:
        data = json_lib.dumps(json).encode("utf-8")
        headers["Content-Type"] = "application/json"
    request = urllib.request.Request(
        url, data=data, headers=headers, method=method
    )
    try:
        with _OPENER.open(request, timeout=_timeout_seconds(timeout)) as r:
            return Response(r.status, r.read(), url, r.headers.items())
    except urllib.error.HTTPError as exc:
        try:
            body = exc.read() if exc.fp is not None else b""
        finally:
            exc.close()
        headers = exc.headers.items() if exc.headers is not None else ()
        return Response(exc.code, body, url, headers)


class _Circuit:
    """Consecutive-failure breaker for one endpoint. All fields are
    read and written under RpcClient._lock."""

    __slots__ = ("failures", "open_until", "threshold", "cooldown")

    def __init__(self, threshold: int, cooldown: float):
        self.failures = 0
        self.open_until = 0.0
        self.threshold = threshold
        self.cooldown = cooldown


class RpcClient:
    """Thread-safe resilient HTTP client with per-endpoint circuits.

    One process-wide instance (:func:`default_client`) is shared by the
    training thread, the metrics fit thread and the heartbeat thread.
    """

    def __init__(self, sleep=time.sleep):
        self._sleep = sleep
        self._lock = threading.Lock()
        self._circuits: dict[str, _Circuit] = {}  # guarded-by: _lock
        # Jitter only smears retries; it is not part of the fault
        # schedule, so a plain PRNG is fine.
        self._jitter = random.Random()

    # -- circuit breaker ----------------------------------------------

    def _check_circuit(
        self, endpoint: str, threshold: int, cooldown: float
    ) -> None:
        now = time.monotonic()
        with self._lock:
            circuit = self._circuits.get(endpoint)
            if circuit is None:
                circuit = _Circuit(threshold, cooldown)
                self._circuits[endpoint] = circuit
            circuit.threshold = threshold
            circuit.cooldown = cooldown
            if circuit.failures < circuit.threshold:
                return
            if now >= circuit.open_until:
                # Half-open: admit this call as the probe; a failure
                # re-opens the circuit, a success closes it.
                circuit.open_until = now + circuit.cooldown
                return
            raise CircuitOpenError(
                f"circuit open for {endpoint!r} "
                f"({circuit.failures} consecutive failures; retry in "
                f"{circuit.open_until - now:.1f}s)"
            )

    def _record(self, endpoint: str, ok: bool) -> None:
        now = time.monotonic()
        with self._lock:
            circuit = self._circuits.get(endpoint)
            if circuit is None:  # pragma: no cover - checked first
                return
            if ok:
                circuit.failures = 0
                circuit.open_until = 0.0
            else:
                circuit.failures += 1
                if circuit.failures >= circuit.threshold:
                    circuit.open_until = now + circuit.cooldown
                    LOG.warning(
                        "rpc circuit OPEN for %r (%d consecutive "
                        "failures, cooldown %.1fs)",
                        endpoint, circuit.failures, circuit.cooldown,
                    )

    def circuit_state(self, endpoint: str) -> tuple[int, float]:
        """(consecutive failures, seconds of cooldown remaining)."""
        now = time.monotonic()
        with self._lock:
            circuit = self._circuits.get(endpoint)
            if circuit is None:
                return 0, 0.0
            return circuit.failures, max(circuit.open_until - now, 0.0)

    def reset(self) -> None:
        """Drop all circuit state (tests)."""
        with self._lock:
            self._circuits.clear()

    # -- request ------------------------------------------------------

    def request(
        self,
        method: str,
        url: str,
        *,
        endpoint: str | None = None,
        params=None,
        json=None,
        headers=None,
        timeout=_DEFAULT_TIMEOUT,
        attempts: int = 3,
        deadline: float | None = None,
        retry_statuses: tuple[int, ...] = RETRY_STATUSES,
        circuit_threshold: int = 3,
        circuit_cooldown: float = 60.0,
        use_circuit: bool = True,
        traced: bool = True,
    ) -> Response:
        """Make one logical RPC and return its :class:`Response`.

        Retries transport errors and ``retry_statuses`` up to
        ``attempts`` times within ``deadline`` seconds overall;
        ``endpoint`` (default: method and URL) keys the circuit breaker
        (``use_circuit=False`` bypasses it). Raises
        :class:`CircuitOpenError` without touching the network when the
        endpoint's circuit is open, :class:`RpcError` when every attempt
        failed. Other HTTP statuses are returned (use
        ``raise_for_status``) and count as circuit successes: the
        endpoint answered. ``traced=False`` records no span and sends no
        ``traceparent`` header.
        """
        key = endpoint if endpoint is not None else f"{method} {url}"
        args = (method, url, key, params, json, timeout, attempts, deadline,
                retry_statuses, circuit_threshold, circuit_cooldown,
                use_circuit)
        if not traced:
            return self._attempts(*args, headers=headers)
        with trace.span("rpc.request", endpoint=key, method=method) as attrs:
            headers = dict(headers or {})
            headers.setdefault("traceparent", trace.current_traceparent())
            response = self._attempts(*args, headers=headers, attrs=attrs)
            attrs["status"] = response.status_code
            return response

    def _attempts(
        self, method, url, key, params, json, timeout, attempts, deadline,
        retry_statuses, circuit_threshold, circuit_cooldown, use_circuit,
        headers=None, attrs=None,
    ) -> Response:
        if use_circuit:
            self._check_circuit(key, circuit_threshold, circuit_cooldown)
        overall = (
            time.monotonic() + deadline if deadline is not None else None
        )
        last_error: Exception | None = None
        last_response = None
        tries = 0
        for attempt in range(max(attempts, 1)):
            if overall is not None and time.monotonic() >= overall:
                break
            tries = attempt + 1
            if attrs is not None and attempt > 0:
                trace.event("rpc.retry", endpoint=key)
            try:
                faults.maybe_fail("rpc.request.send")
                response = _send(method, url, params, json, timeout, headers)
                faults.maybe_fail("rpc.response.recv")
            except (
                OSError, http.client.HTTPException, faults.InjectedFault,
            ) as exc:
                last_error = exc
                LOG.debug(
                    "rpc %s %s attempt %d/%d failed: %s",
                    method, url, attempt + 1, attempts, exc,
                )
            else:
                if response.status_code not in retry_statuses:
                    if use_circuit:
                        self._record(key, ok=True)
                    if attrs is not None:
                        attrs["attempts"] = tries
                    return response
                last_response = response
                last_error = None
                LOG.debug(
                    "rpc %s %s attempt %d/%d got retryable status %d",
                    method, url, attempt + 1, attempts,
                    response.status_code,
                )
            if attempt + 1 >= attempts:
                break
            delay = min(_BACKOFF * (2 ** attempt), _MAX_BACKOFF)
            delay *= 0.5 + self._jitter.random() / 2.0
            if overall is not None:
                delay = min(delay, max(overall - time.monotonic(), 0.0))
            if delay > 0:
                self._sleep(delay)
        if use_circuit:
            self._record(key, ok=False)
        if attrs is not None:
            attrs["attempts"] = tries
        if last_response is not None:
            raise RpcError(
                f"{method} {url} failed with status "
                f"{last_response.status_code} after {attempts} attempt(s)",
                response=last_response,
            )
        raise RpcError(
            f"{method} {url} failed after {attempts} attempt(s): "
            f"{last_error}"
        ) from last_error

    def get(self, url: str, **kwargs) -> Response:
        return self.request("GET", url, **kwargs)

    def put(self, url: str, **kwargs) -> Response:
        return self.request("PUT", url, **kwargs)

    def post(self, url: str, **kwargs) -> Response:
        return self.request("POST", url, **kwargs)


_default_lock = threading.Lock()
_default: RpcClient | None = None  # guarded-by: _default_lock


def default_client() -> RpcClient:
    """The process-wide client, created on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = RpcClient()
        return _default


def reset_default_client() -> None:
    """Drop the shared client and its circuit state (tests)."""
    global _default
    with _default_lock:
        _default = None
