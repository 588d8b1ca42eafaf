"""Rescale tracing, the job side of ``adaptdl_tpu.trace``.

- **Spans**: ``with trace.span("ckpt.snapshot"): ...`` records a
  monotonic duration, a wall-clock start (to align processes), parent
  and child ids per thread, and attributes. ``event`` records a point.
- **Trace context**: W3C ``traceparent`` (``00-<32hex>-<16hex>-01``).
  It rides the rpc client's request header and ``ADAPTDL_TRACEPARENT``
  across the restart, and ``/config`` replies carry the supervisor's,
  so one trace id stitches the stopping incarnation's final save, the
  supervisor's decision and the successor's restore and first step.
- **Ring buffer**: finished spans land in a deque of the newest
  ``BUFFER_SIZE``.
- **Journal**: with ``ADAPTDL_TRACE_DIR`` set, every finished span is
  appended to ``trace-<job>.jsonl`` there, one JSON object per line, so
  a killed incarnation's spans survive for the next one.
- **Flush**: :func:`flush_to_supervisor` PUTs the spans not yet sent to
  ``/trace/{job}`` (on the hint and heartbeat cadence).
  :func:`phase_summary` gives the median duration of each span name.
- **Registry**: every recorded span lands in a per-phase Prometheus
  histogram and every event bumps a counter; the supervisor
  :func:`absorb` s the spans its workers post, so its ``/metrics``
  (:class:`PromBuilder`, :func:`render_into`) covers both sides.
- **Renderers**: :func:`to_perfetto` (Chrome ``trace_event`` JSON) and
  :func:`render_waterfall` (the CLI's ASCII phase waterfall).
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import zlib
from bisect import bisect_left
from collections import deque
from contextlib import contextmanager

from adaptdl_tpu_torch import env

LOG = logging.getLogger(__name__)

_TRACEPARENT_VERSION = "00"
_SAMPLED_FLAGS = "01"

# Span and trace ids are identifiers, not secrets: a per-thread PRNG
# seeded from os.urandom, reseeded in a forked child (keyed by pid).
_rng_local = threading.local()


def _rand_hex(nbytes: int) -> str:
    state = getattr(_rng_local, "state", None)
    pid = os.getpid()
    if state is None or state[0] != pid:
        state = (pid, random.Random(int.from_bytes(os.urandom(16), "big")))
        _rng_local.state = state
    return "%0*x" % (nbytes * 2, state[1].getrandbits(nbytes * 8))


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-{_SAMPLED_FLAGS}"


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """(trace_id, span_id) of a W3C traceparent header, or None for
    anything malformed: a garbled inherited context starts a fresh
    trace instead of failing a restarting worker."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def new_traceparent() -> str:
    """A fresh trace context, not installed as this process's."""
    return format_traceparent(_rand_hex(16), _rand_hex(8))


# The process's root context: spans with no explicit traceparent and no
# enclosing span on their thread parent here. Taken lazily from
# ADAPTDL_TRACEPARENT.
_ctx_lock = threading.Lock()
_trace_id: str | None = None  # guarded-by: _ctx_lock
_root_span_id: str | None = None  # guarded-by: _ctx_lock


def init_from_env(force: bool = False) -> None:
    """Adopt ``ADAPTDL_TRACEPARENT`` as the root context, or mint one
    when it is unset or malformed. Idempotent unless ``force``."""
    global _trace_id, _root_span_id
    with _ctx_lock:
        if _trace_id is not None and not force:
            return
        parsed = parse_traceparent(env.traceparent())
        if parsed is not None:
            _trace_id, _root_span_id = parsed
        else:
            _trace_id, _root_span_id = _rand_hex(16), _rand_hex(8)


def set_traceparent(header: str | None) -> bool:
    """Adopt an explicit context (a ``/config`` reply's); False, and the
    context unchanged, on a malformed header."""
    global _trace_id, _root_span_id
    parsed = parse_traceparent(header)
    if parsed is None:
        return False
    with _ctx_lock:
        _trace_id, _root_span_id = parsed
    return True


def _root_context() -> tuple[str, str]:
    init_from_env()
    with _ctx_lock:
        return _trace_id, _root_span_id  # type: ignore[return-value]


def current_traceparent() -> str:
    """The context to propagate now: the innermost open span on this
    thread, else the root."""
    stack = getattr(_tls, "stack", None)
    if stack:
        return format_traceparent(stack[-1][0], stack[-1][1])
    return format_traceparent(*_root_context())


# The restart count, stamped on every record so a journal shared across
# restarts attributes each span to its incarnation.
_incarnation: int | None = None


def _inc() -> int:
    global _incarnation
    if _incarnation is None:
        _incarnation = env.num_restarts()
    return _incarnation


# Spans kept in memory for the supervisor flush (the journal keeps all).
BUFFER_SIZE = 4096
_tls = threading.local()  # per-thread stack of (trace_id, span_id)
_buffer_lock = threading.Lock()
_buffer: deque | None = None  # guarded-by: _buffer_lock
_seq = 0  # guarded-by: _buffer_lock
_flushed_seq = 0  # guarded-by: _buffer_lock


def _buffer_locked() -> deque:
    global _buffer
    if _buffer is None:
        _buffer = deque(maxlen=BUFFER_SIZE)
    return _buffer


def snapshot_spans() -> list[dict]:
    """A copy of the ring buffer's records."""
    with _buffer_lock:
        return list(_buffer_locked())


def _record(rec: dict) -> None:
    global _seq
    with _buffer_lock:
        _seq += 1
        rec["seq"] = _seq
        _buffer_locked().append(rec)
    _observe(rec)
    _journal_write(rec)


def _observe(rec: dict) -> None:
    """Fold one span record into the Prometheus registry: an event bumps
    its counter, a span its phase histogram."""
    if rec.get("kind") == "event":
        with _metrics_lock:
            _counters[rec["name"]] = _counters.get(rec["name"], 0) + 1
    else:
        observe_phase(rec["name"], float(rec.get("dur", 0.0)))


def absorb(records: list[dict]) -> None:
    """Observe span records posted by workers into this process's
    registry (the supervisor's ``PUT /trace``), without buffering or
    journaling them."""
    for rec in records:
        if isinstance(rec, dict) and "name" in rec:
            _observe(rec)


def _parent(traceparent: str | None) -> tuple[str, str]:
    parsed = parse_traceparent(traceparent) if traceparent else None
    if parsed is not None:
        return parsed
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return _root_context()


def _make(name, trace_id, parent_id, span_id, ts, dur, attrs, kind=None):
    rec = {
        "name": name,
        "trace": trace_id,
        "span": span_id,
        "parent": parent_id,
        "ts": ts,
        "dur": dur,
        "attrs": dict(attrs),
        "pid": os.getpid(),
        "tid": threading.current_thread().name,
        "inc": _inc(),
    }
    if kind is not None:
        rec["kind"] = kind
    return rec


@contextmanager
def span(name: str, traceparent: str | None = None, **attrs):
    """Record a span around the ``with`` body; yields a mutable attrs
    dict. ``traceparent`` pins it to an explicit context (a background
    write keeps its save's); else it nests under this thread's open
    span, else the root. An exception still records, flagged
    ``error``."""
    trace_id, parent_id = _parent(traceparent)
    span_id = _rand_hex(8)
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    _tls.stack.append((trace_id, span_id))
    wall = time.time()
    start = time.monotonic()
    try:
        yield attrs
    except BaseException:
        attrs["error"] = True
        raise
    finally:
        dur = time.monotonic() - start
        _tls.stack.pop()
        _record(_make(name, trace_id, parent_id, span_id, wall, dur, attrs))


def record_span(
    name: str,
    duration_s: float,
    traceparent: str | None = None,
    ts: float | None = None,
    **attrs,
) -> None:
    """Record an already measured span."""
    parsed = parse_traceparent(traceparent) if traceparent else None
    trace_id, parent_id = parsed if parsed is not None else _root_context()
    _record(_make(
        name, trace_id, parent_id, _rand_hex(8),
        time.time() - duration_s if ts is None else ts,
        max(float(duration_s), 0.0), attrs,
    ))


def event(name: str, traceparent: str | None = None, **attrs) -> None:
    """Record a zero-duration point."""
    trace_id, parent_id = _parent(traceparent)
    _record(_make(
        name, trace_id, parent_id, _rand_hex(8), time.time(), 0.0, attrs,
        kind="event",
    ))


# Spans whose end lives at another call site (bootstrap opens
# restart.first_step, the first profiled step closes it):
# name -> (wall start, monotonic start, attrs).
_pending_lock = threading.Lock()
_pending: dict[str, tuple[float, float, dict]] = {}  # guarded-by: _pending_lock


def begin_pending(name: str, **attrs) -> None:
    with _pending_lock:
        _pending[name] = (time.time(), time.monotonic(), dict(attrs))


def end_pending(name: str, **attrs) -> bool:
    """Close a :func:`begin_pending` span; False when none is open.
    Runs every step: an empty table is a lock-free return."""
    if not _pending:
        return False
    with _pending_lock:
        opened = _pending.pop(name, None)
    if opened is None:
        return False
    wall, start, open_attrs = opened
    open_attrs.update(attrs)
    record_span(name, time.monotonic() - start, ts=wall, **open_attrs)
    return True


_journal_lock = threading.Lock()
_journal_fh = None  # guarded-by: _journal_lock
_journal_target: str | None = None  # guarded-by: _journal_lock


def _sanitize(job: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "-" for c in job)


def journal_path() -> str | None:
    """This process's journal file, or None without ``ADAPTDL_TRACE_DIR``."""
    directory = env.trace_dir()
    if not directory:
        return None
    job = env.job_id() or f"proc-{os.getpid()}"
    return os.path.join(directory, f"trace-{_sanitize(job)}.jsonl")


def _journal_write(rec: dict) -> None:
    """Append one record (flushed per line, not fsynced: observability,
    not durability). A killed predecessor's torn last line is closed
    first. A write that fails is logged and dropped."""
    global _journal_fh, _journal_target
    path = journal_path()
    if path is None:
        return
    try:
        with _journal_lock:
            if _journal_fh is None or _journal_target != path:
                if _journal_fh is not None:
                    _journal_fh.close()
                os.makedirs(os.path.dirname(path), exist_ok=True)
                torn = False
                if os.path.exists(path) and os.path.getsize(path) > 0:
                    with open(path, "rb") as existing:
                        existing.seek(-1, os.SEEK_END)
                        torn = existing.read(1) != b"\n"
                _journal_fh = open(path, "a", encoding="utf-8")
                _journal_target = path
                if torn:
                    _journal_fh.write("\n")
            _journal_fh.write(json.dumps(rec, sort_keys=True) + "\n")
            _journal_fh.flush()
    except OSError:
        LOG.debug("trace journal append failed", exc_info=True)


def read_journal(path: str) -> list[dict]:
    """The records of a journal; torn lines are skipped."""
    records: list[dict] = []
    try:
        with open(path, "rb") as f:
            for raw in f:
                if not raw.endswith(b"\n"):
                    break
                try:
                    rec = json.loads(raw.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        return []
    return records


def _tid_int(name: str) -> int:
    """A stable small integer for a thread name (``trace_event`` wants
    numeric tids)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def to_perfetto(records: list[dict]) -> dict:
    """Chrome ``trace_event`` JSON (the object form): complete ("X")
    events for spans, instants ("i") for events, and process and thread
    name metadata; loads in ui.perfetto.dev and chrome://tracing."""
    events: list[dict] = []
    named: set[tuple[int, int]] = set()
    for rec in records:
        pid = int(rec.get("pid", 0))
        thread = str(rec.get("tid", "main"))
        tid = _tid_int(thread)
        if (pid, tid) not in named:
            named.add((pid, tid))
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": thread},
            })
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"pid {pid} (inc {rec.get('inc', 0)})"},
            })
        args = dict(rec.get("attrs") or {})
        args["trace_id"] = rec.get("trace", "")
        args["span_id"] = rec.get("span", "")
        base = {
            "name": rec["name"],
            "cat": "adaptdl",
            "pid": pid,
            "tid": tid,
            "ts": float(rec.get("ts", 0.0)) * 1e6,
            "args": args,
        }
        if rec.get("kind") == "event":
            base["ph"] = "i"
            base["s"] = "p"
        else:
            base["ph"] = "X"
            base["dur"] = max(float(rec.get("dur", 0.0)), 0.0) * 1e6
        events.append(base)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# Per-phase latency buckets: rpc attempts in the millisecond band,
# checkpoint, restore and build phases up to a minute.
_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
_RPC_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0,
)


def _buckets_for(phase: str) -> tuple[float, ...]:
    return _RPC_BUCKETS if phase.startswith("rpc.") else _DEFAULT_BUCKETS


class Histogram:
    """One Prometheus histogram series: per-bucket counts (the last is
    +Inf), sum and count. Mutated under the registry lock."""

    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.count = 0

    def observe_locked(self, value: float) -> None:  # holds-lock: _metrics_lock
        self.counts[bisect_left(self.buckets, value)] += 1
        self.total += value
        self.count += 1


_metrics_lock = threading.Lock()
_histograms: dict[str, Histogram] = {}  # guarded-by: _metrics_lock
_counters: dict[str, int] = {}  # guarded-by: _metrics_lock


def observe_phase(phase: str, seconds: float) -> None:
    with _metrics_lock:
        hist = _histograms.get(phase)
        if hist is None:
            hist = Histogram(_buckets_for(phase))
            _histograms[phase] = hist
        hist.observe_locked(max(float(seconds), 0.0))


def escape_label_value(value: str) -> str:
    """Prometheus label escaping: backslash, double quote, newline."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _fmt_value(value) -> str:
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    as_float = float(value)
    if as_float == int(as_float) and abs(as_float) < 1e15:
        return str(int(as_float))
    return repr(as_float)


def _fmt_le(bound: float) -> str:
    return "+Inf" if bound == float("inf") else _fmt_value(bound)


class PromBuilder:
    """Prometheus text exposition in which every family has one ``#
    HELP`` and one ``# TYPE`` line, its samples sit under it, and label
    values are escaped: the supervisor's ``/metrics`` is built with it,
    so a malformed series cannot be emitted."""

    def __init__(self):
        self._order: list[str] = []
        # family -> (type, help, [sample lines])
        self._families: dict[str, tuple[str, str, list[str]]] = {}

    def family(self, name: str, mtype: str, help_text: str) -> None:
        if name not in self._families:
            self._order.append(name)
            self._families[name] = (mtype, help_text, [])

    def sample(self, family: str, labels: dict | None = None, value=0,
               suffix: str = "") -> None:
        if family not in self._families:
            raise ValueError(
                f"sample for undeclared family {family!r}: declare it "
                "with family() first (HELP and TYPE are mandatory)"
            )
        label_text = ""
        if labels:
            inner = ",".join(
                f'{key}="{escape_label_value(val)}"'
                for key, val in labels.items()
            )
            label_text = "{" + inner + "}"
        self._families[family][2].append(
            f"{family}{suffix}{label_text} {_fmt_value(value)}"
        )

    def histogram(self, family: str, labels: dict, hist: Histogram) -> None:
        cumulative = 0
        for bound, count in zip(tuple(hist.buckets) + (float("inf"),), hist.counts):
            cumulative += count
            self.sample(
                family, dict(labels, le=_fmt_le(bound)), cumulative,
                suffix="_bucket",
            )
        self.sample(family, labels, hist.total, suffix="_sum")
        self.sample(family, labels, hist.count, suffix="_count")

    def render(self) -> str:
        lines: list[str] = []
        for name in self._order:
            mtype, help_text, samples = self._families[name]
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def render_into(builder: PromBuilder) -> None:
    """Add the registry's phase histograms and event counters to an
    exposition (the supervisor's ``/metrics``)."""
    builder.family(
        "adaptdl_trace_phase_seconds",
        "histogram",
        "Duration of traced rescale-lifecycle phases, by span name.",
    )
    builder.family(
        "adaptdl_trace_events_total",
        "counter",
        "Traced point events (retries, circuit opens, cache "
        "hits/misses, epoch transitions), by event name.",
    )
    with _metrics_lock:
        hists = {
            phase: (hist.buckets, list(hist.counts), hist.total, hist.count)
            for phase, hist in _histograms.items()
        }
        counters = dict(_counters)
    for phase in sorted(hists):
        buckets, counts, total, count = hists[phase]
        snap = Histogram(buckets)
        snap.counts, snap.total, snap.count = counts, total, count
        builder.histogram("adaptdl_trace_phase_seconds", {"phase": phase}, snap)
    for name in sorted(counters):
        builder.sample("adaptdl_trace_events_total", {"event": name}, counters[name])


def prometheus_lines() -> str:
    """The registry's families as an exposition of their own."""
    builder = PromBuilder()
    render_into(builder)
    return builder.render()


def flush_to_supervisor(job_id: str | None = None) -> bool:
    """PUT the spans not yet sent to the supervisor's ``/trace/{job}``;
    best effort. The flush itself is not traced."""
    global _flushed_seq
    url = env.supervisor_url()
    job_id = job_id if job_id is not None else env.job_id()
    if not url or not job_id:
        return False
    with _buffer_lock:
        pending = [r for r in _buffer_locked() if r["seq"] > _flushed_seq]
    if not pending:
        return True
    from adaptdl_tpu_torch import rpc

    try:
        rpc.default_client().put(
            f"{url}/trace/{job_id}",
            endpoint=f"trace/{job_id}",
            json={"spans": pending},
            timeout=(0.5, 5),
            attempts=1,
            circuit_threshold=3,
            circuit_cooldown=60.0,
            traced=False,
        ).raise_for_status()
    except Exception as exc:  # noqa: BLE001 - best effort by design
        LOG.debug("trace flush failed: %s", exc)
        return False
    with _buffer_lock:
        _flushed_seq = max(_flushed_seq, max(r["seq"] for r in pending))
    return True


def phase_summary(records: list[dict]) -> dict[str, float]:
    """Span name -> median duration (seconds); events are left out."""
    by_name: dict[str, list[float]] = {}
    for rec in records:
        if rec.get("kind") != "event":
            by_name.setdefault(rec["name"], []).append(float(rec.get("dur", 0.0)))
    summary = {}
    for name, durs in by_name.items():
        durs.sort()
        mid = len(durs) // 2
        summary[name] = (
            durs[mid] if len(durs) % 2 else (durs[mid - 1] + durs[mid]) / 2.0
        )
    return summary


def render_waterfall(records: list[dict], width: int = 32) -> str:
    """An ASCII phase waterfall of spans in wall-start order (the CLI's
    ``trace`` prints it)."""
    spans = [r for r in records if r.get("kind") != "event"]
    if not spans:
        return "(no spans)"
    spans.sort(key=lambda r: float(r.get("ts", 0.0)))
    t0 = float(spans[0]["ts"])
    horizon = max(
        float(r["ts"]) + float(r.get("dur", 0.0)) for r in spans
    ) - t0 or 1e-9
    lines = [
        f"{'PHASE':<28} {'SIDE':<12} {'START(ms)':>10} "
        f"{'DUR(ms)':>10}  TIMELINE"
    ]
    for rec in spans:
        offset = float(rec["ts"]) - t0
        dur = float(rec.get("dur", 0.0))
        lead = int(width * offset / horizon)
        bar = max(int(width * dur / horizon), 1)
        side = f"pid{rec.get('pid', '?')}/i{rec.get('inc', 0)}"
        lines.append(
            f"{rec['name']:<28} {side:<12} {offset * 1e3:>10.2f} "
            f"{dur * 1e3:>10.2f}  "
            f"{' ' * lead}{'#' * min(bar, width - lead or 1)}"
        )
    return "\n".join(lines)


def _reset_state() -> None:
    """Drop all trace state (tests)."""
    global _buffer, _seq, _flushed_seq, _incarnation
    global _trace_id, _root_span_id, _journal_fh, _journal_target
    with _buffer_lock:
        _buffer = None
        _seq = 0
        _flushed_seq = 0
    with _metrics_lock:
        _histograms.clear()
        _counters.clear()
    with _ctx_lock:
        _trace_id = None
        _root_span_id = None
    with _pending_lock:
        _pending.clear()
    with _journal_lock:
        if _journal_fh is not None:
            _journal_fh.close()
        _journal_fh = None
        _journal_target = None
    _incarnation = None
    if hasattr(_tls, "stack"):
        _tls.stack = []
