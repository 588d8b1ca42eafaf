"""Durable cluster-state storage: write-ahead journal + snapshots.

The port's copy of ``adaptdl_tpu.sched.journal``, byte for byte the same
on-disk format (``# wire: produces=journal_op, consumes=sched_snapshot``):
a journal or snapshot either package wrote, the other recovers. Without
it a supervisor crash loses every job, lease, allocation and retune of
the in-process :class:`~adaptdl_tpu_torch.sched.state.ClusterState`.
Two files in ``state_dir``:

- ``journal.jsonl`` — one JSON record per state mutation, appended and
  **fsynced before the mutation is applied** (write-ahead ordering: a
  crash between journal and apply loses an un-acknowledged mutation,
  never acknowledges a lost one).

  With ``ADAPTDL_JOURNAL_GROUP_COMMIT_S`` > 0 the fsync is *group
  committed*: every append is still written and flushed to the OS in
  order before the mutation applies (write-ahead ordering and
  acknowledged-prefix semantics are unchanged — a killed supervisor
  loses nothing, and whatever a power loss keeps is always a prefix
  of what was acknowledged), but the fsync itself is deferred to a
  background flusher that syncs all appends landing within the window
  at once. The trade is explicit and bounded: at most one window of
  acknowledged mutations is exposed to a *power loss* (not a process
  crash), in exchange for taking the per-mutation fsync off the
  supervisor's critical path. ``0`` (the default) keeps the strict
  fsync-per-record behavior.
- ``snapshot.json`` — a full state dump written atomically
  (tmp + fsync + rename + dir fsync) every ``snapshot_every`` appends,
  after which the journal is truncated, bounding replay time.

Recovery (:meth:`StateJournal.load`) reads the snapshot, then replays
journal records in order. A torn trailing record — the expected
artifact of dying mid-append — is dropped with a warning AND the file
is truncated back to the valid prefix, so post-recovery appends never
concatenate onto the partial line (which would silently cut off every
later acknowledged record at the NEXT recovery). Every record carries
a monotonic ``seq``; the snapshot records the ``last_seq`` it covers,
and replay skips records at or below it — a crash between the
snapshot's atomic replace and the journal truncation therefore
replays nothing twice (double-applying a rollback would double-strike
healthy slots). A corrupt snapshot raises
:class:`JournalCorruptError` loudly instead of silently booting an
empty cluster (the snapshot write is atomic, so a bad one means
storage-level corruption an operator must see).

Fault-injection points (``sched.journal_write``,
``sched.snapshot_write``, ``sched.recovery_replay``) let the chaos
suite kill the supervisor at exactly these windows.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from adaptdl_tpu_torch import env, faults, trace

LOG = logging.getLogger(__name__)

JOURNAL_NAME = "journal.jsonl"
SNAPSHOT_NAME = "snapshot.json"


class JournalCorruptError(RuntimeError):
    """The snapshot is unreadable: recovery cannot be trusted."""


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class StateJournal:
    """Append-only mutation log + periodic snapshot for one cluster.

    Append/snapshot/load ordering is serialized by the owning
    ``ClusterState``'s condition lock; the internal ``_io_lock`` only
    coordinates the file handle with the group-commit flusher thread
    (which fsyncs pending appends when the batching window lapses).
    """

    def __init__(
        self,
        state_dir: str,
        snapshot_every: int = 256,
        group_commit_s: float | None = None,
    ):
        os.makedirs(state_dir, exist_ok=True)
        self.state_dir = state_dir
        self.journal_path = os.path.join(state_dir, JOURNAL_NAME)
        self.snapshot_path = os.path.join(state_dir, SNAPSHOT_NAME)
        self._snapshot_every = max(int(snapshot_every), 1)
        self._appends_since_snapshot = 0
        # Monotonic record sequence; primed by load() so a recovered
        # journal keeps counting where the previous life stopped.
        self._seq = 0
        # Group-commit window: 0 = fsync per append (strict); > 0 =
        # appends flush immediately but share one deferred fsync.
        self._group_commit_s = (
            env.journal_group_commit_s()
            if group_commit_s is None
            else max(float(group_commit_s), 0.0)
        )
        self._io_lock = threading.Lock()  # lock-order: 60
        self._fsync_cv = threading.Condition(self._io_lock)
        self._fh = None  # guarded-by: _io_lock
        self._fsync_pending = False  # guarded-by: _io_lock
        self._fsync_deadline = 0.0  # guarded-by: _io_lock
        self._fsync_thread = None  # guarded-by: _io_lock
        self._closed = False  # guarded-by: _io_lock

    # -- write path ----------------------------------------------------

    def append(self, record: dict) -> int:
        """Durably append one mutation record; returns the stamped
        ``seq``. With group commit disabled (the default) the fsync happens
        before return; with a window, the record is written+flushed in
        order (a process kill loses nothing acknowledged) and the
        fsync is deferred to the flusher, bounded by the window."""
        # The span covers write(+fsync) — the latency every journaled
        # supervisor mutation pays on its critical path (group commit
        # moves the fsync half off it). ``job``/``op`` attrs let a
        # per-job trace pick its own appends out of the shared stream.
        with trace.span(
            "journal.append",
            job=record.get("key", ""),
            op=record.get("op", ""),
        ):
            faults.maybe_fail("sched.journal_write")
            with self._io_lock:
                if self._fh is None:
                    self._fh = open(
                        self.journal_path, "a", encoding="utf-8"
                    )
                self._seq += 1
                record = dict(record, seq=self._seq)
                self._fh.write(
                    json.dumps(record, sort_keys=True) + "\n"
                )
                self._fh.flush()
                if self._group_commit_s <= 0:
                    os.fsync(self._fh.fileno())
                elif not self._fsync_pending:
                    # First append of a batch arms the window; later
                    # appends inside it ride the same deferred fsync
                    # (the deadline is NOT pushed out — latency stays
                    # bounded by one window from the first unsynced
                    # record, however fast appends keep arriving).
                    self._fsync_pending = True
                    self._fsync_deadline = (
                        time.monotonic() + self._group_commit_s
                    )
                    self._ensure_flusher_locked()
                    self._fsync_cv.notify_all()
                self._appends_since_snapshot += 1
                return self._seq

    def _ensure_flusher_locked(self) -> None:  # holds-lock: _io_lock
        if self._fsync_thread is not None and self._fsync_thread.is_alive():
            return
        self._closed = False  # an append after close() re-opens
        self._fsync_thread = threading.Thread(
            target=self._flush_loop,
            name="adaptdl-journal-fsync",
            daemon=True,
        )
        self._fsync_thread.start()

    def _flush_loop(self) -> None:
        with self._io_lock:
            while not self._closed:
                if not self._fsync_pending:
                    self._fsync_cv.wait()
                    continue
                remaining = self._fsync_deadline - time.monotonic()
                if remaining > 0:
                    self._fsync_cv.wait(remaining)
                    continue
                self._fsync_now_locked()

    def _fsync_now_locked(self) -> None:  # holds-lock: _io_lock
        """Sync the batched appends (group commit). Cleared even on
        error — a failing disk must not wedge the flusher in a hot
        retry loop; the next append re-arms the window."""
        self._fsync_pending = False
        if self._fh is None:
            return
        try:
            os.fsync(self._fh.fileno())
        except OSError:  # noqa: BLE001 - surfaced by the next append
            LOG.exception("group-commit fsync failed")

    def snapshot_due(self) -> bool:
        return self._appends_since_snapshot >= self._snapshot_every

    @property
    def last_seq(self) -> int:
        """The newest stamped record sequence (0 before any append).
        Serialized by the owning ClusterState's condition lock, like
        append/snapshot ordering."""
        return self._seq

    def write_snapshot(self, payload: dict) -> None:
        """Atomically replace the snapshot and truncate the journal.

        Ordering matters: the journal is truncated only after the new
        snapshot is durably in place, so a crash at any point leaves
        either (old snapshot + full journal) or (new snapshot + empty
        journal) — never a gap.
        """
        faults.maybe_fail("sched.snapshot_write")
        with trace.span("journal.snapshot"):
            with self._io_lock:
                self._write_snapshot_locked(payload)

    def _write_snapshot_locked(self, payload: dict) -> None:  # holds-lock: _io_lock
        tmp = self.snapshot_path + ".tmp"
        # The snapshot covers every record appended so far: replay
        # skips journal records at or below last_seq, so a crash
        # between the replace below and the truncation never
        # double-applies them.
        payload = dict(payload, last_seq=self._seq)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)
        _fsync_dir(self.state_dir)
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        # The truncation supersedes any group-commit batch: every
        # journaled record is now covered by the snapshot.
        self._fsync_pending = False
        with open(self.journal_path, "w", encoding="utf-8") as f:
            f.flush()
            os.fsync(f.fileno())
        self._appends_since_snapshot = 0

    def close(self) -> None:
        with self._io_lock:
            if self._fsync_pending:
                self._fsync_now_locked()
            self._closed = True
            self._fsync_cv.notify_all()
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            flusher = self._fsync_thread
        # Join OUTSIDE _io_lock: the flusher must reacquire it to
        # observe _closed and exit, so joining under the lock would
        # deadlock. After this returns no background fsync can race a
        # caller that deletes or reopens the journal files.
        if flusher is not None:
            flusher.join()

    # -- recovery ------------------------------------------------------

    def load(self) -> tuple[dict | None, list[dict], int]:
        """Read (snapshot, journal records to replay, torn count).

        The journal is replayed up to the first torn line — one that
        does not parse, or lacks its trailing newline (the fsync that
        would have acknowledged it never returned) — and the file is
        truncated back to that valid prefix so later appends never
        concatenate onto the partial line. Records whose ``seq`` the
        snapshot already covers (a crash landed between the snapshot
        replace and the journal truncation) are skipped, never
        double-applied.
        """
        faults.maybe_fail("sched.recovery_replay")
        snapshot = None
        if os.path.exists(self.snapshot_path):
            try:
                with open(self.snapshot_path, encoding="utf-8") as f:
                    snapshot = json.load(f)
            except (ValueError, OSError) as exc:
                raise JournalCorruptError(
                    f"unreadable state snapshot {self.snapshot_path}: "
                    f"{exc}"
                ) from exc
        last_seq = int((snapshot or {}).get("last_seq", 0))
        self._seq = last_seq
        records: list[dict] = []
        kept = 0
        torn = 0
        if os.path.exists(self.journal_path):
            valid_bytes = 0
            with open(self.journal_path, "rb") as f:
                for lineno, raw in enumerate(f, 1):
                    try:
                        record = json.loads(raw.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        record = None
                    if not isinstance(record, dict) or not raw.endswith(
                        b"\n"
                    ):
                        torn += 1
                        LOG.warning(
                            "dropping torn journal record at %s:%d "
                            "(recovering the acknowledged prefix)",
                            self.journal_path, lineno,
                        )
                        break
                    valid_bytes += len(raw)
                    kept += 1
                    seq = int(record.get("seq", last_seq + 1))
                    self._seq = max(self._seq, seq)
                    if seq <= last_seq:
                        # Already baked into the snapshot: the crash
                        # hit between snapshot replace and journal
                        # truncation.
                        continue
                    records.append(record)
            if torn:
                with open(self.journal_path, "r+b") as f:
                    f.truncate(valid_bytes)
                    f.flush()
                    os.fsync(f.fileno())
        # The recovered journal's length counts toward the rotation
        # threshold: a crash-looping supervisor that never reaches
        # snapshot_every appends per incarnation must still rotate,
        # or the journal (and replay time) grows without bound.
        self._appends_since_snapshot = kept
        return snapshot, records, torn
