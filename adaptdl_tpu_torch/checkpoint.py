"""Named-state checkpointing for checkpoint-restart elasticity.

The core of ``adaptdl_tpu.checkpoint``: any object that must survive a
rescale registers a :class:`State` under a unique name.
:func:`save_all_states` writes every registered state into a fresh
temp directory with an integrity manifest (sha256 and size of each
payload), fsyncs it, and atomically renames it to
``checkpoint-{num_restarts}.{seq}``; only then are older versions
pruned, so a kill at any point leaves a complete checkpoint on disk.
:func:`load_state` restores one state from the newest directory whose
payload verifies, falls back to older ones past a corrupt payload, and
raises :class:`CheckpointUnreadableError` rather than cold-starting
over checkpoints it could not read.

Last-known-good (the numeric-health guard's rollback floor): every
completed save becomes a *pending* candidate; after
``ADAPTDL_GUARD_CONFIRM_STEPS`` healthy guard observations
(:func:`note_healthy_step`) it earns a durable ``GOOD`` marker file, and
an unhealthy observation drops every pending candidate
(:func:`reset_health_confirmation`), since corruption precedes its
detection. :func:`rollback_to_good` restores every registered state
from the newest good-marked checkpoint; pruning never removes that one.
At several replicas rank 0 writes checkpoints and markers, and every
rank restores from the same directory.

A save has two phases, as in the JAX package. The *snapshot* runs on
the training thread at the step boundary: every state's
:meth:`State.snapshot` captures a host copy (the trainer's tensors go
device -> a reused pinned host buffer). The *write* serializes the
snapshots, hashes and renames them, on the caller's thread for a
blocking save and on a writer thread under ``wait=False``, the
loader's periodic save. :func:`wait_for_inflight_save` joins a write in
flight; every save, load and rollback joins it first, and so does the
interpreter's exit. A save's good-marker candidacy starts at its
snapshot, and the marker lands only once its write has completed.

A load first holds a warm successor until its cutover
(``sched/warmup.py``), then asks the predecessor's shard server
(``handoff``) and then reads storage; ``_loaded_from`` records where
each state came from. The guard's rollback never holds.
Delta saves are not part of the port.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import re
import shutil
import tempfile
import threading
import time
from typing import IO, Any

from adaptdl_tpu_torch import collective, env, faults, handoff, trace
from adaptdl_tpu_torch.sched import warmup

LOG = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
GOOD_MARKER_NAME = "GOOD"
_CKPT_DIR_PATTERN = re.compile(r"^checkpoint-(\d+)(?:\.(\d+))?$")
_TMP_PREFIX = "_tmp-checkpoint-"

_registry: dict[str, "State"] = {}
# Dirs found unreadable by any state this process: every later load
# skips them, and states already restored from such a dir restore
# again from an older one, so all states land on one version.
_bad_dirs: set[str] = set()
_loaded_from: dict[str, str] = {}
# Where a state restored from when it came from the predecessor's shard
# server, never a directory.
HANDOFF_SOURCE = "<handoff>"
# Good-marker candidacy: checkpoint dir -> [healthy guard observations
# since its snapshot, whether its write has landed]. The training thread
# and the writer thread both update it, under _good_lock; only rank 0,
# the rank that writes checkpoints, has entries.
_good_lock = threading.Lock()
_pending_good: dict[str, list] = {}  # guarded-by: _good_lock
# The writer thread's prune against a rollback reading good dirs.
_prune_lock = threading.Lock()
# While a rollback runs, the consistency re-loads of _poison keep to
# the good-marked dirs too.
_prefer_good_heal = False


class State:
    """A named piece of training state that survives restarts.
    Subclasses override :meth:`save` and :meth:`load` (byte streams)."""

    def __init__(self, name: str):
        if name in _registry:
            raise ValueError(f"duplicate State name: {name!r}")
        self.name = name
        _registry[name] = self

    def sync(self) -> None:
        """Called on every replica before a save; a state whose replicas
        hold different parts reconciles them here (a collective)."""

    def save(self, fileobj: IO[bytes]) -> None:
        raise NotImplementedError

    def load(self, fileobj: IO[bytes]) -> None:
        raise NotImplementedError

    def snapshot(self) -> Any:
        """The save's first phase, on the training thread: a point-in-time
        copy that later changes to the live object cannot reach. The
        default serializes through :meth:`save` at once; a state on the
        device returns host copies instead and serializes them in
        :meth:`write_snapshot`."""
        buf = io.BytesIO()
        self.save(buf)
        return buf.getvalue()

    def write_snapshot(self, snapshot: Any, fileobj: IO[bytes]) -> None:
        """The second phase, possibly on the writer thread: serialize a
        :meth:`snapshot` result. It touches only the snapshot."""
        fileobj.write(snapshot)

    def snapshot_chunks(self, snapshot: Any) -> list | None:
        """``[(chunk_id, bytes), ...]`` of a snapshot for the handoff, or
        None (the default): the peer then serves the state as one opaque
        ``__payload__``."""
        return None

    def load_chunks(self, chunks: list) -> None:
        """Restore from :meth:`snapshot_chunks`' chunks, in their order."""
        raise NotImplementedError

    def unregister(self) -> None:
        _registry.pop(self.name, None)


def _reset_registry() -> None:
    """Clear all registered states (test isolation)."""
    global _prefer_good_heal
    wait_for_inflight_save()
    _registry.clear()
    _bad_dirs.clear()
    _loaded_from.clear()
    with _good_lock:
        _pending_good.clear()
    _prefer_good_heal = False
    handoff._reset_client_state()


class CheckpointUnreadableError(RuntimeError):
    """Checkpoints exist on disk but none could be restored."""


def registered_states() -> list["State"]:
    """Every state registered in this process."""
    return list(_registry.values())


def _list_checkpoints(root: str) -> list[tuple[int, int, str]]:
    """(restart, seq, path) ascending for every versioned dir."""
    found = []
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return []
    for entry in entries:
        m = _CKPT_DIR_PATTERN.match(entry)
        if m:
            seq = int(m.group(2)) if m.group(2) else 0
            found.append((int(m.group(1)), seq, os.path.join(root, entry)))
    return sorted(found)


def latest_checkpoint_dir(root: str | None = None) -> str | None:
    root = root if root is not None else env.checkpoint_path()
    if root is None:
        return None
    ckpts = _list_checkpoints(root)
    return ckpts[-1][2] if ckpts else None


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _hash_file(path: str) -> tuple[str, int]:
    sha = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            sha.update(block)
            size += len(block)
    return sha.hexdigest(), size


class AsyncSaveHandle:
    """One save: ``snapshot_s`` once :func:`save_all_states` returns,
    ``write_s``, ``total_bytes`` and ``per_state`` once the write has
    landed. ``path`` is the checkpoint dir (None off rank 0 or without
    a checkpoint path); ``os.fspath`` gives it. :meth:`wait` joins the
    write and re-raises its error (the previous checkpoint is then
    intact, as after a failed blocking save)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        self._done = threading.Event()
        self.path: str | None = None
        self.snapshot_s = 0.0
        self.write_s = 0.0
        self.total_bytes = 0
        # With retain_snapshots: {name: snapshot}, the host copies the
        # handoff server serves (one device -> host pass for both).
        self.snapshots: dict[str, Any] | None = None
        # Written by the writer thread, read by the training thread.
        self._lock = threading.Lock()
        self.per_state: dict[str, dict[str, float]] = {}  # guarded-by: _lock

    def __fspath__(self) -> str:
        if self.path is None:
            raise TypeError("this save wrote no checkpoint directory")
        return self.path

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


_inflight_save: AsyncSaveHandle | None = None
_atexit_registered = False


def _ensure_atexit_join() -> None:
    """Let a write in flight land before the interpreter tears down: a
    writer killed mid-write loses the save, and one in C code at
    finalization can abort the process."""
    global _atexit_registered
    if not _atexit_registered:
        import atexit

        atexit.register(wait_for_inflight_save)
        _atexit_registered = True


def inflight_save() -> AsyncSaveHandle | None:
    """The background write in flight, if any (the urgent drain reports
    whether it joined one)."""
    return _inflight_save


def wait_for_inflight_save() -> None:
    """Join the background write, if any. A failed write is logged, not
    raised: every caller is a synchronization point (the next save, a
    load, the exit) for which the previous checkpoint is intact."""
    global _inflight_save
    if _inflight_save is not None:
        handle, _inflight_save = _inflight_save, None
        try:
            handle.wait()
        except Exception:  # noqa: BLE001 - logged; old checkpoint intact
            LOG.warning(
                "a background checkpoint write failed; continuing from "
                "the previous complete checkpoint", exc_info=True,
            )


def save_all_states(
    wait: bool = True, retain_snapshots: bool = False
) -> AsyncSaveHandle:
    """Sync every registered state on every replica and snapshot them on
    rank 0, then write them on rank 0: on this thread, or on a writer
    thread when ``wait=False`` (the snapshot is complete when this
    returns, so the caller may change any state at once). A blocking
    save holds every replica until rank 0's checkpoint is renamed, so a
    process that exits right after cannot let a successor start on an
    older checkpoint: the final pre-exit save must block. With
    ``retain_snapshots`` the handle keeps the host copies."""
    global _inflight_save
    wait_for_inflight_save()
    states = list(_registry.values())
    handle = AsyncSaveHandle()
    root = env.checkpoint_path()
    rank0 = root is not None and env.replica_rank() == 0
    start = time.monotonic()
    snapshots: list[Any] = []
    with trace.span("ckpt.snapshot", states=len(states), wait=wait):
        for state in states:
            state.sync()
        if rank0:
            for state in states:
                t0 = time.monotonic()
                snapshots.append(state.snapshot())
                with handle._lock:
                    handle.per_state[state.name] = {
                        "snapshot_s": time.monotonic() - t0
                    }
    handle.snapshot_s = time.monotonic() - start
    if not rank0:
        handle._done.set()
        if wait:
            collective.barrier()
        return handle
    if retain_snapshots:
        handle.snapshots = {s.name: snap for s, snap in zip(states, snapshots)}
    os.makedirs(root, exist_ok=True)
    restart = env.num_restarts()
    # No other write is in flight, so the sequence is settled now.
    seq = max(
        (s for r, s, _ in _list_checkpoints(root) if r == restart), default=-1
    ) + 1
    handle.path = os.path.join(root, f"checkpoint-{restart}.{seq}")
    # Candidacy counts from the snapshot: observations after it are what
    # vouch for the state it holds.
    with _good_lock:
        _pending_good[handle.path] = [0, False]
    traceparent = trace.current_traceparent()

    def write() -> None:
        t0 = time.monotonic()
        try:
            with trace.span(
                "ckpt.write", traceparent=traceparent, states=len(states),
                background=not wait,
            ):
                handle.total_bytes = _write(
                    root, handle.path, restart, seq, states, snapshots, handle
                )
        except BaseException:
            with _good_lock:
                _pending_good.pop(handle.path, None)
            raise
        handle.write_s = time.monotonic() - t0
        _landed(handle.path)
        with handle._lock:
            per_state = dict(handle.per_state)
        from adaptdl_tpu_torch import metrics

        metrics.record_checkpoint_save(
            handle.snapshot_s, handle.write_s, per_state,
            total_bytes=handle.total_bytes,
        )

    if wait:
        try:
            write()
        finally:
            handle._done.set()
        collective.barrier()
        return handle

    def background() -> None:
        try:
            write()
        except BaseException as exc:  # noqa: BLE001 - raised by wait()
            handle._exc = exc
            LOG.warning("background checkpoint write failed", exc_info=True)
        finally:
            handle._done.set()

    handle._thread = threading.Thread(
        target=background, name="adaptdl-torch-ckpt-writer", daemon=True
    )
    _inflight_save = handle
    _ensure_atexit_join()
    handle._thread.start()
    return handle


def _write(
    root: str,
    final: str,
    restart: int,
    seq: int,
    states: list[State],
    snapshots: list[Any],
    handle: AsyncSaveHandle,
) -> int:
    """Write the snapshots into a temp dir with their manifest, rename it
    to ``final`` and prune what it supersedes; returns the bytes."""
    existing = _list_checkpoints(root)
    tmpdir = tempfile.mkdtemp(prefix=_TMP_PREFIX, dir=root)
    try:
        digests = {}
        for state, snap in zip(states, snapshots):
            t0 = time.monotonic()
            path = os.path.join(tmpdir, state.name)
            with open(path, "wb") as f:
                state.write_snapshot(snap, f)
                f.flush()
                os.fsync(f.fileno())
            sha, size = _hash_file(path)
            digests[state.name] = {"sha256": sha, "bytes": size}
            with handle._lock:
                handle.per_state[state.name]["write_s"] = time.monotonic() - t0
        with open(os.path.join(tmpdir, MANIFEST_NAME), "w") as f:
            json.dump(
                {"version": 1, "restart": restart, "seq": seq,
                 "states": digests},
                f, sort_keys=True,
            )
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmpdir)
        os.replace(tmpdir, final)
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    _fsync_dir(root)
    # Prune what the new save supersedes, except the newest good-marked
    # dir: the guard's rollback floor survives until a newer save earns
    # the marker. A rollback reading good dirs holds the lock meanwhile.
    with _prune_lock:
        newest_good = _newest_good_dir(root)
        for _, _, path in existing:
            if path != newest_good:
                shutil.rmtree(path, ignore_errors=True)
        for entry in os.listdir(root):
            if entry.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
    return sum(entry["bytes"] for entry in digests.values())


def _landed(final: str) -> None:
    """``final``'s write completed: it may now earn its marker, at once
    if it already saw enough healthy observations. Pruned candidates
    drop out."""
    with _good_lock:
        entry = _pending_good.get(final)
        if entry is not None:
            entry[1] = True
            if entry[0] >= env.guard_confirm_steps():
                del _pending_good[final]
                _mark_good(final)
        for pending in list(_pending_good):
            if pending != final and not os.path.isdir(pending):
                del _pending_good[pending]


def _verify(ckpt: str, name: str) -> str:
    """``"ok"``, ``"skip"`` (state absent from this dir) or
    ``"corrupt"`` (the dir's manifest disagrees with its payload)."""
    path = os.path.join(ckpt, name)
    present = os.path.isfile(path)
    if not env.checkpoint_verify():
        return "ok" if present else "skip"
    try:
        with open(os.path.join(ckpt, MANIFEST_NAME)) as f:
            entry = json.load(f)["states"].get(name)
    except (OSError, ValueError, KeyError, AttributeError):
        return "corrupt"
    if entry is None:
        return "corrupt" if present else "skip"
    if not present:
        return "corrupt"
    sha, size = _hash_file(path)
    if size != entry.get("bytes") or sha != entry.get("sha256"):
        return "corrupt"
    return "ok"


def is_good_checkpoint(ckpt: str) -> bool:
    """Whether ``ckpt`` carries the durable last-known-good marker."""
    return os.path.exists(os.path.join(ckpt, GOOD_MARKER_NAME))


def _newest_good_dir(root: str) -> str | None:
    """Newest readable good-marked checkpoint dir, or None."""
    for _, _, ckpt in reversed(_list_checkpoints(root)):
        if ckpt not in _bad_dirs and is_good_checkpoint(ckpt):
            return ckpt
    return None


def _mark_good(ckpt: str) -> None:
    """Durably write ``ckpt``'s good marker (best-effort: a marker that
    fails to land only delays rollback eligibility)."""
    marker = os.path.join(ckpt, GOOD_MARKER_NAME)
    try:
        with open(marker, "w", encoding="utf-8") as f:
            f.write("good\n")
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(ckpt)
        LOG.info("checkpoint %s marked last-known-good", ckpt)
    except OSError:
        LOG.warning("could not mark %s good", ckpt, exc_info=True)


def note_healthy_step() -> None:
    """One healthy guard observation: advance every pending candidate;
    one that has now seen ``ADAPTDL_GUARD_CONFIRM_STEPS`` of them earns
    its marker once its write has landed."""
    confirm = env.guard_confirm_steps()
    with _good_lock:
        for path, entry in list(_pending_good.items()):
            entry[0] += 1
            if entry[0] >= confirm and entry[1]:
                del _pending_good[path]
                if os.path.isdir(path):
                    _mark_good(path)


def reset_health_confirmation() -> None:
    """An unhealthy observation: every unconfirmed checkpoint may already
    carry the corruption (a write in flight included), so none of them
    may earn the marker."""
    with _good_lock:
        _pending_good.clear()


def last_good_age() -> float | None:
    """Seconds since the newest good-marked checkpoint earned its
    marker; None when there is none."""
    root = env.checkpoint_path()
    if root is None:
        return None
    good = _newest_good_dir(root)
    if good is None:
        return None
    try:
        # The marker may predate this process: its file time against the
        # wall clock is the age.
        marker = os.path.join(good, GOOD_MARKER_NAME)
        return max(time.time() - os.path.getmtime(marker), 0.0)
    except OSError:
        return None


def rollback_to_good() -> str | None:
    """Restore every registered state from the newest good-marked
    checkpoint (the guard's rollback); returns that dir's basename, or
    None when no good checkpoint exists. Raises
    :class:`CheckpointUnreadableError` when good checkpoints exist but
    none is readable. Read-only with respect to the store. Every replica
    calls it at the same step; rank 0's choice of the newest good dir is
    broadcast, so all of them restore from one directory.

    It does not wait for a background write: the unhealthy observation
    before it cancelled that save's candidacy, so the write cannot earn
    a marker and the newest good dir stays as it is. Rank 0's writer
    prunes under ``_prune_lock``, which the restore holds."""
    global _prefer_good_heal
    root = env.checkpoint_path()
    if root is None:
        return None
    faults.maybe_fail("guard.rollback")
    newest = collective.broadcast(
        _newest_good_dir(root) if env.replica_rank() == 0 else None
    )
    if newest is None:
        return None
    _prefer_good_heal = True
    try:
        restored: str | None = None
        with _prune_lock:
            for state in list(_registry.values()):
                if load_state(state, prefer_good=True, newest=newest):
                    restored = _loaded_from.get(state.name, restored)
    finally:
        _prefer_good_heal = False
    return os.path.basename(restored) if restored else None


def load_state(
    state: State, prefer_good: bool = False, newest: str | None = None
) -> bool:
    """Restore one state from the predecessor's shard server, else from
    the newest readable checkpoint; False when neither holds it.
    ``prefer_good`` restricts the scan to good-marked dirs whenever one
    exists (the guard's rollback), from ``newest`` down when given, and
    skips the shard server, which holds the newest save, and the write
    in flight, which no good dir can be."""
    root = env.checkpoint_path()
    if root is None:
        return False
    if not prefer_good:
        # The warm successor's hold point: everything before this line
        # (start-up, model and trainer build) ran while the incumbent
        # still trained; maybe_hold prefetches the peer's chunks, marks
        # the process ready and blocks until the runner's cutover (or
        # exits 143 on a discard). A normal launch falls through.
        warmup.maybe_hold()
        # The peer first, before joining a write in flight: its chunks
        # are the final save's, and waiting for storage would put the
        # write back on the path the handoff exists to avoid. Chunks are
        # hash-checked; any failure falls through to storage.
        try:
            if handoff.try_restore(state):
                _loaded_from[state.name] = HANDOFF_SOURCE
                return True
        except Exception:  # noqa: BLE001 - handoff is an optimization
            LOG.warning(
                "handoff restore failed for state %r; reading the "
                "durable checkpoint", state.name, exc_info=True,
            )
        # Read-your-writes: a load while a write is in flight sees that
        # save.
        wait_for_inflight_save()
    good_floor = (newest or _newest_good_dir(root)) if prefer_good else None
    dirs = [ckpt for _, _, ckpt in reversed(_list_checkpoints(root))]
    if good_floor in dirs:
        dirs = dirs[dirs.index(good_floor):]
    attempted = False
    for ckpt in dirs:
        if ckpt in _bad_dirs:
            continue
        if good_floor is not None and not is_good_checkpoint(ckpt):
            continue
        verdict = _verify(ckpt, state.name)
        if verdict == "skip":
            continue
        if verdict == "ok":
            start = time.monotonic()
            try:
                with open(os.path.join(ckpt, state.name), "rb") as f, \
                        trace.span("ckpt.restore", state=state.name):
                    state.load(f)
                _loaded_from[state.name] = ckpt
                from adaptdl_tpu_torch import metrics

                metrics.record_checkpoint_restore(
                    state.name, time.monotonic() - start
                )
                return True
            except Exception:  # noqa: BLE001 - any unreadable payload
                LOG.warning(
                    "checkpoint %s is unreadable for state %r",
                    ckpt, state.name, exc_info=True,
                )
        attempted = True
        LOG.warning(
            "checkpoint %s failed for state %r; falling back to an "
            "older checkpoint", ckpt, state.name,
        )
        _poison(ckpt)
    if attempted:
        raise CheckpointUnreadableError(
            f"state {state.name!r} exists in checkpoint dirs under {root} "
            "but none could be restored"
        )
    return False


def _poison(ckpt: str) -> None:
    """Mark ``ckpt`` unreadable and restore again, from an older dir,
    every state that had already restored from it. States restored from
    the peer reload from storage too: the peer holds the version being
    reconciled away."""
    _bad_dirs.add(ckpt)
    handoff.mark_unavailable()
    for name in [
        n for n, d in _loaded_from.items() if d in (ckpt, HANDOFF_SOURCE)
    ]:
        del _loaded_from[name]
        other = _registry.get(name)
        if other is not None and not load_state(
            other, prefer_good=_prefer_good_heal
        ):
            raise CheckpointUnreadableError(
                f"state {name!r} was restored from {ckpt}, which later "
                "proved unreadable, and no older checkpoint holds it"
            )
