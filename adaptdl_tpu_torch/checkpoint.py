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

Saves are blocking. The asynchronous write pipeline, delta saves and
peer-to-peer handoff of the JAX package are not part of this module.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import time
from typing import IO

from adaptdl_tpu_torch import collective, env, faults

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
# Good-marker candidacy: checkpoint dir -> healthy guard observations
# since its save landed. Written on the training thread only (saves are
# blocking), and only on rank 0, the rank that writes checkpoints.
_pending_good: dict[str, int] = {}
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

    def unregister(self) -> None:
        _registry.pop(self.name, None)


def _reset_registry() -> None:
    """Clear all registered states (test isolation)."""
    global _prefer_good_heal
    _registry.clear()
    _bad_dirs.clear()
    _loaded_from.clear()
    _pending_good.clear()
    _prefer_good_heal = False


class CheckpointUnreadableError(RuntimeError):
    """Checkpoints exist on disk but none could be restored."""


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


def save_all_states() -> str | None:
    """Sync every registered state on every replica, then save them all
    on rank 0; returns the new checkpoint dir (None when no checkpoint
    path is set or this is not rank 0). Every replica must call it, and
    none returns before rank 0's checkpoint is complete and renamed, so
    a process that exits right after cannot let a successor start on an
    older checkpoint."""
    states = list(_registry.values())
    for state in states:
        state.sync()
    root = env.checkpoint_path()
    final = None
    if root is not None and env.replica_rank() == 0:
        start = time.monotonic()
        final, total_bytes = _write(root, states)
        from adaptdl_tpu_torch import metrics

        metrics.record_checkpoint_save(time.monotonic() - start, total_bytes)
    collective.barrier()
    return final


def _write(root: str, states: list[State]) -> tuple[str, int]:
    os.makedirs(root, exist_ok=True)
    restart = env.num_restarts()
    existing = _list_checkpoints(root)
    tmpdir = tempfile.mkdtemp(prefix=_TMP_PREFIX, dir=root)
    try:
        digests = {}
        for state in states:
            path = os.path.join(tmpdir, state.name)
            with open(path, "wb") as f:
                state.save(f)
                f.flush()
                os.fsync(f.fileno())
            sha, size = _hash_file(path)
            digests[state.name] = {"sha256": sha, "bytes": size}
        seq = max((s for r, s, _ in existing if r == restart), default=-1) + 1
        with open(os.path.join(tmpdir, MANIFEST_NAME), "w") as f:
            json.dump(
                {"version": 1, "restart": restart, "seq": seq,
                 "states": digests},
                f, sort_keys=True,
            )
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmpdir)
        final = os.path.join(root, f"checkpoint-{restart}.{seq}")
        os.replace(tmpdir, final)
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    _fsync_dir(root)
    # Prune what the new save supersedes, except the newest good-marked
    # dir: the guard's rollback floor survives until a newer save earns
    # the marker.
    newest_good = _newest_good_dir(root)
    for _, _, path in existing:
        if path != newest_good:
            shutil.rmtree(path, ignore_errors=True)
    for entry in os.listdir(root):
        if entry.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
    # A candidate for the good marker; pruned candidates drop out.
    _pending_good[final] = 0
    for pending in list(_pending_good):
        if pending != final and not os.path.isdir(pending):
            _pending_good.pop(pending, None)
    return final, sum(entry["bytes"] for entry in digests.values())


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
    its marker."""
    if not _pending_good:
        return
    confirm = env.guard_confirm_steps()
    for path in list(_pending_good):
        count = _pending_good[path] + 1
        if count >= confirm:
            del _pending_good[path]
            if os.path.isdir(path):
                _mark_good(path)
        else:
            _pending_good[path] = count


def reset_health_confirmation() -> None:
    """An unhealthy observation: every unconfirmed checkpoint may already
    carry the corruption, so none of them may earn the marker."""
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
    broadcast, so all of them restore from one directory."""
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
        for state in list(_registry.values()):
            if load_state(state, prefer_good=True, newest=newest):
                restored = _loaded_from.get(state.name, restored)
    finally:
        _prefer_good_heal = False
    return os.path.basename(restored) if restored else None


def load_state(
    state: State, prefer_good: bool = False, newest: str | None = None
) -> bool:
    """Restore one state from the newest readable checkpoint; False
    when no checkpoint holds it. ``prefer_good`` restricts the scan to
    good-marked dirs whenever one exists (the guard's rollback), from
    ``newest`` down when given."""
    root = env.checkpoint_path()
    if root is None:
        return False
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
                with open(os.path.join(ckpt, state.name), "rb") as f:
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
    every state that had already restored from it."""
    _bad_dirs.add(ckpt)
    for name in [n for n, d in _loaded_from.items() if d == ckpt]:
        del _loaded_from[name]
        other = _registry.get(name)
        if other is not None and not load_state(
            other, prefer_good=_prefer_good_heal
        ):
            raise CheckpointUnreadableError(
                f"state {name!r} was restored from {ckpt}, which later "
                "proved unreadable, and no older checkpoint holds it"
            )
