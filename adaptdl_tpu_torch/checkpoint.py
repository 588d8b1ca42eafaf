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

Saves are blocking. The asynchronous write pipeline, delta saves,
peer-to-peer handoff and fault-injection points of the JAX package are
not part of this module.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
from typing import IO

from adaptdl_tpu_torch import collective, env

LOG = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
_CKPT_DIR_PATTERN = re.compile(r"^checkpoint-(\d+)(?:\.(\d+))?$")
_TMP_PREFIX = "_tmp-checkpoint-"

_registry: dict[str, "State"] = {}
# Dirs found unreadable by any state this process: every later load
# skips them, and states already restored from such a dir restore
# again from an older one, so all states land on one version.
_bad_dirs: set[str] = set()
_loaded_from: dict[str, str] = {}


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
    _registry.clear()
    _bad_dirs.clear()
    _loaded_from.clear()


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
        final = _write(root, states)
    collective.barrier()
    return final


def _write(root: str, states: list[State]) -> str:
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
    for _, _, path in existing:
        shutil.rmtree(path, ignore_errors=True)
    for entry in os.listdir(root):
        if entry.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
    return final


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


def load_state(state: State) -> bool:
    """Restore one state from the newest readable checkpoint; False
    when no checkpoint holds it."""
    root = env.checkpoint_path()
    if root is None:
        return False
    attempted = False
    for _, _, ckpt in reversed(_list_checkpoints(root)):
        if ckpt in _bad_dirs:
            continue
        verdict = _verify(ckpt, state.name)
        if verdict == "skip":
            continue
        if verdict == "ok":
            try:
                with open(os.path.join(ckpt, state.name), "rb") as f:
                    state.load(f)
                _loaded_from[state.name] = ckpt
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
        if other is not None and not load_state(other):
            raise CheckpointUnreadableError(
                f"state {name!r} was restored from {ckpt}, which later "
                "proved unreadable, and no older checkpoint holds it"
            )
