"""Replay-safe cross-replica metric accumulation.

The port of ``adaptdl_tpu.accumulator``. ``Accumulator`` lets training
code sum metrics (loss, accuracy counts) across replicas and restarts
without double counting: updates are buffered locally, and entering
``synchronized()`` reduces the buffered updates of every replica into
the global totals (``collective.allreduce``).

Replay: after a restart the user program re-enters the *interrupted
epoch* only, so exactly the ``synchronized()`` call sites of that epoch
that sit *outside* dataloader loops run again (mid-loop steps resume
from the saved position and never replay). Results are therefore
recorded per epoch, only for out-of-loop syncs, and replayed in call
order within the epoch; history of finished epochs is pruned.

A save first reduces every replica's pending updates and carries their
sum in the checkpoint; it enters the totals at the next sync that is
not a replay. (The JAX package merges it into the totals at once, so a
replayed sync of the interrupted epoch overwrites it and the
predecessor's updates since that sync are lost.)

Usage::

    accum = Accumulator()
    for epoch in remaining_epochs_until(N):
        for batch in loader:
            ...
            accum["loss_sum"] += float(loss)
            accum["count"] += bsz
        with accum.synchronized():
            log(accum["loss_sum"] / accum["count"])
        accum.reset()
"""

from __future__ import annotations

import pickle
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Any

from adaptdl_tpu_torch import checkpoint, collective, epoch as epoch_mod
from adaptdl_tpu_torch.data import current_dataloader


def _merge(target: dict, updates: dict) -> None:
    for key, value in updates.items():
        if key in target:
            target[key] = target[key] + value
        else:
            target[key] = value


def _reduce_update_dicts(dicts: list[dict]) -> dict:
    total: dict[str, Any] = {}
    for d in dicts:
        _merge(total, d)
    return total


class Accumulator:
    def __init__(self, name: str = "adaptdl_accumulator"):
        self._updates: dict[str, Any] = {}  # local, not yet reduced
        self._results: dict[str, Any] = {}  # global totals
        # Reduced updates flushed by a save, for the next real sync.
        self._carried: dict[str, Any] = {}
        # epoch -> recorded out-of-loop sync results, in call order
        self._history: dict[int, list[dict]] = defaultdict(list)
        self._sync_count: Counter = Counter()  # per epoch, this run
        self._in_sync = False
        self._checkpoint = _AccumulatorCheckpoint(name, self)
        checkpoint.load_state(self._checkpoint)

    # -- dict-like updates --------------------------------------------

    def __getitem__(self, key):
        if self._in_sync:
            return self._results.get(key, 0)
        # Outside synchronized() only the local buffer is defined.
        return self._updates.get(key, 0)

    def __setitem__(self, key, value):
        if self._in_sync:
            raise RuntimeError("read-only inside synchronized()")
        self._updates[key] = value

    def __contains__(self, key):
        return key in (self._results if self._in_sync else self._updates)

    def update(self, other: dict) -> None:
        _merge(self._updates, other)

    # -- synchronization ----------------------------------------------

    @contextmanager
    def synchronized(self):
        """Reduce pending updates into the totals (or replay them)."""
        if self._in_sync:
            yield self
            return
        epoch = epoch_mod.current_epoch()
        epoch_key = -1 if epoch is None else epoch
        # Finished epochs never replay; their history is dead weight.
        for key in list(self._history):
            if key < epoch_key:
                del self._history[key]
        count = self._sync_count[epoch_key]
        self._sync_count[epoch_key] += 1
        recorded = self._history[epoch_key]
        if count < len(recorded):
            # This sync already ran in a previous incarnation.
            self._results = dict(recorded[count])
            self._updates.clear()
        else:
            merged = collective.allreduce(
                self._updates, _reduce_update_dicts
            )
            _merge(self._results, merged)
            _merge(self._results, self._carried)
            self._updates.clear()
            self._carried.clear()
            if current_dataloader() is None:
                # Mid-loop syncs never replay (the loop resumes past
                # them), so recording them would misalign the history.
                recorded.append(dict(self._results))
        self._in_sync = True
        try:
            yield self
        finally:
            self._in_sync = False

    def reset(self) -> None:
        """Clear totals (start of a new accumulation window)."""
        self._results.clear()
        self._updates.clear()

    def close(self) -> None:
        self._checkpoint.unregister()


class _AccumulatorCheckpoint(checkpoint.State):
    def __init__(self, name: str, accumulator: Accumulator):
        super().__init__(name)
        self._accumulator = accumulator

    def sync(self) -> None:
        # Reduce every replica's pending updates so the checkpoint
        # carries them (a collective: save_all_states calls it on every
        # replica).
        acc = self._accumulator
        merged = collective.allreduce(acc._updates, _reduce_update_dicts)
        _merge(acc._carried, merged)
        acc._updates.clear()

    def save(self, fileobj):
        acc = self._accumulator
        pickle.dump(
            {
                "results": acc._results,
                "carried": acc._carried,
                "history": dict(acc._history),
            },
            fileobj,
        )

    def load(self, fileobj):
        payload = pickle.load(fileobj)
        acc = self._accumulator
        acc._results = payload["results"]
        acc._carried = payload["carried"]
        acc._history = defaultdict(list, payload["history"])
        acc._sync_count = Counter()
        acc._updates.clear()
