"""Replay-safe epoch loop.

``remaining_epochs_until(n)`` is the user's outer loop. After a rescale
restart it resumes at the epoch that was interrupted (mid-epoch
position is the dataloader's job); epochs that finished before the
restart are never re-entered, so side effects placed per-epoch run
exactly once per *logical* epoch (reference semantics:
adaptdl/adaptdl/torch/epoch.py:96-132, idempotency contract at :15-82).
"""

from __future__ import annotations

import pickle
from typing import Iterator

from adaptdl_tpu_torch import checkpoint

_current_epoch: int | None = None
_started_epochs = 0  # epochs entered so far (the interrupted one incl.)


class _EpochCheckpoint(checkpoint.State):
    def __init__(self):
        super().__init__("adaptdl_epoch")

    def save(self, fileobj):
        pickle.dump(
            {"current": _current_epoch, "started": _started_epochs},
            fileobj,
        )

    def load(self, fileobj):
        global _current_epoch, _started_epochs
        payload = pickle.load(fileobj)
        _current_epoch = payload["current"]
        _started_epochs = payload["started"]


def _reset_state() -> None:
    global _current_epoch, _started_epochs
    _current_epoch = None
    _started_epochs = 0


def _ensure_registered() -> None:
    try:
        state = _EpochCheckpoint()
    except ValueError:
        return  # already registered (and loaded)
    checkpoint.load_state(state)


def current_epoch() -> int | None:
    """The epoch currently being trained, None outside the loop."""
    return _current_epoch


def finished_epochs() -> int:
    """Epochs fully completed (current one excluded)."""
    if _current_epoch is not None:
        return _current_epoch
    return _started_epochs


def remaining_epochs_until(total: int) -> Iterator[int]:
    """Yield epoch indices from the first unfinished one up to total-1.

    A restart that interrupted epoch ``e`` resumes with ``e`` itself
    (its dataloader fast-forwards past completed batches).
    """
    global _current_epoch, _started_epochs
    _ensure_registered()
    start = _current_epoch if _current_epoch is not None else _started_epochs
    for epoch in range(start, total):
        _current_epoch = epoch
        _started_epochs = max(_started_epochs, epoch + 1)
        try:
            yield epoch
        finally:
            if _current_epoch == epoch:
                _current_epoch = None
