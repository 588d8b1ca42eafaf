"""Event heap for the discrete-event cluster simulator.

Plain ``heapq`` over ``(time, seq, Event)``: the monotone sequence
number breaks time ties deterministically (heapq is not stable), which
is half of the fixed-seed ⇒ bit-identical-summary guarantee. The push/
pop plumbing is annotated ``# replay-pure``: no clock, RNG
construction or IO in the scheduling core.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

# Event kinds (one home for the spellings).
ARRIVE = "arrive"  # a job enters the cluster
HINTS = "hints"  # a job posts/refreshes its sched hints
ALLOC = "alloc"  # an allocator optimization cycle
FINISH = "finish"  # tentative job completion (generation-checked)
PREEMPT = "preempt"  # a spot slice receives a reclaim notice
SLOT_RETURN = "slot_return"  # reclaimed capacity comes back


@dataclass
class Event:
    time: float
    kind: str
    payload: dict = field(default_factory=dict)


class EventQueue:
    """Deterministic min-heap of :class:`Event`."""

    def __init__(self):
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0

    def __len__(self) -> int:  # replay-pure
        return len(self._heap)

    def push(self, event: Event) -> None:  # replay-pure
        self._seq += 1
        heapq.heappush(self._heap, (event.time, self._seq, event))

    def pop(self) -> Event:  # replay-pure
        return heapq.heappop(self._heap)[2]

    def peek_time(self) -> float | None:  # replay-pure
        return self._heap[0][0] if self._heap else None
