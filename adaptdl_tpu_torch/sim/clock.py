"""Virtual time for the discrete-event cluster simulator.

``ClusterState`` takes an injectable clock (``monotonic()`` +
``time()``); the simulator passes a :class:`VirtualClock` so the REAL
supervisor state machine — leases, drain windows, hazard EWMAs,
completion-time summaries — runs entirely on event time. Nothing on
the simulated path may read a wall clock: the clock plumbing is
annotated ``# replay-pure``, where a stray ``time.time()``,
``os.environ`` or file read would silently break trace determinism.
"""

from __future__ import annotations

# Wall-clock base the virtual epoch maps to. Any fixed constant works;
# a realistic epoch keeps wall-stamped journal fields (hazard EWMA
# anchors, completion timestamps) in a plausible range.
WALL_BASE = 1_600_000_000.0


class VirtualClock:
    """Event-driven clock: both the "monotonic" and the "wall" reading
    derive from one simulated now, advanced only by the event loop."""

    def __init__(self, start: float = 0.0, wall_base: float = WALL_BASE):
        self._now = float(start)
        self._wall_base = float(wall_base)

    def monotonic(self) -> float:  # replay-pure
        return self._now

    def time(self) -> float:  # replay-pure
        return self._wall_base + self._now

    def now(self) -> float:  # replay-pure
        """The simulated time in seconds since the sim epoch."""
        return self._now

    def advance_to(self, t: float) -> None:  # replay-pure
        """Move simulated time forward (never backward — an event
        heap handing out a stale timestamp is a scheduler bug, not
        something to paper over)."""
        t = float(t)
        if t < self._now:
            raise ValueError(
                f"virtual clock cannot run backward: {t} < {self._now}"
            )
        self._now = t
