"""Fault tolerance: heartbeats, the straggler watchdog and the tick-level
fault plane.

The port of ``repro.distributed.fault_tolerance``.  :class:`Heartbeat` is
the train loop's liveness marker, a JSON file per host replaced
atomically.  :class:`FailureInjector` is the chaos plane of the serving
and training loops (DESIGN.md §11): a list of :class:`Fault`
descriptors, each scheduled at a tick (or armed on every tick), consumed by
the loop at fixed points:

* ``kill``    — raised outside any recovery machinery: the process dies
  (the snapshot/restore drills drive this);
* ``raise``   — raised inside the dispatch path, where the serving loop's
  retry/backoff/degrade ladder sees it (optionally only while the lane
  dispatches on one ``backend``, so a "the kernels are broken" fault stops
  firing once the lane degrades to ``"torch"``);
* ``corrupt`` — poisons one lane slot's state with NaNs; the server catches
  the non-finite sample at completion and re-runs the request;
* ``slow``    — stalls the tick by ``seconds`` inside the timed window, so
  the :class:`StragglerWatchdog` sees it.

Injected ``kill`` and ``raise`` faults raise :class:`InjectedFault`, the
only error the serving loop's retry/degrade ladder and the train loop's
restore-and-resume catch: a real failure of a kernel (one that does not
build or launch) propagates and is never served by the plain path nor
restored in a loop.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field

_HEART_RE = re.compile(r"heartbeat_(\d+)\.json(\.tmp)?")


class InjectedFault(RuntimeError):
    """A failure raised by the fault plane (``kill`` and ``raise``)."""


class Heartbeat:
    """Periodic liveness marker; stale hearts mark dead hosts."""

    def __init__(self, path: str, host_id: int = 0):
        self.path = os.path.join(path, f"heartbeat_{host_id:03d}.json")
        os.makedirs(path, exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def dead_hosts(path: str, timeout_s: float) -> list[int]:
        """Hosts without a fresh, readable heartbeat.

        A host is alive only if it can prove it: a heartbeat that is
        truncated, corrupt, unreadable or still a ``.tmp`` (a crash inside
        the atomic-rename window) proves nothing, so that host is reported
        dead rather than crashing the monitor, the component that must
        outlive everyone else's failures."""
        now = time.time()
        if not os.path.isdir(path):
            return []
        seen: set[int] = set()
        alive: set[int] = set()
        for name in sorted(os.listdir(path)):
            m = _HEART_RE.fullmatch(name)
            if m is None:
                continue
            host = int(m.group(1))
            seen.add(host)
            if m.group(2):          # .tmp mid-rename: not a liveness proof
                continue
            try:
                with open(os.path.join(path, name)) as f:
                    hb = json.load(f)
                fresh = now - float(hb["time"]) <= timeout_s
            except (OSError, ValueError, KeyError, TypeError):
                continue            # unreadable/corrupt: cannot prove alive
            if fresh:
                alive.add(host)
        return sorted(seen - alive)


@dataclass
class StragglerWatchdog:
    """EWMA step-time monitor; flags steps slower than ``threshold`` x EWMA.

    The serving loop's stuck-tick shedding ladder reads its flags
    (DESIGN.md §11)."""

    alpha: float = 0.1
    threshold: float = 2.5
    warmup: int = 5
    _ewma: float = 0.0
    _n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ewma = dt if self._ewma == 0 else (
                self.alpha * dt + (1 - self.alpha) * self._ewma)
            return False
        slow = dt > self.threshold * self._ewma
        if slow:
            self.flagged.append((step, dt, self._ewma))
        else:  # stragglers do not poison the baseline
            self._ewma = self.alpha * dt + (1 - self.alpha) * self._ewma
        return slow


@dataclass(frozen=True)
class Fault:
    """One scheduled fault (the module docstring gives the kinds).

    ``at`` is the tick the fault arms at; ``None`` arms it on every tick (a
    persistent failure).  ``target`` restricts it to one lane (workload
    name); ``backend`` to lanes dispatching on that backend (``"kernels"``
    or ``"torch"``).  ``once`` faults disarm after their first firing;
    persistent ones (``once=False``) fire until their condition stops
    matching.
    """
    at: int | None
    kind: str = "raise"         # kill | raise | corrupt | slow
    target: str | None = None   # lane workload
    slot: int = 0               # corrupt: which lane slot to poison
    seconds: float = 0.0        # slow: injected stall inside the tick
    backend: str | None = None  # raise: only fire on this lane backend
    once: bool = True

    def __post_init__(self):
        if self.kind not in ("kill", "raise", "corrupt", "slow"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FailureInjector:
    """Deterministic tick-level fault plane.

    ``FailureInjector({12})`` raises at tick 12; ``faults=`` takes explicit
    :class:`Fault` descriptors.  Loops consume faults at their injection
    points with :meth:`take`; a consumed ``once`` fault never fires again.
    """

    def __init__(self, fail_at_steps: set[int] | tuple = (),
                 faults: tuple[Fault, ...] | list = ()):
        self.fail_at = set(fail_at_steps)
        self.faults: list[Fault] = [Fault(at=s, kind="raise")
                                    for s in sorted(self.fail_at)]
        self.faults += list(faults)
        self.fired: list[Fault] = []

    def take(self, step: int, *, kind: str, target: str | None = None,
             backend: str | None = None) -> list[Fault]:
        """Arm and consume the ``kind`` faults matching this tick.

        ``target``/``backend`` describe the consumer (the lane asking); a
        fault with a ``None`` field matches any consumer.
        """
        hits = []
        for f in self.faults:
            if f.kind != kind:
                continue
            if f.at is not None and f.at != step:
                continue
            if f.target is not None and target is not None \
                    and f.target != target:
                continue
            if f.backend is not None and backend is not None \
                    and f.backend != backend:
                continue
            if f.once and f in self.fired:
                continue
            self.fired.append(f)
            hits.append(f)
        return hits

    def maybe_fail(self, step: int) -> None:
        """Raise if a ``raise``/``kill`` fault is scheduled at ``step``."""
        for kind in ("raise", "kill"):
            if self.take(step, kind=kind):
                raise InjectedFault(f"injected node failure at step {step}")

    def sleep_faults(self, step: int) -> float:
        """Total injected stall (s) scheduled at ``step``; consumes them."""
        return sum(f.seconds for f in self.take(step, kind="slow"))


def failure_faults(*, kill_at: int | None = None,
                   backend_broken: str | None = None) -> FailureInjector:
    """The two canonical chaos recipes: ``kill_at`` schedules process death
    at that tick (recovery: snapshot restore); ``backend_broken`` (e.g.
    ``"kernels"``) arms a persistent dispatch failure for lanes on that
    backend, which stops matching once the lane degrades off it."""
    faults: list[Fault] = []
    if kill_at is not None:
        faults.append(Fault(at=kill_at, kind="kill"))
    if backend_broken is not None:
        faults.append(Fault(at=None, kind="raise", backend=backend_broken,
                            once=False))
    return FailureInjector(faults=faults)


__all__ = ["InjectedFault", "Heartbeat", "StragglerWatchdog", "Fault",
           "FailureInjector", "failure_faults"]
