"""Multi-host serving pool with heartbeat-driven lane failover (DESIGN.md §13).

The port of ``repro.launch.failover``: several *hosts*, each running a
:class:`repro_torch.launch.serve_gen.GenServer` in this process, watched by
the crash-safe :class:`repro_torch.distributed.fault_tolerance.Heartbeat`
monitor.  When a host
stops proving liveness — its heartbeat goes stale, truncated, or vanishes —
the pool reassigns every request the dead host had not finished to a
surviving host and the drain completes.

Correctness leans on the same property every fault path in this repo leans
on: a request's sample is a pure function of ``(workload, steps, seed)`` and
a drain on one device and backend is deterministic, so a request re-run
on a different host produces the bit-identical image.  The drill in
``tests/test_torch_mesh_serve.py`` pins a killed-host drain against the
no-fault run bitwise.

On a real fleet the heartbeat directory is a distributed KV prefix and the
reassignment is done by the job controller; the *logic* — beat, detect
stale, requeue the dead host's inventory, keep draining — is exactly what
runs here.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.distributed.fault_tolerance import Heartbeat
from repro_torch.launch.serve_gen import GenServer


class _Host:
    """One pool member: a server plus its liveness marker."""

    def __init__(self, host_id: int, heartbeat_dir: str, server: GenServer):
        self.host_id = host_id
        self.server = server
        self.heart = Heartbeat(heartbeat_dir, host_id)
        self.alive = True           # in-process stand-in for "process exists"


class FailoverPool:
    """Round-robin request pool over N heartbeat-monitored serving hosts.

    Every member is a ``GenServer(**server_kw)``: the hosts are built
    identically, as bitwise reassignment needs.  ``timeout_s`` is the staleness bound handed to
    :meth:`Heartbeat.dead_hosts` — hosts whose last beat is older are
    declared dead on the next :meth:`step` and their unfinished requests
    requeue onto survivors.

    :meth:`kill_host` is the chaos hook: it stops the host's stepping *and*
    beating, exactly what a died process looks like from the monitor's side
    — reassignment is triggered by the stale heartbeat, never by the kill
    call itself.
    """

    def __init__(self, heartbeat_dir: str, *, hosts: int = 2,
                 timeout_s: float = 0.25, server_kw: dict | None = None):
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        self.heartbeat_dir = heartbeat_dir
        self.timeout_s = timeout_s
        self.hosts = [
            _Host(i, heartbeat_dir, GenServer(**dict(server_kw or {})))
            for i in range(hosts)
        ]
        self._tick = 0
        self._next_token = 0
        self._rr = 0                                # round-robin cursor
        # token -> (workload, steps, seed, submit kwargs) — enough to re-run
        # the request bit-identically anywhere
        self._spec: dict[int, tuple] = {}
        self._where: dict[int, tuple[int, int]] = {}    # token -> (host, rid)
        self._results: dict[int, np.ndarray] = {}
        self._dead: set[int] = set()
        #: (token, from_host, to_host) reassignments, in detection order
        self.failovers: list[tuple[int, int, int]] = []
        for h in self.hosts:
            h.heart.beat(0)         # a fresh pool is all-alive by definition

    # ------------------------------------------------------------- submit --
    def _alive_hosts(self) -> list[_Host]:
        return [h for h in self.hosts if h.alive and h.host_id not in
                self._dead]

    def _place(self, token: int, exclude: int | None = None) -> None:
        candidates = [h for h in self._alive_hosts() if h.host_id != exclude]
        if not candidates:
            candidates = self._alive_hosts()
        if not candidates:
            raise RuntimeError("no live hosts left in the pool")
        host = candidates[self._rr % len(candidates)]
        self._rr += 1
        workload, steps, seed, kw = self._spec[token]
        rid = host.server.submit(workload, steps=steps, seed=seed, **kw)
        self._where[token] = (host.host_id, rid)

    def submit(self, workload: str, *, steps: int = 1, seed: int = 0,
               **kw) -> int:
        """Enqueue on the next live host round-robin; returns a pool token
        (stable across failovers, unlike the per-server rid)."""
        token = self._next_token
        self._next_token += 1
        self._spec[token] = (workload, steps, seed, dict(kw))
        self._place(token)
        return token

    # -------------------------------------------------------------- chaos --
    def kill_host(self, host_id: int) -> None:
        """Simulate host death: no more beats, no more ticks.  The monitor
        notices once the last beat goes stale; nothing is reassigned here."""
        self.hosts[host_id].alive = False

    # -------------------------------------------------------------- drain --
    def _collect(self, host: _Host, done) -> None:
        by_rid = {rid: t for t, (hid, rid) in self._where.items()
                  if hid == host.host_id}
        for req in done:
            token = by_rid.get(req.rid)
            if token is not None and token not in self._results:
                self._results[token] = req.result

    def _check_failover(self) -> None:
        for host_id in Heartbeat.dead_hosts(self.heartbeat_dir,
                                            self.timeout_s):
            if host_id in self._dead or host_id >= len(self.hosts):
                continue
            self._dead.add(host_id)
            # requeue everything the dead host had not delivered
            for token, (hid, _) in sorted(self._where.items()):
                if hid != host_id or token in self._results:
                    continue
                self._place(token, exclude=host_id)
                self.failovers.append(
                    (token, host_id, self._where[token][0]))

    def step(self) -> int:
        """One pool tick: step every live host, collect completions, then
        beat and run the heartbeat monitor (detect dead hosts, reassign
        their inventory).  Beats land AFTER the serving work — a tick can
        take seconds under first-touch compilation, so beating first would
        let a slow sibling age every other host's beat past ``timeout_s``
        and false-positive the whole pool.  Returns the number of newly
        collected results."""
        before = len(self._results)
        self._tick += 1
        for host in self._alive_hosts():
            srv = host.server
            if srv._pending or any(l.busy for l in srv._lanes.values()):
                self._collect(host, srv.step())
        for host in self._alive_hosts():
            host.heart.beat(self._tick)
        self._check_failover()
        return len(self._results) - before

    def drain(self, *, max_idle_s: float = 30.0) -> dict[int, np.ndarray]:
        """Step until every token has a result.  ``max_idle_s`` bounds the
        wait for a failover detection (stale heartbeats only age with wall
        time); exceeding it raises rather than spinning forever."""
        last_progress = time.perf_counter()
        while len(self._results) < len(self._spec):
            if self.step() > 0:
                last_progress = time.perf_counter()
            elif time.perf_counter() - last_progress > max_idle_s:
                missing = sorted(set(self._spec) - set(self._results))
                raise RuntimeError(
                    f"pool drain stalled: {len(missing)} request(s) "
                    f"unfinished ({missing[:8]}...) with no progress for "
                    f"{max_idle_s}s")
        return dict(sorted(self._results.items()))

    # -------------------------------------------------------------- stats --
    def stats(self) -> dict[str, float]:
        return {
            "hosts": float(len(self.hosts)),
            "dead_hosts": float(len(self._dead)),
            "failovers": float(len(self.failovers)),
            "requests": float(len(self._spec)),
            "completed": float(len(self._results)),
            "ticks": float(self._tick),
        }


__all__ = ["FailoverPool"]
