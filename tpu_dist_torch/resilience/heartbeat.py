"""Heartbeat watchdog — liveness over the control-plane store; counterpart
of ``tpu_dist/resilience/heartbeat.py``, with the same keys and payloads,
so either package's monitor watches either package's ranks.

A dead or wedged rank leaves its peers hanging inside a collective until
the backend's timeout (or forever).  The watchdog converts that into a
*named* failure within a configurable deadline:

- every rank runs a :class:`Heartbeat` daemon thread publishing
  ``tpu_dist/hb/<generation>/<rank> -> "pid:step:seq"`` to the
  :class:`~tpu_dist_torch.dist.store.TCPStore`;
- a :class:`HeartbeatMonitor` (in the launcher's supervisor via
  ``--heartbeat_timeout``, or in-process via :meth:`HeartbeatMonitor.watch`)
  tracks when each key last *changed* against its own monotonic clock and
  raises/reports :class:`RankLostError` naming the silent rank.

Staleness is change-based, not timestamp-based, so hosts need no clock
agreement: the ``seq`` field increments every beat, making each publish
distinct even when ``step`` has not advanced.  A clean :meth:`Heartbeat.stop`
publishes a terminal beat with ``seq = "exit"`` so a finished rank reads as
*done*, never as lost — otherwise a gang whose ranks complete minutes apart
would kill its own stragglers' healthy peers.

Keys are scoped by gang *generation* (``TPU_DIST_RESTART_COUNT``, bumped by
the supervised-restart loop) so a stalled rank from a previous incarnation
can neither refresh the new gang's liveness nor be misread as one of its
members — the fencing counterpart to the rendezvous generation check.

The publisher opens its OWN store client: rendezvous's shared client holds
its lock across server-side blocking ops (``get``/``wait_value_ge``), which
would starve a beat riding the same connection and fire false positives.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Sequence

__all__ = ["Heartbeat", "HeartbeatMonitor", "RankLostError", "hb_key"]

_DEFAULT_INTERVAL = 1.0


def hb_key(generation: int, rank: int) -> str:
    return f"tpu_dist/hb/{generation}/{rank}"


def _env_generation() -> int:
    from ..dist.rendezvous import generation
    return generation()


def _store_from_env(timeout: float = 10.0):
    """Fresh client to the launcher's control-plane store, or None."""
    addr = os.environ.get("TPU_DIST_STORE_ADDR")
    if not addr:
        return None
    from ..dist.store import TCPStore
    host, _, port = addr.rpartition(":")
    return TCPStore(host, int(port), timeout=timeout)


class RankLostError(RuntimeError):
    """A rank's heartbeat went silent past the deadline (process dead, hung
    in a collective, or partitioned from the store)."""

    def __init__(self, rank: int, silent_for: float, timeout: float,
                 last_payload: Optional[bytes] = None,
                 kind: str = "heartbeat silent",
                 obs_tail: Optional[dict] = None):
        self.rank = rank
        self.silent_for = silent_for
        self.timeout = timeout
        self.kind = kind
        self.obs_tail = obs_tail
        self.last_step: Optional[int] = None
        self.pid: Optional[int] = None
        last = ""
        if last_payload:
            try:
                pid, step, _ = last_payload.decode().split(":")
                self.pid, self.last_step = int(pid), int(step)
                last = f"; last beat: pid={pid} step={step}"
            except (ValueError, UnicodeDecodeError):
                last = f"; last beat: {last_payload!r}"
        else:
            last = "; never published a beat"
        obs = ""
        if obs_tail:
            # the lost rank's last posted flight-recorder position: which
            # collective it last reached, and where
            try:
                from ..obs.hooks import render_tail
                obs = f"; last obs: {render_tail(obs_tail)}"
            except Exception:
                obs = ""
        super().__init__(
            f"rank {rank} lost: {kind} for {silent_for:.1f}s "
            f"(deadline {timeout:.1f}s){last}{obs}")


class Heartbeat:
    """Daemon-thread publisher of this rank's liveness/progress.

    ``store=None`` connects via ``TPU_DIST_STORE_ADDR`` (the launcher's env
    contract); without that the heartbeat is disabled and every method is a
    no-op, so unconditional use in library code is safe.  The train loop
    reports progress with :meth:`set_step`, which also publishes an
    immediate beat (the monitor sees step advances at step latency, not
    ``interval`` latency).  Publish failures are swallowed — a flaky store
    must degrade the diagnostics, never kill training.
    """

    def __init__(self, rank: Optional[int] = None, store=None,
                 interval: float = _DEFAULT_INTERVAL,
                 generation: Optional[int] = None):
        self.rank = (rank if rank is not None
                     else int(os.environ.get("RANK", "0") or 0))
        self.generation = (generation if generation is not None
                           else _env_generation())
        self.interval = interval
        self._owns_store = store is None
        if store is None:
            try:
                store = _store_from_env()
            except Exception:
                store = None
        self.store = store
        self.key = hb_key(self.generation, self.rank)
        self._step: Optional[int] = None
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.store is not None

    def start(self) -> "Heartbeat":
        if self.store is None or self._thread is not None:
            return self
        self._beat()  # first beat lands before start() returns
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"tpu_dist-hb-{self.rank}")
        self._thread.start()
        return self

    def set_step(self, step: int) -> None:
        self._step = step
        self._beat()

    def _beat(self, final: bool = False) -> None:
        if self.store is None:
            return
        from . import chaos as _chaos
        c = _chaos.active()
        if c is not None and c.heartbeat_stalled(self._step, self.rank):
            return  # a chaos-stalled rank must not even announce its exit
        self._seq += 1
        seq = "exit" if final else self._seq
        step = -1 if self._step is None else self._step
        try:
            self.store.set(self.key, f"{os.getpid()}:{step}:{seq}")
        except Exception:
            pass
        # the flight recorder (armed only): record the beat and re-post this
        # rank's tail, so a SIGKILLed rank still leaves its last position
        # in the store.  After the chaos stall check: a stalled rank's tail
        # freezes too
        try:
            from ..obs import hooks as _obs_hooks
            _obs_hooks.heartbeat_tick(self.store, step=self._step)
        except Exception:
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._beat()

    def stop(self, final: bool = True) -> None:
        """Stop publishing.  ``final=True`` (the default) first publishes a
        terminal ``exit`` beat so monitors read this rank as *finished*
        rather than lost — without it, a gang whose ranks complete at
        different times would misdiagnose the early finishers."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final:
            self._beat(final=True)
        if self._owns_store and self.store is not None:
            try:
                self.store.close()
            except Exception:
                pass
            self.store = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class HeartbeatMonitor:
    """Detects silent ranks by polling their heartbeat keys.

    A rank is *lost* when its payload has not changed for ``timeout``
    seconds (``startup_grace`` for ranks that never published — workers need
    time to import torch and reach the store; default ``max(timeout, 30)``).
    Store errors during a poll are NOT rank loss: a monitor partitioned from
    the store reports nothing rather than condemning healthy ranks.

    Use :meth:`poll`/:meth:`check` from a supervisor loop, or
    :meth:`watch` for an in-process background watchdog that hands the first
    :class:`RankLostError` to ``on_lost`` (which typically logs and calls
    :func:`tpu_dist.dist.abort` — a worker stuck in an eager collective
    cannot unwind via an exception on another thread).
    """

    def __init__(self, store, world_size: int, timeout: float,
                 generation: Optional[int] = None,
                 startup_grace: Optional[float] = None,
                 progress_timeout: Optional[float] = None,
                 ranks: Optional[Sequence[int]] = None):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.store = store
        self.timeout = timeout
        self.startup_grace = (startup_grace if startup_grace is not None
                              else max(timeout, 30.0))
        # Beat staleness catches a DEAD or wedged process (its publisher
        # thread stops too); a rank hung inside a collective keeps beating
        # on the daemon thread, so progress_timeout adds the second check:
        # lost when the published *step* has not advanced for that long.
        self.progress_timeout = progress_timeout
        self.generation = (generation if generation is not None
                           else _env_generation())
        self.ranks = list(ranks if ranks is not None else range(world_size))
        now = time.monotonic()
        self._state = {r: (None, now) for r in self.ranks}
        self._step_state = {r: (None, now) for r in self.ranks}
        self._done = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _payload_step(payload: Optional[bytes]) -> Optional[int]:
        if not payload:
            return None
        try:
            return int(payload.decode().split(":")[1])
        except (ValueError, IndexError, UnicodeDecodeError):
            return None

    @staticmethod
    def _is_exit(payload: Optional[bytes]) -> bool:
        return bool(payload) and payload.rsplit(b":", 1)[-1] == b"exit"

    def mark_done(self, rank: int) -> None:
        """Exempt a rank the caller KNOWS finished cleanly (e.g. the
        launcher saw its process exit 0) from staleness checks."""
        self._done.add(rank)

    def reset_rank(self, rank: int) -> None:
        """Forget a rank's staleness history — for supervisors that just
        respawned it (role-graph solo restarts): the fresh incarnation
        gets the startup grace again instead of inheriting the dead
        incarnation's silence."""
        now = time.monotonic()
        self._state[rank] = (None, now)
        self._step_state[rank] = (None, now)
        self._done.discard(rank)

    def _obs_tail(self, rank: int) -> Optional[dict]:
        """The lost rank's last posted flight-recorder position (or None),
        fetched only on the loss path, never in the steady-state poll."""
        try:
            from ..obs import hooks as _obs_hooks
            return _obs_hooks.fetch_tail(self.store, self.generation, rank)
        except Exception:
            return None

    def poll(self) -> List[RankLostError]:
        """One poll pass; returns the currently-lost ranks (possibly [])."""
        lost = []
        for r in self.ranks:
            if r in self._done:
                continue
            key = hb_key(self.generation, r)
            try:
                payload = (self.store.get(key) if self.store.check(key)
                           else None)
            except Exception:
                continue  # store trouble != rank loss
            if self._is_exit(payload):
                self._done.add(r)  # clean finish, not a loss
                continue
            now = time.monotonic()
            prev, since = self._state[r]
            if self.progress_timeout is not None:
                step = self._payload_step(payload)
                prev_step, step_since = self._step_state[r]
                if step != prev_step:
                    self._step_state[r] = (step, now)
                elif (step is not None
                        and now - step_since > self.progress_timeout):
                    lost.append(RankLostError(
                        r, now - step_since, self.progress_timeout,
                        last_payload=payload, kind="no step progress",
                        obs_tail=self._obs_tail(r)))
                    continue
            if payload is not None and payload != prev:
                self._state[r] = (payload, now)
                continue
            deadline = self.timeout if prev is not None else self.startup_grace
            if now - since > deadline:
                lost.append(RankLostError(r, now - since, deadline,
                                          last_payload=prev,
                                          obs_tail=self._obs_tail(r)))
        return lost

    def check(self) -> None:
        """Raise :class:`RankLostError` for the first lost rank, if any."""
        lost = self.poll()
        if lost:
            raise lost[0]

    def watch(self, on_lost: Callable[[RankLostError], None],
              interval: Optional[float] = None) -> "HeartbeatMonitor":
        """Poll on a daemon thread; call ``on_lost`` once on first loss."""
        if self._thread is not None:
            return self
        poll_every = interval if interval is not None else min(
            0.5, self.timeout / 4)

        def _run():
            while not self._stop.wait(poll_every):
                try:
                    lost = self.poll()
                except Exception:
                    continue
                if lost:
                    on_lost(lost[0])
                    return

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="tpu_dist-hb-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
