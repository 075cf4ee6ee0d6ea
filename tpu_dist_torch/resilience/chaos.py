"""Deterministic fault injection — counterpart of
``tpu_dist/resilience/chaos.py`` (the spec grammar, its errors and the
faults are the JAX package's, word for word): the harness that keeps the
elastic layer honest.

Faults are declared in a compact spec string, usually via the
``TPU_DIST_CHAOS`` env var so any worker can be subjected to failure without
code changes (``rendezvous`` installs it automatically when set)::

    TPU_DIST_CHAOS="kill:rank=1,step=5"
    TPU_DIST_CHAOS="stall-heartbeat:rank=0,step=3;delay-store:rank=1,op=1,delay=0.2"

Grammar: ``fault[;fault...]`` where ``fault = kind[:k=v[,k=v...]]``.  Kinds:

=================  ==========================================================
``kill``           SIGKILL this process when ``on_step(step)`` hits ``step``
                   (the hard preemption: no teardown, no atexit)
``exit``           ``os._exit(code)`` at ``step`` (default code 1)
``shrink``         ``os._exit(PREEMPTED_EXIT_CODE)`` at ``step`` — the
                   pod-preemption simulation: the rank announces it is
                   going away FOR GOOD, so a supervisor running with
                   ``--elastic_world=min:max`` re-forms the gang at the
                   surviving rank count instead of burning restarts
                   relaunching a world that can never fill.  Optional
                   ``world=`` floor: fire only while ``WORLD_SIZE`` is
                   strictly above it — without the floor, a fault pinned
                   to a rank that SURVIVES the shrink re-fires when the
                   renumbered gang re-executes ``step``, cascading the
                   world down every round
``grow``           ``os._exit(GROW_EXIT_CODE)`` at ``step``, but only
                   while the current ``WORLD_SIZE`` is below the fault's
                   ``world=`` target — the capacity-returned simulation:
                   the supervisor re-forms at the elastic maximum.  The
                   ``world=`` guard is what keeps the fault from
                   re-firing after the regrown gang resumes past ``step``
                   again
``raise``          raise :class:`ChaosError` at ``step`` (the exception path
                   through the launcher's fail-fast)
``stall``          sleep ``delay`` seconds (default 600) at ``step`` while
                   peers advance — the silent-straggler simulation: the
                   rank's heartbeats stop too while it is stalled (a
                   wedged process cannot beat), so the watchdog names it
                   and the flight recorder's merge shows every peer
                   waiting on it; a rank that outlives a short stall
                   resumes beating when its step advances
``stall-heartbeat``  stop publishing heartbeats from ``step`` on while the
                   process stays alive — the hung-collective simulation
``drop-store``     close the store client socket right before its ``op``-th
                   request (a deterministic ECONNRESET; exercises the
                   reconnect path for idempotent ops)
``delay-store``    sleep ``delay`` seconds before every store request from
                   the ``op``-th on (a slow/flaky control-plane link)
=================  ==========================================================

Every fault takes an optional ``rank=`` (default: all ranks).  All triggers
are counted, not timed — the same spec replays the same failure at the same
point every run, which is what lets the chaos e2e tests assert bit-for-bit
resume trajectories.

``drop-store``/``delay-store`` act through a hook consulted by the
pure-Python store client (:data:`tpu_dist_torch.dist.store.FAULT_HOOK`); run
chaos jobs with ``TPU_DIST_PURE_PYTHON_STORE=1`` so the native C++ client does
not bypass it.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import List, Optional

__all__ = ["Chaos", "ChaosError", "Fault", "parse", "install",
           "install_from_env", "uninstall", "active",
           "PREEMPTED_EXIT_CODE", "GROW_EXIT_CODE"]

# The elastic-world exit protocol between workers and the supervisor
# (tpu_dist_torch/launch/cli.py --elastic_world): a worker exiting with
# PREEMPTED_EXIT_CODE says "this rank is gone for good — re-form without
# me"; GROW_EXIT_CODE says "capacity is back — re-form at the elastic
# maximum".  Production preemption handlers (GracefulShutdown loops that
# save on SIGTERM) should sys.exit(PREEMPTED_EXIT_CODE) to get the same
# shrink-instead-of-retry treatment the chaos faults exercise.
PREEMPTED_EXIT_CODE = 117
GROW_EXIT_CODE = 118

_KINDS = ("kill", "exit", "raise", "stall", "stall-heartbeat", "shrink",
          "grow", "drop-store", "delay-store")
_STEP_KINDS = ("kill", "exit", "raise", "stall", "stall-heartbeat",
               "shrink", "grow")
_STORE_KINDS = ("drop-store", "delay-store")


class ChaosError(RuntimeError):
    """The injected exception for ``raise`` faults."""


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    rank: Optional[int] = None   # None = every rank
    step: Optional[int] = None   # step-triggered kinds
    op: Optional[int] = None     # store-op-triggered kinds (1-based count)
    delay: float = 0.0           # delay-store only
    code: int = 1                # exit only
    world: Optional[int] = None  # grow: fire while WORLD_SIZE < world;
    #                              shrink: fire while WORLD_SIZE > world

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown chaos fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if self.kind in _STEP_KINDS and self.step is None:
            raise ValueError(f"{self.kind} fault requires step=")
        if self.kind in _STORE_KINDS and self.op is None:
            raise ValueError(f"{self.kind} fault requires op=")
        if self.kind == "delay-store" and self.delay <= 0:
            raise ValueError("delay-store fault requires delay=<seconds>")
        if self.kind == "grow" and (self.world is None or self.world < 2):
            raise ValueError("grow fault requires world=<target >= 2> (the "
                             "guard that stops it re-firing once the gang "
                             "has regrown)")


def parse(spec: str) -> List[Fault]:
    """Parse a spec string (see module docstring) into faults."""
    faults = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        kind, _, params = part.partition(":")
        kwargs = {}
        for kv in filter(None, (p.strip() for p in params.split(","))):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"malformed chaos param {kv!r} in {part!r} "
                                 f"(expected key=value)")
            k = k.strip()
            if k in ("rank", "step", "op", "code", "world"):
                kwargs[k] = int(v)
            elif k == "delay":
                kwargs[k] = float(v)
            else:
                raise ValueError(f"unknown chaos param {k!r} in {part!r}")
        faults.append(Fault(kind.strip(), **kwargs))
    if not faults:
        raise ValueError(f"empty chaos spec {spec!r}")
    return faults


class Chaos:
    """The installed fault set, bound to this process's rank.

    Trigger points (all cheap no-ops when nothing matches):

    - :meth:`on_step` — called by ``resilience.TrainState.end_step`` (or a
      hand-rolled loop) at each step boundary; fires kill/exit/raise.
    - :meth:`heartbeat_stalled` — consulted by :class:`~.heartbeat.Heartbeat`
      before each beat.
    - :meth:`store_op` — the store client hook; fires drop/delay faults on a
      deterministic per-process request count.
    """

    def __init__(self, faults: List[Fault], rank: Optional[int] = None):
        self.faults = list(faults)
        self.rank = (rank if rank is not None
                     else int(os.environ.get("RANK", "0") or 0))
        self._op_count = 0
        self._mu = threading.Lock()

    def _mine(self, f: Fault) -> bool:
        return f.rank is None or f.rank == self.rank

    def on_step(self, step: int) -> None:
        for f in self.faults:
            if not self._mine(f) or f.step != step:
                continue
            if f.kind == "kill":
                _log("chaos-kill", rank=self.rank, step=step)
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "exit":
                _log("chaos-exit", rank=self.rank, step=step, code=f.code)
                os._exit(f.code)
            elif f.kind == "shrink":
                cur = int(os.environ.get("WORLD_SIZE", "1") or 1)
                if f.world is None or cur > f.world:
                    _log("chaos-shrink", rank=self.rank, step=step,
                         world=cur, code=PREEMPTED_EXIT_CODE)
                    os._exit(PREEMPTED_EXIT_CODE)
            elif f.kind == "grow":
                cur = int(os.environ.get("WORLD_SIZE", "1") or 1)
                if cur < f.world:
                    _log("chaos-grow", rank=self.rank, step=step,
                         world=cur, target=f.world, code=GROW_EXIT_CODE)
                    os._exit(GROW_EXIT_CODE)
            elif f.kind == "raise":
                raise ChaosError(
                    f"injected failure on rank {self.rank} at step {step}")
            elif f.kind == "stall":
                secs = f.delay if f.delay > 0 else 600.0
                _log("chaos-stall", rank=self.rank, step=step, seconds=secs)
                time.sleep(secs)

    def heartbeat_stalled(self, step: Optional[int],
                          rank: Optional[int] = None) -> bool:
        # a `stall`ed rank stops beating too: the simulated wedge must look
        # like a real one (a truly stuck process cannot service its loop).
        # stall suppresses only AT its step — while the sleep lasts, the
        # published step stays pinned there; once the rank recovers and
        # advances, beats resume (a recovered rank is healthy, not lost).
        # stall-heartbeat stays `>=`: it simulates a wedge that never ends.
        r = self.rank if rank is None else rank
        if step is None:
            return False
        return any((f.rank is None or f.rank == r)
                   and ((f.kind == "stall-heartbeat" and step >= f.step)
                        or (f.kind == "stall" and step == f.step))
                   for f in self.faults)

    def store_op(self, client, op: int, key: str) -> None:
        with self._mu:
            self._op_count += 1
            n = self._op_count
        for f in self.faults:
            if not self._mine(f):
                continue
            if f.kind == "drop-store" and f.op == n:
                _log("chaos-drop-store", rank=self.rank, op=n, key=key)
                sock = getattr(client, "_sock", None)
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            elif f.kind == "delay-store" and n >= f.op:
                time.sleep(f.delay)


def _log(event: str, **fields) -> None:
    from ..utils.logging import log_event
    log_event(event, **fields)


_ACTIVE: Optional[Chaos] = None
_ACTIVE_SPEC: Optional[str] = None


def install(spec: str, rank: Optional[int] = None) -> Chaos:
    """Parse ``spec``, make it the process-wide active chaos, and wire the
    store fault hook.  Replaces any previously installed chaos."""
    global _ACTIVE, _ACTIVE_SPEC
    chaos = Chaos(parse(spec), rank=rank)
    _ACTIVE, _ACTIVE_SPEC = chaos, spec
    from ..dist import store as _store_mod
    _store_mod.FAULT_HOOK = chaos.store_op
    _log("chaos-installed", rank=chaos.rank, spec=spec)
    return chaos


def install_from_env() -> Optional[Chaos]:
    """Install from ``TPU_DIST_CHAOS`` if set (idempotent: reinstalling the
    same spec keeps the existing op counters); None when unset."""
    spec = os.environ.get("TPU_DIST_CHAOS")
    if not spec:
        return _ACTIVE
    if _ACTIVE is not None and _ACTIVE_SPEC == spec:
        return _ACTIVE
    return install(spec)


def uninstall() -> None:
    global _ACTIVE, _ACTIVE_SPEC
    _ACTIVE, _ACTIVE_SPEC = None, None
    from ..dist import store as _store_mod
    _store_mod.FAULT_HOOK = None


def active() -> Optional[Chaos]:
    return _ACTIVE
