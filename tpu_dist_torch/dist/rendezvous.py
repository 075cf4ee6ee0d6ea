"""Rendezvous: how processes find each other — counterpart of
``tpu_dist/dist/rendezvous.py``.

Two styles, as in the reference tutorial: ``env://`` (``MASTER_ADDR``/
``MASTER_PORT``/``WORLD_SIZE``/``RANK``, set by hand or by the launcher) and
``tcp://host:port`` with explicit ``world_size``/``rank``.  Both end in
``torch.distributed.init_process_group`` (process_group.py), whose own c10d
store rank 0 hosts on ``MASTER_PORT``.

**Control-plane store.**  Apart from torch's store, and before it, a
:class:`~tpu_dist_torch.dist.store.TCPStore` carries the control plane, on
the JAX package's wire and under its key names, so either package's
launcher can supervise either package's workers:

- **liveness keys**: every process writes ``tpu_dist/alive/<rank>`` (its
  pid) on arrival, so the launcher and the pre-flight error name exactly
  which ranks are missing instead of hanging;
- **pre-flight**: all processes meet in the store *before*
  ``torch.distributed.init_process_group``, turning a wrong WORLD_SIZE or a
  dead peer into a clear error rather than a c10d timeout;
- **generation fencing**: a process whose ``TPU_DIST_RESTART_COUNT`` is
  older than the store's ``tpu_dist/generation`` is refused;
- **teardown barrier**: processes meet again in :func:`shutdown` before the
  group goes away.

The store is used when ``TPU_DIST_STORE_ADDR=host:port`` is set (the
launcher hosts the server and sets it for its children), or when
``TPU_DIST_STORE_PREFLIGHT=1`` with ``tcp://`` rendezvous, in which case
process 0 hosts it on the coordinator port + 1.  Losing the store degrades
with a warning: it is diagnostics, not the data path.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional, Tuple
from urllib.parse import urlparse

__all__ = ["rendezvous", "shutdown", "parse_init_method", "generation",
           "get_store", "GENERATION_KEY"]

_store = None            # control-plane TCPStore client
_store_num_processes = 0

# the gang's current incarnation number; the supervisor bumps it before
# every restart round (see _fence_generation)
GENERATION_KEY = "tpu_dist/generation"


def generation() -> int:
    """This process's gang incarnation (``TPU_DIST_RESTART_COUNT``, set by
    the launcher's supervisor loop and ``spawn(max_restarts=...)``; 0 on a
    fresh launch or outside any launcher)."""
    try:
        return int(os.environ.get("TPU_DIST_RESTART_COUNT", "0") or 0)
    except ValueError:
        return 0


def get_store():
    """The control-plane store client (None before :func:`rendezvous`, or
    when the job runs without a store)."""
    return _store


def _fence_generation(store, process_id: int) -> None:
    """Refuse a rank from a previous gang incarnation: one that was hung
    while the gang restarted around it must not write liveness keys or
    join the new rendezvous.  One-directional: a store generation *behind*
    this rank only means the supervisor has not published yet."""
    gen = generation()
    try:
        if not store.check(GENERATION_KEY):
            return
        current = int(store.get(GENERATION_KEY))
    except Exception:
        return  # store trouble degrades diagnostics, not correctness
    if current > gen:
        raise RuntimeError(
            f"rank {process_id} fenced out: it belongs to gang generation "
            f"{gen} but the supervisor has moved on to generation {current} "
            f"(the gang restarted while this process was stalled); exiting "
            f"instead of corrupting the new incarnation's rendezvous")


def parse_init_method(init_method: Optional[str],
                      world_size: int = -1,
                      rank: int = -1) -> Tuple[Optional[str], int, int]:
    """Resolve ``(coordinator_address, num_processes, process_id)``;
    ``(None, 1, 0)`` when the configuration is this process alone (no
    ``init_method`` and no multi-process env contract)."""
    if init_method is None:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
        else:
            return None, 1, 0

    if init_method.startswith("env"):
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError(
                "init_method='env://' requires MASTER_ADDR and MASTER_PORT "
                "env vars (set by tpu_dist_torch.launch or by hand)")
        if world_size < 0:
            if "WORLD_SIZE" not in os.environ:
                raise ValueError(
                    "init_method='env://' requires WORLD_SIZE (env var or "
                    "world_size= argument)")
            world_size = int(os.environ["WORLD_SIZE"])
        if rank < 0:
            if "RANK" not in os.environ and world_size > 1:
                raise ValueError(
                    "init_method='env://' requires RANK (env var or rank= "
                    "argument) when WORLD_SIZE > 1")
            rank = int(os.environ.get("RANK", 0))
        return f"{addr}:{port}", world_size, rank

    if init_method.startswith("tcp://"):
        parsed = urlparse(init_method)
        if parsed.hostname is None or parsed.port is None:
            raise ValueError(f"Malformed tcp:// init_method: {init_method!r}")
        if world_size < 0 or rank < 0:
            raise ValueError(
                "tcp:// rendezvous requires explicit world_size and rank")
        return f"{parsed.hostname}:{parsed.port}", world_size, rank

    raise ValueError(
        f"Unsupported init_method {init_method!r}; use 'env://' or "
        f"'tcp://host:port'")


def preflight_timeout(timeout: Optional[float]) -> float:
    """``timeout``, else ``TPU_DIST_PREFLIGHT_TIMEOUT`` (300 s): how long
    the rendezvous waits on its peers."""
    return (timeout if timeout is not None else
            float(os.environ.get("TPU_DIST_PREFLIGHT_TIMEOUT", "300")))


def _setup_store(coordinator: str, num_processes: int, process_id: int,
                 timeout: Optional[float]):
    """Create (or return) the control-plane store client; None if unused."""
    global _store, _store_num_processes
    if _store is not None:
        return _store
    from .store import TCPStore

    addr = os.environ.get("TPU_DIST_STORE_ADDR")
    if addr:
        host, _, port = addr.rpartition(":")
        store = TCPStore(host, int(port),
                         timeout=preflight_timeout(timeout))
    elif os.environ.get("TPU_DIST_STORE_PREFLIGHT"):
        host, _, port = coordinator.rpartition(":")
        store = TCPStore(host, int(port) + 1, is_master=(process_id == 0),
                         timeout=preflight_timeout(timeout))
    else:
        return None
    _store, _store_num_processes = store, num_processes
    return store


def _preflight(store, num_processes: int, process_id: int,
               timeout: Optional[float]) -> None:
    """Check in and wait for every peer's liveness key.  Per-rank keys
    rather than an arrival counter: idempotent under retry, and a timeout
    names exactly the ranks that never appeared."""
    pf_timeout = preflight_timeout(timeout)
    store.set(f"tpu_dist/alive/{process_id}", str(os.getpid()))
    deadline = time.monotonic() + pf_timeout
    waiting = set(range(num_processes))
    delay = 0.01
    while waiting:
        waiting = {r for r in waiting
                   if not store.check(f"tpu_dist/alive/{r}")}
        if not waiting:
            return
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"rendezvous pre-flight: only "
                f"{num_processes - len(waiting)}/{num_processes} processes "
                f"checked in within {pf_timeout:.0f}s; missing ranks: "
                f"{sorted(waiting)}. Check WORLD_SIZE/--nnodes and that "
                f"every rank was actually launched.")
        time.sleep(delay)
        delay = min(delay * 2, 0.5)  # back off: don't hammer the server


def rendezvous(init_method: Optional[str], world_size: int = -1,
               rank: int = -1, timeout: Optional[float] = None
               ) -> Tuple[Optional[str], int, int]:
    """The control-plane half of joining a world: resolve the
    configuration, then (above one process, with a store) fence the
    generation and meet every peer in the store's pre-flight.  Returns
    :func:`parse_init_method`'s ``(coordinator, num_processes,
    process_id)``; the caller then starts ``torch.distributed``."""
    chaos_active = None
    if os.environ.get("TPU_DIST_CHAOS"):
        # deterministic fault injection rides along with any worker, no
        # code changes needed (tpu_dist_torch/resilience/chaos.py)
        from ..resilience import chaos as _chaos
        chaos_active = _chaos.install_from_env()
    netchaos_active = None
    if os.environ.get("TPU_DIST_NETCHAOS"):
        # network fault injection (tpu_dist_torch/resilience/netchaos.py):
        # partitions, delays, resets and bit flips at the transport, store
        # and serve wire boundaries
        from ..resilience import netchaos as _netchaos
        netchaos_active = _netchaos.install_from_env()
    # the flight recorder (TPU_DIST_OBS, launcher --flight-recorder): the
    # crash-dump paths (unhandled exception, SIGTERM, SIGUSR1, exit) go in
    # before anything distributed can hang; off the main thread (thread
    # ranks) the signal handlers are skipped
    from ..obs import hooks as _obs_hooks
    obs_rec = _obs_hooks.install_from_env()
    coordinator, num_processes, process_id = parse_init_method(
        init_method, world_size, rank)
    if chaos_active is not None:
        # install_from_env could only guess from RANK; the resolved
        # process id is authoritative (explicit tcp:// ranks set no RANK)
        chaos_active.rank = process_id
    if netchaos_active is not None:
        netchaos_active.rank = process_id  # the same correction: rank-
        # scoped faults of the store and serve surfaces key on it
    if obs_rec is not None:
        # the same correction: the rank keys the store tail and the dump's
        # file name
        obs_rec.rank = process_id
        obs_rec.world = num_processes
    if coordinator is None or num_processes <= 1:
        return coordinator, num_processes, process_id
    try:
        store = _setup_store(coordinator, num_processes, process_id, timeout)
    except NotImplementedError:
        raise
    except Exception as e:
        if os.environ.get("TPU_DIST_STORE_PREFLIGHT"):
            # explicit opt-in: a silent one-sided degradation would leave
            # the peers stalling against a server that never came up
            raise RuntimeError(
                f"TPU_DIST_STORE_PREFLIGHT is set but the pre-flight store "
                f"could not be set up: {e!r}") from e
        warnings.warn(f"control-plane store unavailable ({e!r}); continuing "
                      f"without liveness/pre-flight diagnostics")
        store = None
    if store is not None:
        _fence_generation(store, process_id)
        _preflight(store, num_processes, process_id, timeout)
    return coordinator, num_processes, process_id


def shutdown() -> None:
    """The teardown barrier, the data plane, then the store client.  Short
    timeout: a peer that died never arrives, and the launcher's TERM→KILL
    escalation handles a rank that lingers."""
    global _store, _store_num_processes
    if _store is None:
        return
    try:
        _store.barrier(
            _store_num_processes, tag="teardown",
            timeout=float(os.environ.get("TPU_DIST_TEARDOWN_TIMEOUT", "10")))
    except Exception as e:
        warnings.warn(f"store teardown barrier failed ({e!r})")
    # the data plane closes after the barrier (a peer may still be sending
    # to our listener) and before the store (its address key goes through
    # the store)
    from ..collectives import transport as _transport
    _transport.close_data_plane()
    try:
        _store.close()
    except Exception:
        pass
    _store, _store_num_processes = None, 0
