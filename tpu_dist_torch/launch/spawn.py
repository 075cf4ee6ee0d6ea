"""Process spawner — counterpart of ``tpu_dist/launch/spawn.py``
(``torch.multiprocessing.spawn``), standard library only.

``spawn(fn, args, nprocs)`` starts ``nprocs`` processes with the ``spawn``
start method (never ``fork``: a forked CUDA context is unusable), calls
``fn(i, *args)`` in each, and with ``join=True`` waits for all of them; the
first child to fail makes the others terminate, and its exception comes
back as :class:`ProcessRaisedException` with the child's traceback (or
:class:`ProcessExitedException` for a child that exited without raising).
The parent must not initialize CUDA before spawning: each child takes its
own card (``cuda:LOCAL_RANK``).  ``max_restarts`` supervises the world:
after a failure every child is stopped and a new generation starts, with
``TPU_DIST_RESTART_COUNT`` counting the generations."""

from __future__ import annotations

import multiprocessing as mp
import os
import random
import sys
import time
import traceback
from typing import Optional, Tuple

__all__ = ["spawn", "ProcessContext", "ProcessRaisedException",
           "ProcessExitedException"]


class ProcessRaisedException(Exception):
    """A child raised; the message carries the child's traceback."""

    def __init__(self, msg: str, error_index: int, pid: Optional[int]):
        super().__init__(msg)
        self.error_index = error_index
        self.pid = pid


class ProcessExitedException(Exception):
    """A child exited abnormally without raising (a signal, or a non-zero
    ``sys.exit``)."""

    def __init__(self, msg: str, error_index: int, exit_code: Optional[int]):
        super().__init__(msg)
        self.error_index = error_index
        self.exit_code = exit_code


def _wrap(fn, i, args, error_queue):
    try:
        fn(i, *args)
    except KeyboardInterrupt:
        # 128 + SIGINT: an interrupted child is not a clean exit
        sys.exit(130)
    except Exception:
        error_queue.put((i, traceback.format_exc()))
        sys.exit(1)


class ProcessContext:
    def __init__(self, processes, error_queue):
        self.processes = processes
        self.error_queue = error_queue

    def pids(self):
        return [p.pid for p in self.processes]

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join all children; on a failure terminate the rest and raise.
        Returns True when all exited cleanly, False when ``timeout`` passed
        with children still running."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if deadline is not None and time.monotonic() > deadline:
                return False
            alive = [p for p in self.processes if p.is_alive()]
            failed = [(i, p) for i, p in enumerate(self.processes)
                      if not p.is_alive() and p.exitcode != 0]
            if failed:
                idx, proc = failed[0]
                for p in alive:
                    p.terminate()
                for p in self.processes:
                    p.join()
                if not self.error_queue.empty():
                    i, tb = self.error_queue.get()
                    raise ProcessRaisedException(
                        f"\n-- Process {i} terminated with the following "
                        f"error:\n{tb}", i, proc.pid)
                msg = (f"process {idx} terminated with exit code "
                       f"{proc.exitcode}")
                if proc.exitcode == 130:
                    msg += " (KeyboardInterrupt)"
                raise ProcessExitedException(msg, idx, proc.exitcode)
            if not alive:
                return True
            alive[0].join(timeout=0.25)


def _spawn_once(fn, args, nprocs, daemon, start_method) -> ProcessContext:
    ctx = mp.get_context(start_method)
    error_queue = ctx.SimpleQueue()
    processes = []
    for i in range(nprocs):
        p = ctx.Process(target=_wrap, args=(fn, i, args, error_queue),
                        daemon=daemon)
        p.start()
        processes.append(p)
    return ProcessContext(processes, error_queue)


def spawn(fn, args: Tuple = (), nprocs: int = 1, join: bool = True,
          daemon: bool = False, start_method: str = "spawn",
          max_restarts: int = 0, restart_backoff: float = 1.0):
    """Spawn ``nprocs`` processes running ``fn(i, *args)``; ``fn`` must be
    picklable (module level).  With ``join=True`` block until all finish,
    raising on the first failure; otherwise return a
    :class:`ProcessContext`.

    ``max_restarts=N`` (needs ``join=True``) supervises the gang: after a
    failure (the rest torn down, as always) the whole world starts again up
    to N times, after a backoff of ``restart_backoff`` seconds doubling a
    round (capped at 30 s, up to 25% jitter).  Each round exports
    ``TPU_DIST_RESTART_COUNT`` (the generation) to its children, so
    rendezvous fences stale ranks and a worker can resume from its latest
    checkpoint.  ``max_restarts=0`` (the default) leaves the environment
    alone.  A child that exited 130 (KeyboardInterrupt) is never
    restarted."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    if max_restarts and not join:
        raise ValueError("max_restarts requires join=True (the supervisor "
                         "must observe child exits)")
    if not max_restarts:
        pc = _spawn_once(fn, args, nprocs, daemon, start_method)
        if join:
            pc.join()
            return None
        return pc

    attempt = 0
    prev_gen = os.environ.get("TPU_DIST_RESTART_COUNT")
    try:
        while True:
            os.environ["TPU_DIST_RESTART_COUNT"] = str(attempt)
            pc = _spawn_once(fn, args, nprocs, daemon, start_method)
            try:
                pc.join()
                return None
            except (ProcessRaisedException, ProcessExitedException) as e:
                if (getattr(e, "exit_code", None) == 130
                        or attempt >= max_restarts):
                    raise
                attempt += 1
                delay = (min(restart_backoff * 2 ** (attempt - 1), 30.0)
                         * (1.0 + 0.25 * random.random()))
                sys.stderr.write(
                    f"[tpu_dist_torch.spawn] world failed ({e}); restart "
                    f"{attempt}/{max_restarts} in {delay:.1f}s\n")
                time.sleep(delay)
    finally:
        if prev_gen is None:
            os.environ.pop("TPU_DIST_RESTART_COUNT", None)
        else:
            os.environ["TPU_DIST_RESTART_COUNT"] = prev_gen
