"""Role-graph process supervisor — per-role spawn and restart policy
(counterpart of ``tpu_dist/roles/launcher.py``).

:func:`spawn_graph` is the launcher half of :mod:`tpu_dist_torch.roles`: it
hosts (or borrows) the control-plane store, publishes the generation and
the agreed role map, spawns one worker process per global rank with the
role-aware env contract, and supervises with **per-role restart policy**:

- a dead rank of a ``restart="solo"`` role is respawned *alone*, in the
  SAME generation — every other process keeps running and store-backed
  channels resume by name (the respawned worker sees
  ``TPU_DIST_ROLE_INCARNATION`` bumped);
- a dead rank of a ``restart="gang"`` role fails the round: the whole
  graph is torn down and — within ``max_restarts`` — relaunched at the
  next generation (fresh channel keyspace, the usual fencing).

Heartbeats route the same way: with ``heartbeat_timeout`` set, a rank
whose beats (``resilience.Heartbeat``) go silent is killed and treated
under its role's policy — a hung actor restarts alone, a hung learner
restarts the gang.  With ``obs_dir`` the workers' flight recorders are
armed, and a failing round asks the live ranks for their dumps (SIGUSR1)
before the teardown.

``python -m tpu_dist_torch.launch --roles learner:1,actor:4:solo
script.py`` is the CLI spelling; this module is the API.  Across nodes
(``@node`` pins, one launcher a node on one shared store) each launcher
supervises its node's ranks, and the launchers agree on every gang round
through the store.

Env contract each worker receives (consumed by
:func:`~tpu_dist_torch.roles.init_role_graph`):

===========================  ===============================================
``RANK`` / ``WORLD_SIZE``    flat global rank / graph world
``TPU_DIST_ROLES``           the graph spec string (``learner:1,actor:4``)
``TPU_DIST_ROLE``            this rank's role name
``TPU_DIST_ROLE_RANK``       rank within the role
``TPU_DIST_ROLE_WORLD``      the role's world size
``TPU_DIST_ROLE_INCARNATION`` 0, bumped on each solo respawn of this rank
``TPU_DIST_STORE_ADDR``      control-plane store
``TPU_DIST_RESTART_COUNT``   gang generation (advances on GANG restarts
                             only — solo respawns keep it, which is what
                             lets channels resume)
===========================  ===============================================

No process of the graph maps itself to a card by its rank (one card may
hold every rank's context of a node), and no role-graph path creates an
NCCL communicator.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from .graph import RoleGraph, down_key, map_key

__all__ = ["spawn_graph", "local_ranks_of", "reap_process"]

_KILL_GRACE = 15.0
# after SIGKILL the only thing left to wait for is the kernel reaping the
# zombie entry; seconds of budget is already paranoid
_REAP_GRACE = 5.0


def reap_process(proc: subprocess.Popen, grace: float = _REAP_GRACE) -> None:
    """SIGKILL ``proc`` (if still alive) and reap it with a bounded wait:
    an unkillable (``D``-state) child must not hang the supervisor on
    ``wait()``; the worst case is a leaked zombie and a log line."""
    try:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=grace)
    except Exception:
        _log(f"reap_process: pid {proc.pid} did not reap within {grace}s "
             f"of SIGKILL (unkillable child?); abandoning")


# bound on the launchers' round agreement when THIS node already failed
# (peers tear down within about one poll and the kill grace, so a peer
# missing past it is a vanished machine, not a slow one)
_AGREE_TIMEOUT = 120.0
# the launchers' gang keys: cluster-scoped, round-suffixed, so rounds never
# race (the JAX package's)
_ROLES_PREFIX = "tpu_dist/cluster/roles"


def local_ranks_of(graph: RoleGraph, node_id: int) -> List[int]:
    """The global ranks node ``node_id`` runs: every rank of every role
    pinned there (``@node`` in the spec; unpinned roles are node 0's —
    placement must be deterministic across launchers, so nothing
    floats)."""
    out: List[int] = []
    for r in graph.roles:
        if (r.node if r.node is not None else 0) == node_id:
            out.extend(graph.span(r.name))
    return out


def _log(msg: str) -> None:
    sys.stderr.write(f"[tpu_dist_torch.roles] {msg}\n")
    sys.stderr.flush()


def _reset_round_state(store, finished_round: int) -> None:
    """Reap a finished gang round's control-plane state before the next
    one (the launch CLI's reaper): liveness marks, heartbeat keys, the
    whole generation keyspace (every channel counter and in-flight
    message) and the teardown barrier counter."""
    from ..launch.cli import _reset_round_state as _cli_reset
    _cli_reset(store, finished_round=finished_round)


def _clear_stale_heartbeat(store, rnd: int, rank: int) -> None:
    """Delete a dead incarnation's heartbeat key before its solo respawn:
    the monitor would otherwise read the stale payload right after
    ``reset_rank`` and demote the fresh incarnation from the startup
    grace to the plain beat deadline — too short to import torch and
    connect, so the respawn would be falsely declared lost in a loop."""
    from ..resilience.heartbeat import hb_key
    try:
        store.delete_key(hb_key(rnd, rank))
    except Exception:
        pass


def _settle_obs_dumps(obs_dir: Optional[str], rnd: int,
                      procs: Dict[int, subprocess.Popen],
                      ranks: Sequence[int]) -> None:
    """SIGUSR1 the still-alive ranks and settle-wait for their dump files
    before TERM goes out (shared logic: ``obs.hooks.request_dumps``)."""
    if not obs_dir:
        return
    from ..obs.hooks import request_dumps
    from ..obs.recorder import dump_path
    request_dumps((procs[r], dump_path(obs_dir, rnd, r)) for r in ranks)


def _exit_sync(store, rnd: int, node_id: int, nnodes: int) -> None:
    """Final ack before the launchers leave the multi-node protocol: node 0
    usually hosts the store, so it must not return (tearing the server
    down) while a peer still polls the round's verdict."""
    try:
        key = f"{_ROLES_PREFIX}/exit/{rnd}"
        store.add(key, 1)
        if node_id == 0:
            store.wait_value_ge(key, nnodes, timeout=15.0)
    except Exception:
        pass  # best effort: at worst the peer takes its noisier error path


def _agree_round(store, rnd: int, node_id: int, nnodes: int,
                 exit_code: int) -> Optional[bool]:
    """The launchers' end-of-round agreement: every node arrives at the
    done barrier (a clean one too: a peer's gang failure restarts it) →
    whether the round failed anywhere, None when the agreement itself
    failed.  A node whose span finished clean waits unbounded (its peers
    may train for hours); a failed round converges within the teardown
    grace, so those waits are bounded."""
    fail_key = f"{_ROLES_PREFIX}/fail/{rnd}"
    try:
        if exit_code != 0:
            store.set(fail_key, str(node_id).encode())
        done_k = f"{_ROLES_PREFIX}/done/{rnd}"
        store.add(done_k, 1)
        store.wait_value_ge(done_k, nnodes,
                            timeout=None if exit_code == 0
                            else _AGREE_TIMEOUT)
        return exit_code != 0 or store.check(fail_key)
    except Exception as e:
        _log(f"cross-launcher round agreement failed ({e!r}); giving up")
        return None


def _teardown(procs: Dict[int, subprocess.Popen]) -> None:
    """TERM everything still running, escalate to KILL after the grace."""
    for p in procs.values():
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + _KILL_GRACE
    for p in procs.values():
        while p.poll() is None:
            if time.monotonic() > deadline:
                reap_process(p)
                break
            time.sleep(0.05)


def _solo_restart(r: int, rc, graph: RoleGraph, incarnation: Dict[int, int],
                  solo_budget: Dict[int, int]) -> None:
    role, role_rank = graph.role_of(r)
    solo_budget[r] -= 1
    incarnation[r] += 1
    from ..utils.logging import log_event
    log_event("role-solo-restart", rank=r, role=f"{role}[{role_rank}]",
              rc=rc, incarnation=incarnation[r], budget_left=solo_budget[r])


def spawn_graph(graph: RoleGraph, argv: Sequence[str],
                role_argv: Optional[Dict[str, Sequence[str]]] = None,
                *, max_restarts: int = 0, solo_restarts: int = 2,
                heartbeat_timeout: float = 0.0,
                restart_backoff: float = 0.5,
                store=None, store_addr: Optional[str] = None,
                master_addr: str = "127.0.0.1", store_port: int = 0,
                extra_env: Optional[Dict[str, str]] = None,
                obs_dir: Optional[str] = None,
                node_id: int = 0, nnodes: int = 1) -> int:
    """Launch and supervise ``graph``; returns the graph's exit code
    (0 = every rank exited cleanly).  ``argv`` is the worker command
    (e.g. ``[sys.executable, "worker.py", ...]``); ``role_argv`` maps a
    role name to an overriding command (per-role entrypoints).

    ``max_restarts`` budgets GANG restarts (generation advances);
    ``solo_restarts`` budgets per-rank solo respawns of ``restart="solo"``
    roles within one generation.  See the module docstring for the env
    contract and policy semantics.

    Multi-node (``nnodes > 1``): every node's launcher calls this with its
    ``node_id``, a SHARED ``store``/``store_addr`` and the same graph; each
    supervises only :func:`local_ranks_of` its node (the ``@node`` pins).
    Gang semantics stay global: a gang-policy death anywhere posts
    ``tpu_dist/cluster/roles/fail/{rnd}``, every launcher tears its span
    down, and the round's outcome (give up, or the next generation) is
    agreed at a cross-launcher barrier before anyone moves on.  Solo
    respawns stay on their node.  Every launcher runs the same budgets."""
    if max_restarts < 0 or solo_restarts < 0:
        raise ValueError("restart budgets must be >= 0")
    if not 0 <= node_id < nnodes:
        raise ValueError(f"node_id {node_id} out of range for nnodes "
                         f"{nnodes}")
    owns_store = store is None
    if owns_store:
        if nnodes > 1 and node_id > 0:
            raise ValueError("multi-node spawn_graph needs the shared "
                             "store= / store_addr= on every non-zero node")
        from ..dist.store import TCPStore
        store = TCPStore(master_addr, store_port, is_master=True)
        store_addr = f"{master_addr}:{store.port}"
    elif store_addr is None:
        raise ValueError("spawn_graph(store=...) needs store_addr= too "
                         "(the address workers dial)")
    my_ranks = (list(range(graph.world)) if nnodes == 1
                else local_ranks_of(graph, node_id))

    spec = graph.spec_string()
    role_argv = dict(role_argv or {})
    for r in graph.roles:
        if r.entry is not None and r.name not in role_argv:
            role_argv[r.name] = [sys.executable, r.entry]

    def _spawn_rank(rank: int, rnd: int, incarnation: int):
        role, role_rank = graph.role_of(rank)
        env = dict(os.environ,
                   RANK=str(rank),
                   WORLD_SIZE=str(graph.world),
                   TPU_DIST_STORE_ADDR=store_addr,
                   TPU_DIST_RESTART_COUNT=str(rnd),
                   TPU_DIST_ROLES=spec,
                   TPU_DIST_ROLE=role,
                   TPU_DIST_ROLE_RANK=str(role_rank),
                   TPU_DIST_ROLE_WORLD=str(graph.role(role).world),
                   TPU_DIST_ROLE_INCARNATION=str(incarnation))
        if heartbeat_timeout > 0:
            env["TPU_DIST_HEARTBEAT_TIMEOUT"] = str(heartbeat_timeout)
        if obs_dir:
            env["TPU_DIST_OBS"] = "1"
            env["TPU_DIST_OBS_DIR"] = obs_dir
        env.update(extra_env or {})
        return subprocess.Popen(list(role_argv.get(role, argv)), env=env)

    rnd = 0
    gang_restarts = 0
    try:
        while True:
            if node_id == 0:
                store.set("tpu_dist/generation", str(rnd))
                store.set(map_key(rnd), graph.to_json())
            procs: Dict[int, subprocess.Popen] = {}
            incarnation = {r: 0 for r in my_ranks}
            solo_budget = {r: solo_restarts for r in my_ranks}
            try:
                for r in my_ranks:
                    procs[r] = _spawn_rank(r, rnd, 0)
            except BaseException:
                _teardown(procs)
                raise
            monitor = None
            if heartbeat_timeout > 0 and my_ranks:
                from ..resilience.heartbeat import HeartbeatMonitor
                monitor = HeartbeatMonitor(store, graph.world,
                                           timeout=heartbeat_timeout,
                                           generation=rnd,
                                           ranks=(my_ranks if nnodes > 1
                                                  else None))
            exit_code = 0
            done: set = set()
            last_hb = 0.0
            last_remote = 0.0
            fail_key = f"{_ROLES_PREFIX}/fail/{rnd}"

            def fail_round(r):
                try:
                    store.set(down_key(rnd, r), b"1")
                    if nnodes > 1:
                        store.set(fail_key, str(node_id).encode())
                except Exception:
                    pass
            try:
                while len(done) < len(my_ranks) and exit_code == 0:
                    for r, p in procs.items():
                        if r in done:
                            continue
                        rc = p.poll()
                        if rc is None:
                            continue
                        if rc == 0:
                            done.add(r)
                            if monitor is not None:
                                monitor.mark_done(r)
                            continue
                        role, _ = graph.role_of(r)
                        policy = graph.role(role).restart
                        if policy == "solo" and solo_budget[r] > 0:
                            # no down_key clean-up on either solo path:
                            # down markers are posted only once the round
                            # is failing, and live in its own generation
                            _solo_restart(r, rc, graph, incarnation,
                                          solo_budget)
                            if monitor is not None:
                                _clear_stale_heartbeat(store, rnd, r)
                                monitor.reset_rank(r)
                            procs[r] = _spawn_rank(r, rnd, incarnation[r])
                            continue
                        exit_code = rc
                        _log(f"rank {r} ({graph.label(r)}) exited rc={rc}; "
                             f"restart policy '{policy}'"
                             + (" (solo budget spent)" if policy == "solo"
                                else "")
                             + " — failing the gang round")
                        fail_round(r)
                        break
                    if (monitor is not None and exit_code == 0
                            and time.monotonic() - last_hb
                            > min(0.5, heartbeat_timeout / 4)):
                        last_hb = time.monotonic()
                        for lost in monitor.poll():
                            r = lost.rank
                            if r in done or procs[r].poll() is not None:
                                continue  # exit handling owns dead procs
                            role, _ = graph.role_of(r)
                            policy = graph.role(role).restart
                            _log(f"RankLostError: {lost} "
                                 f"(role {graph.label(r)}, "
                                 f"policy '{policy}')")
                            reap_process(procs[r])
                            if policy == "solo" and solo_budget[r] > 0:
                                _solo_restart(r, "hung", graph, incarnation,
                                              solo_budget)
                                _clear_stale_heartbeat(store, rnd, r)
                                monitor.reset_rank(r)
                                procs[r] = _spawn_rank(r, rnd,
                                                       incarnation[r])
                            else:
                                exit_code = 1
                                fail_round(r)
                            break
                    if (nnodes > 1 and exit_code == 0
                            and time.monotonic() - last_remote > 0.5):
                        # a gang-policy death on ANY node fails the round
                        # everywhere: poll the round's fail key and tear
                        # this node's span down on sight
                        last_remote = time.monotonic()
                        try:
                            if store.check(fail_key):
                                exit_code = 1
                                _log(f"gang failure reported by another "
                                     f"node (round {rnd}); stopping node "
                                     f"{node_id}'s ranks")
                        except Exception:
                            pass
                    if len(done) < len(my_ranks) and exit_code == 0:
                        time.sleep(0.05)
            except BaseException:
                # a respawn or store failure inside supervision must not
                # orphan the rest of the graph
                _teardown(procs)
                raise
            if exit_code == 0 and nnodes == 1:
                return 0
            if exit_code != 0:
                _settle_obs_dumps(obs_dir, rnd, procs,
                                  [r for r in procs if r not in done])
                _teardown(procs)
            if nnodes > 1:
                failed = _agree_round(store, rnd, node_id, nnodes, exit_code)
                if failed is None:
                    return exit_code or 1
                if not failed:
                    _exit_sync(store, rnd, node_id, nnodes)
                    return 0
                # our span may have finished clean while a peer's gang
                # failed after our arrival: the round failed here too
                exit_code = exit_code or 1
                if gang_restarts >= max_restarts:
                    _exit_sync(store, rnd, node_id, nnodes)
                    return exit_code
                gang_restarts += 1
                _log(f"gang round {rnd} failed (rc={exit_code}); gang "
                     f"restart {gang_restarts}/{max_restarts} agreed across "
                     f"{nnodes} nodes — generation advances")
                try:
                    go_k = f"{_ROLES_PREFIX}/go/{rnd}"
                    if node_id == 0:
                        _reset_round_state(store, rnd)
                        store.set(go_k, b"1")
                    else:
                        # spawn only after node 0's control-plane reset
                        store.wait([go_k], timeout=_AGREE_TIMEOUT)
                except Exception as e:
                    _log(f"cross-launcher restart handshake failed ({e!r}); "
                         f"giving up")
                    return exit_code
            else:
                if gang_restarts >= max_restarts:
                    return exit_code
                gang_restarts += 1
                _log(f"gang round {rnd} failed (rc={exit_code}); gang "
                     f"restart {gang_restarts}/{max_restarts} — generation "
                     f"advances")
                _reset_round_state(store, rnd)
            rnd += 1
            if restart_backoff > 0:
                time.sleep(min(restart_backoff * 2 ** (gang_restarts - 1),
                               10.0))
    finally:
        if owns_store:
            try:
                store.close()
            except Exception:
                pass

