"""``python -m tpu_dist_torch.launch`` — the torch.distributed.launch CLI;
counterpart of ``tpu_dist/launch/cli.py``, with the same flags, the same
env contract and the same store keys.

The reference tutorial's second launch mode::

    python -m tpu_dist_torch.launch --nproc_per_node=1 --nnodes=2 \\
        --node_rank=0 --master_addr=HOST --master_port=22222 \\
        -m tpu_dist_torch.examples.launch_dist

Each child gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_WORLD_SIZE``, ``NODE_RANK`` and
``TPU_DIST_RESTART_COUNT``, then calls ``init_process_group(init_method=
'env://')``; one process drives one card, ``cuda:LOCAL_RANK``.
``--pass_local_rank`` also appends ``--local_rank=<n>`` to the script's
argv (the classic contract; env-only delivery is the default, as torchrun
does).  The launcher itself never touches the card.

**Control-plane TCPStore** (on by default; ``--no_store`` disables): the
node-0 launcher hosts a :class:`~tpu_dist_torch.dist.store.TCPStore`
server (C++ when g++ builds it, Python otherwise) and passes its address
to every child as ``TPU_DIST_STORE_ADDR``.  It is not torch's c10d store,
which rank 0 hosts on ``MASTER_PORT``; it carries:

- **MASTER_PORT negotiation**: ``--master_port=0`` makes node 0 pick a free
  port; other nodes read it from the store (a fixed ``--store_port`` is
  needed then, as the store is the only known address).  Under this store
  the port's ``init_process_group`` does not bind MASTER_PORT: global rank
  0 binds torch's store on a port the OS picks and publishes that port in
  this store for the others, so no other socket can take the port between
  the launcher's pick and the bind (MASTER_PORT stays set for any script
  that starts ``torch.distributed`` itself);
- **worker liveness**: children check in under ``tpu_dist/alive/<rank>``
  during rendezvous; if the world has not fully checked in after
  ``--liveness_warn`` seconds the launcher names the missing ranks;
- **pre-flight and teardown barriers** inside the children's
  ``init_process_group``/``destroy_process_group``
  (tpu_dist_torch/dist/rendezvous.py);
- **supervised restarts** (``--max_restarts``): the generation under
  ``tpu_dist/generation``, and across nodes the launchers' agreement on
  each restart round;
- the **elastic world** (``--elastic_world MIN:MAX``): a rank exiting
  ``PREEMPTED_EXIT_CODE`` re-forms the gang at the survivors, one exiting
  ``GROW_EXIT_CODE`` at MAX, outside the restart budget, with the workers'
  reshard plan printed beside the restart log; across nodes the re-form is
  a cluster decision (:func:`tpu_dist_torch.cluster.membership.elastic_plan`
  over every node's counts), and a node may idle at zero ranks;
- the **serving gateway**'s backend registry (``--serve``).

- the **flight recorder**'s store tails (``--flight-recorder``): on a failed
  round the launcher asks the live workers for their dumps (SIGUSR1) before
  the teardown, and prints each rank's last known position;
- the **collective sanitizer**'s signatures (``--sanitize``);
- **role graphs** (``--roles``, ``--role_script``, ``--solo_restarts``):
  :func:`tpu_dist_torch.roles.spawn_graph` supervises the graph instead of
  one SPMD world; across nodes each launcher runs its node's ``@node``
  pins.

**The cluster** (:mod:`tpu_dist_torch.cluster`): ``--store_endpoints=FILE``
makes every launcher and worker a client of the store leader named by the
endpoints file, re-resolved on every reconnect, so a failover between node
agents (``python -m tpu_dist_torch.cluster.agent``) is transparent;
``--store_replica`` runs that control plane inside the launchers (node 0
hosts the replicating store, the others a follower and an agent).
``--netchaos`` exports ``TPU_DIST_NETCHAOS`` to every worker.

**The pre-flight**: ``--verify_graph`` model-checks the role graph with
the protocol verifier (:mod:`tpu_dist_torch.analysis.protocol`) before
anything is spawned and refuses a graph with an error-severity finding
(exit 2); pipelined graphs (two or more ``stageN`` roles) get it
automatically unless ``--no_verify_graph`` is given.

The names are the JAX package's, so either package's launcher starts either
package's workers.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..roles.launcher import reap_process

__all__ = ["main", "build_parser", "reap_process"]

# seconds a torn-down round's ranks get between SIGTERM and SIGKILL: a rank
# blocked inside a collective (NCCL or gloo) cannot run a Python TERM handler
# until the call returns, which it never does once a peer is gone
_KILL_GRACE = 15.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.launch",
        description="Launch a script across processes/nodes with the "
                    "RANK/LOCAL_RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT "
                    "env contract (torch.distributed.launch parity).")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes on this node, one card each")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master_addr", type=str, default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=29500,
                   help="torch.distributed's rendezvous port (rank 0 hosts "
                        "its c10d store there); 0 = negotiate a free port "
                        "via the control-plane store (node 0 picks, others "
                        "read)")
    p.add_argument("--store_port", type=int, default=0,
                   help="control-plane TCPStore port on node 0 (0 = free "
                        "port single-node, master_port+1 multi-node)")
    p.add_argument("--no_store", action="store_true",
                   help="disable the control-plane store (no port "
                        "negotiation, liveness, or pre-flight)")
    p.add_argument("--store_endpoints", type=str, default=None,
                   metavar="PATH",
                   help="cluster endpoints file (tpu_dist_torch.cluster): "
                        "the launcher and every worker resolve the store "
                        "LEADER from this file and re-resolve it on "
                        "reconnect, so a leader failover (node agents and "
                        "follower replicas, python -m "
                        "tpu_dist_torch.cluster.agent) is transparent. With "
                        "this flag the launcher never hosts the store "
                        "itself unless --store_replica makes node 0 the "
                        "initial leader")
    p.add_argument("--store_replica", action="store_true",
                   help="run the cluster control plane inside the launcher "
                        "(needs --store_endpoints): node 0 hosts the store "
                        "with the replication log armed and writes the "
                        "endpoints file; every other node runs a follower "
                        "replica and a node agent and can be elected "
                        "leader if node 0's store dies")
    p.add_argument("--liveness_warn", type=float, default=60.0,
                   help="seconds before the node-0 launcher reports ranks "
                        "that have not checked in to the store")
    p.add_argument("--pass_local_rank", action="store_true",
                   help="append --local_rank=<n> to the script args "
                        "(classic torch.distributed.launch argv contract)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch the whole world up to N times after a "
                        "worker failure. Multi-node: the launchers agree "
                        "on each restart round through the control-plane "
                        "store (run every node with the SAME "
                        "--max_restarts; needs the store). Children see "
                        "TPU_DIST_RESTART_COUNT and should resume from "
                        "their latest checkpoint")
    p.add_argument("--elastic_world", type=str, default=None,
                   metavar="MIN:MAX",
                   help="elastic world-size range (single-node). A worker "
                        "exiting with PREEMPTED_EXIT_CODE (117: preempted "
                        "for good; the chaos `shrink` fault) re-forms the "
                        "gang at the surviving rank count instead of "
                        "burning --max_restarts relaunching a world that "
                        "can never fill; GROW_EXIT_CODE (118: capacity "
                        "returned; the chaos `grow` fault) re-forms at MAX. "
                        "World-size changes don't count against "
                        "--max_restarts. Workers resume from sharded "
                        "checkpoints via elastic resharding "
                        "(resilience.TrainState). Multi-node: every "
                        "launcher publishes its node's counts and all run "
                        "the same cluster plan (a node may idle at 0 "
                        "ranks); MAX must be nproc_per_node*nnodes")
    p.add_argument("--elastic_timeout", type=float, default=120.0,
                   help="seconds to wait for every launcher to join the "
                        "restart agreement before giving up (multi-node "
                        "--max_restarts only)")
    p.add_argument("--restart_backoff", type=float, default=1.0,
                   help="base seconds between restart rounds; doubles each "
                        "round (capped at 30s) with up to 25%% jitter")
    p.add_argument("--heartbeat_timeout", type=float, default=0.0,
                   help="seconds of heartbeat silence after which a worker "
                        "counts as lost (RankLostError): the supervisor "
                        "kills the gang and, with --max_restarts, "
                        "relaunches it. Needs the store and workers that "
                        "publish heartbeats (resilience.Heartbeat; exported "
                        "to them as TPU_DIST_HEARTBEAT_TIMEOUT). 0 disables")
    p.add_argument("--sanitize", action="store_true",
                   help="cross-rank collective sanitizer: every eager host "
                        "collective checks a per-call signature (op, tree, "
                        "dtypes/shapes, root, wire format) across ranks "
                        "through the store before any payload moves, and "
                        "raises CollectiveMismatchError naming the "
                        "divergent rank and call-site instead of hanging "
                        "(TPU_DIST_SANITIZE=1 in every worker). Needs the "
                        "store")
    p.add_argument("--coll_timeout", type=float, default=0.0,
                   help="end-to-end collective watchdog in every worker "
                        "(TPU_DIST_COLL_TIMEOUT, seconds): a host ring, "
                        "tree or store collective that cannot finish "
                        "within the budget raises a named "
                        "CollectiveTimeoutError naming the stalled hop "
                        "instead of waiting out the per-frame "
                        "TPU_DIST_DP_TIMEOUT. 0 disables")
    p.add_argument("--netchaos", type=str, default=None,
                   help="deterministic network fault injection in every "
                        "worker (TPU_DIST_NETCHAOS, tpu_dist_torch/"
                        "resilience/netchaos.py): partition/delay/"
                        "conn-reset/truncate/corrupt/slow-drip faults "
                        "scoped by rank/peer/node/surface/frame, e.g. "
                        "'corrupt:surface=tcp,rank=1,frame=3'. The NCCL "
                        "route has no surface")
    p.add_argument("--flight-recorder", "--flight_recorder",
                   dest="flight_recorder", action="store_true",
                   help="per-rank flight recorder (tpu_dist_torch.obs, "
                        "TPU_DIST_OBS=1 in every worker): a ring buffer of "
                        "collective/p2p/store events dumped on crash, hang "
                        "(SIGUSR1 from this launcher on a failed round) and "
                        "exit to TPU_DIST_OBS_DIR (default ./tpu_dist_obs); "
                        "a failed round prints every rank's last known "
                        "position from its store tail. Read the dumps with "
                        "python -m tpu_dist_torch.obs diagnose")
    p.add_argument("--serve", action="store_true",
                   help="start the serving gateway role alongside the "
                        "workers (python -m tpu_dist_torch.serve gateway): "
                        "a client-facing proxy on --serve_port that "
                        "resolves the model rank's frontend through the "
                        "store's backend registry and survives worker "
                        "restarts — requests in flight at a model rank's "
                        "death fail with a named BackendGoneError, new "
                        "ones reach the relaunched rank. Needs the store")
    p.add_argument("--serve_port", type=int, default=0,
                   help="gateway's client-facing port (0 = ephemeral; the "
                        "bound address is published to the store under "
                        "tpu_dist/serve/gateway)")
    p.add_argument("--roles", type=str, default=None,
                   metavar="NAME:WORLD[:POLICY],...",
                   help="launch a heterogeneous role graph "
                        "(tpu_dist_torch.roles) instead of one SPMD world, "
                        "e.g. learner:1,actor:4:solo. Roles own contiguous "
                        "global-rank spans in order; POLICY is gang "
                        "(default: a death restarts the whole graph, "
                        "budgeted by --max_restarts) or solo (the dead rank "
                        "is respawned alone in the same generation). "
                        "Workers call init_role_graph(). Needs the store. "
                        "Across nodes, ROLE:WORLD@NODE pins a role to a "
                        "node; every launcher runs the same spec")
    p.add_argument("--role_script", action="append", default=[],
                   metavar="ROLE=SCRIPT",
                   help="per-role entrypoint override for --roles "
                        "(repeatable); other roles run the main script")
    p.add_argument("--solo_restarts", type=int, default=2,
                   help="per-rank respawn budget of solo-policy roles within "
                        "one generation (--roles)")
    p.add_argument("--verify_graph", "--verify-graph", action="store_true",
                   help="statically model-check the role graph before "
                        "spawning anything (tpu_dist_torch.analysis."
                        "protocol): the graph is the script's "
                        "build_graph() when it has one, else the --roles "
                        "spec with the script's ChannelSpec literals, "
                        "checked for bounded-queue deadlock cycles (TD101, "
                        "witness schedule printed), claim-safety, "
                        "restart-policy and placement soundness.  Any "
                        "error-severity finding REFUSES the launch with "
                        "exit 2 (--roles only).  Pipeline launches (>= 2 "
                        "stageN roles) run this pre-flight automatically")
    p.add_argument("--no_verify_graph", "--no-verify-graph",
                   action="store_true",
                   help="skip the automatic --verify_graph pre-flight "
                        "that pipeline launches (>= 2 stageN roles) "
                        "otherwise get")
    p.add_argument("--standalone", action="store_true",
                   help="single-node mode with automatic rendezvous "
                        "(torchrun parity): forces --nnodes=1 "
                        "--node_rank=0 and a free master port")
    p.add_argument("--module", "-m", action="store_true",
                   help="treat script as a python module (python -m ...)")
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def _log(msg: str) -> None:
    sys.stderr.write(f"[tpu_dist_torch.launch] {msg}\n")
    sys.stderr.flush()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _setup_store(args):
    """Host (node 0) or connect to the control-plane store.

    Returns ``(store, master_port, store_addr)``; ``store`` is None when
    disabled or unavailable (a warning is printed: the store is
    diagnostics and negotiation, not the data path)."""
    if args.no_store:
        if args.master_port == 0:
            sys.stderr.write("--master_port=0 needs the store for "
                             "negotiation; drop --no_store or pick a port\n")
            return None, None, None
        return None, args.master_port, None

    from ..dist.store import TCPStore

    if args.store_endpoints and (args.node_rank > 0
                                 or not args.store_replica):
        # cluster mode: the leader is the endpoints file's (node agents',
        # or node 0's launcher under --store_replica).  Every launcher is
        # a client; the workers inherit the endpoints env and re-resolve
        # on reconnect — that is the failover
        from ..cluster import endpoints as _cep
        os.environ[_cep.ENDPOINTS_ENV] = args.store_endpoints
        deadline = time.monotonic() + 60.0
        addr = _cep.leader_addr(args.store_endpoints)
        while addr is None and time.monotonic() < deadline:
            time.sleep(0.2)
            addr = _cep.leader_addr(args.store_endpoints)
        if addr is None:
            sys.stderr.write(f"no store leader appeared in "
                             f"{args.store_endpoints!r}\n")
            return None, None, None
        try:
            store = TCPStore(addr[0], addr[1], timeout=120.0)
            if args.node_rank == 0:
                master_port = (_free_port() if args.master_port == 0
                               else args.master_port)
                store.set("tpu_dist/master_port", str(master_port))
            elif args.master_port == 0:
                master_port = int(store.get("tpu_dist/master_port"))
            else:
                master_port = args.master_port
            return store, master_port, f"{addr[0]}:{addr[1]}"
        except Exception as e:
            sys.stderr.write(f"store setup failed ({e!r}) against cluster "
                             f"leader {addr[0]}:{addr[1]}\n")
            return None, None, None

    try:
        if args.node_rank == 0:
            port = args.store_port or (args.master_port + 1
                                       if args.nnodes > 1 else 0)
            if (args.master_port == 0 and args.nnodes > 1
                    and not args.store_port):
                sys.stderr.write(
                    "--master_port=0 with --nnodes>1 requires an explicit "
                    "--store_port (the store is then the only known "
                    "address)\n")
                return None, None, None
            store = TCPStore(args.master_addr, port, is_master=True)
            master_port = (_free_port() if args.master_port == 0
                           else args.master_port)
            store.set("tpu_dist/master_port", str(master_port))
            return store, master_port, f"{args.master_addr}:{store.port}"
        if args.master_port == 0 and not args.store_port:
            sys.stderr.write("--master_port=0 with --node_rank>0 requires "
                             "the --store_port used on node 0\n")
            return None, None, None
        port = args.store_port or args.master_port + 1
        if args.master_port == 0:
            # the store is the only known address: connect and read the
            # negotiated port (node 0 may start later: a generous timeout)
            store = TCPStore(args.master_addr, port, timeout=120.0)
            master_port = int(store.get("tpu_dist/master_port"))
        elif ((args.max_restarts > 0 or args.elastic_world or args.roles)
              and args.nnodes > 1):
            # the restart or world agreement (or the gang rounds) rides the
            # store from EVERY launcher
            store = TCPStore(args.master_addr, port, timeout=120.0)
            master_port = args.master_port
        else:
            # a fixed port: the store's address is known, so hand it to the
            # children without blocking this launcher on a connect
            store, master_port = None, args.master_port
        return store, master_port, f"{args.master_addr}:{port}"
    except Exception as e:
        if args.master_port == 0:
            sys.stderr.write(f"store setup failed ({e!r}); cannot negotiate "
                             f"--master_port=0\n")
            return None, None, None
        sys.stderr.write(f"store setup failed ({e!r}); launching without "
                         f"liveness/pre-flight diagnostics\n")
        return None, args.master_port, None


def _check_liveness(store, world_size: int) -> List[int]:
    """Ranks that have NOT checked in to the store."""
    try:
        return [r for r in range(world_size)
                if not store.check(f"tpu_dist/alive/{r}")]
    except Exception:
        return []


def _spawn_world(args, world_size: int, master_port: int,
                 store_addr: Optional[str], restart_count: int,
                 nproc: int, base_rank: int) -> List[subprocess.Popen]:
    """Spawn this node's ranks (``nproc`` of them: an elastic world may run
    fewer than ``--nproc_per_node``, from ``base_rank``, where the cluster's
    elastic plan put this node's span); on a partial failure kill the ranks
    already spawned (never leave them waiting in the rendezvous) and
    re-raise."""
    procs: List[subprocess.Popen] = []
    try:
        for local_rank in range(nproc):
            env = dict(os.environ,
                       RANK=str(base_rank + local_rank),
                       LOCAL_RANK=str(local_rank),
                       WORLD_SIZE=str(world_size),
                       LOCAL_WORLD_SIZE=str(nproc),
                       NODE_RANK=str(args.node_rank),
                       MASTER_ADDR=args.master_addr,
                       MASTER_PORT=str(master_port),
                       TPU_DIST_RESTART_COUNT=str(restart_count))
            if store_addr is not None:
                env["TPU_DIST_STORE_ADDR"] = store_addr
            if args.heartbeat_timeout > 0:
                env["TPU_DIST_HEARTBEAT_TIMEOUT"] = str(
                    args.heartbeat_timeout)
            env.update(_diagnostic_env(args))
            if getattr(args, "obs_dir", None):
                env["TPU_DIST_OBS"] = "1"
                env["TPU_DIST_OBS_DIR"] = args.obs_dir
            cmd = [sys.executable]
            cmd += ["-m", args.script] if args.module else [args.script]
            cmd += args.script_args
            if args.pass_local_rank:
                cmd += [f"--local_rank={local_rank}"]
            procs.append(subprocess.Popen(cmd, env=env))
    except BaseException:
        for p in procs:
            if p.poll() is None:
                reap_process(p)
        raise
    return procs


def _diagnostic_env(args) -> Dict[str, str]:
    """The worker env of the opt-in diagnostic layers (sanitizer, collective
    watchdog, network chaos): one assembly shared by the SPMD spawn path
    and the --roles path, so a new knob cannot apply to only one of them."""
    env: Dict[str, str] = {}
    if getattr(args, "sanitize", False):
        env["TPU_DIST_SANITIZE"] = "1"
    if getattr(args, "coll_timeout", 0) > 0:
        env["TPU_DIST_COLL_TIMEOUT"] = str(args.coll_timeout)
    if getattr(args, "netchaos", None):
        env["TPU_DIST_NETCHAOS"] = args.netchaos
    return env


def _request_obs_dumps(args, procs: List[subprocess.Popen], remaining,
                       rnd: int, base_rank: int) -> None:
    """Ask the still-alive workers to flush their flight recorders (SIGUSR1)
    before the TERM/KILL teardown, then wait (settle-bounded) for the dump
    files.  Armed runs only: a worker that never installed the handler
    would die on USR1."""
    if getattr(args, "obs_dir", None) is None:
        return
    from ..obs.hooks import request_dumps
    from ..obs.recorder import dump_path
    request_dumps((procs[j], dump_path(args.obs_dir, rnd, base_rank + j))
                  for j in remaining)


def _report_obs(args, store, world_size: int, rnd: int) -> None:
    """The per-rank "last known position" table from the flight-recorder
    tails under ``tpu_dist/g{rnd}/obs/{rank}``, printed on a failed round
    before the generation's keyspace is reaped."""
    if args.obs_dir is not None:
        _log(f"flight-recorder dumps in {args.obs_dir} (merge/diagnose: "
             f"python -m tpu_dist_torch.obs diagnose --dir {args.obs_dir})")
    if store is None:
        return
    from ..obs.hooks import fetch_tail, render_tail
    rows = [(r, fetch_tail(store, rnd, r)) for r in range(world_size)]
    if all(t is None for _, t in rows):
        return  # recorder disarmed (or no tail made it): stay quiet
    # role names from the published role map, when there is one
    labels = {}
    try:
        from ..roles.graph import RoleGraph, map_key
        key = map_key(rnd)
        if store.check(key):
            g = RoleGraph.from_json(store.get(key))
            labels = {r: g.label(r) for r in range(min(world_size, g.world))}
    except Exception:
        labels = {}
    _log(f"last known positions (generation {rnd}):")
    for r, tail in rows:
        if tail is None:
            desc = "no obs tail posted"
        else:
            try:
                desc = render_tail(tail)
            except Exception:
                desc = str(tail)
        who = f"rank {r} ({labels[r]})" if r in labels else f"rank {r}"
        sys.stderr.write(f"  {who}: {desc}\n")


def _watch_world(args, procs: List[subprocess.Popen], store,
                 world_size: int, rnd: int, base_rank: int):
    """Watch one round until every rank exits → ``(exit_code,
    interrupted, rcs)``; ``interrupted`` tells a Ctrl-C of the launcher
    (never restarted) from a worker that exited 130, and ``rcs`` holds each
    local rank's exit code as reaped BEFORE the launcher's own teardown
    (``None`` after it: an exit code answering our TERM is not a
    preemption), so ``--elastic_world`` can tell preempted ranks (117) and
    grow requests (118) from crashes.

    Fail fast: the first non-zero exit tears the rest down, SIGTERM and
    then, after ``_KILL_GRACE`` seconds, SIGKILL — a rank blocked in a
    collective whose peer is gone ignores TERM until the call returns.
    Multi-node with ``--max_restarts`` or ``--elastic_world``: a launcher
    that sees a local worker die publishes the round's failure key; every
    launcher polls it and tears its own workers down, so the world stops
    together (a preemption on one node must stop every node, so that the
    world re-forms as one).  With
    ``--heartbeat_timeout``, a rank that is alive but silent is lost
    (``RankLostError``) and fails the round the same way.

    ``--elastic_world``: preemptions come in batches, so when the first
    failing exit is the elastic protocol (117/118) the teardown waits a
    settle window (``TPU_DIST_PREEMPT_SETTLE``, 2 s) for the siblings' own
    exits before TERMing the rest; any other crash tears down at once."""
    from ..resilience.chaos import GROW_EXIT_CODE, PREEMPTED_EXIT_CODE
    elastic_rcs = (PREEMPTED_EXIT_CODE, GROW_EXIT_CODE)
    try:
        settle = float(os.environ.get("TPU_DIST_PREEMPT_SETTLE", "2.0"))
    except ValueError:
        settle = 2.0
    teardown_at = None    # when to TERM the still-running ranks
    teardown_done = False
    pre_teardown_rcs = {}
    exit_code = 0
    interrupted = False
    t0 = time.monotonic()
    kill_deadline = None
    liveness_reported = (world_size <= 1 or store is None
                         or args.node_rank != 0)
    multi_node = ((args.max_restarts > 0 or args.elastic_world)
                  and args.nnodes > 1 and store is not None)
    fail_key = f"tpu_dist/elastic/fail/{rnd}"
    last_remote_check = 0.0
    remote_failed = False
    # the heartbeat watchdog: ranks not yet beating get max(timeout,
    # liveness_warn) of grace (a worker imports torch before its first beat)
    monitor = None
    hb_poll_every = 0.0
    last_hb_check = 0.0
    if args.heartbeat_timeout > 0 and store is not None:
        from ..resilience.heartbeat import HeartbeatMonitor
        monitor = HeartbeatMonitor(
            store, world_size, timeout=args.heartbeat_timeout,
            generation=rnd,
            startup_grace=max(args.heartbeat_timeout, args.liveness_warn),
            ranks=range(base_rank, base_rank + len(procs)))
        hb_poll_every = min(0.5, args.heartbeat_timeout / 4)

    def teardown(remaining):
        nonlocal kill_deadline, teardown_done
        teardown_done = True
        _request_obs_dumps(args, procs, remaining, rnd, base_rank)
        for j in remaining:
            procs[j].terminate()
        kill_deadline = time.monotonic() + _KILL_GRACE

    def publish_failure():
        if multi_node:
            try:
                store.set(fail_key, str(args.node_rank).encode())
            except Exception:
                pass

    try:
        remaining = set(range(len(procs)))
        while remaining:
            if (not liveness_reported
                    and time.monotonic() - t0 > args.liveness_warn):
                liveness_reported = True
                missing = _check_liveness(store, world_size)
                if missing:
                    _log(f"after {args.liveness_warn:.0f}s ranks {missing} "
                         f"have not reached rendezvous (checked-in: "
                         f"{world_size - len(missing)}/{world_size}); check "
                         f"--nnodes/--node_rank on every node")
            for i in list(remaining):
                rc = procs[i].poll()
                if rc is None:
                    continue
                remaining.discard(i)
                if not teardown_done:
                    pre_teardown_rcs[i] = rc
                if rc == 0 and monitor is not None:
                    # a finished rank is done, not lost
                    monitor.mark_done(base_rank + i)
                if rc != 0:
                    if exit_code == 0:
                        exit_code = rc
                        publish_failure()
                    if args.elastic_world and rc in elastic_rcs:
                        # batched preemption: let sibling 117/118s land
                        # before tearing down, so the survivor count (the
                        # re-formed world size) is right
                        if teardown_at is None:
                            teardown_at = time.monotonic() + settle
                    else:
                        teardown_at = time.monotonic()
            if (teardown_at is not None and not teardown_done
                    and time.monotonic() >= teardown_at):
                teardown(remaining)
            if (multi_node and exit_code == 0 and not remote_failed
                    and time.monotonic() - last_remote_check > 0.5):
                last_remote_check = time.monotonic()
                try:
                    if store.check(fail_key):
                        remote_failed = True
                        _log("another node reported a worker failure; "
                             "stopping local workers")
                        teardown(remaining)
                except Exception:
                    pass
            if (monitor is not None and exit_code == 0 and not remote_failed
                    and time.monotonic() - last_hb_check > hb_poll_every):
                last_hb_check = time.monotonic()
                lost = monitor.poll()
                if lost:
                    monitor = None  # diagnosed; stop polling
                    _log(f"RankLostError: {lost[0]}")
                    exit_code = 1
                    publish_failure()
                    teardown(remaining)
            if (kill_deadline is not None
                    and time.monotonic() > kill_deadline):
                for j in remaining:
                    if procs[j].poll() is None:
                        procs[j].kill()
            if remaining:
                try:
                    procs[next(iter(remaining))].wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    pass
        if remote_failed and exit_code == 0:
            exit_code = 1  # this node restarts/exits with the group
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        deadline = time.monotonic() + _KILL_GRACE
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                reap_process(p)
        exit_code = 130
        interrupted = True
    return exit_code, interrupted, [pre_teardown_rcs.get(i)
                                    for i in range(len(procs))]


def _report_reshard_plan(store, new_world: int) -> None:
    """Print the elastic resharding plan next to the restart log
    (best-effort diagnostics): the workers published their checkpoint root
    under ``tpu_dist/elastic/ckpt_root`` (resilience.TrainState); from the
    newest locally resumable step's manifest the supervisor derives the
    old-world → ``new_world`` fragment plan the re-formed gang will run."""
    if store is None:
        return
    try:
        if not store.check("tpu_dist/elastic/ckpt_root"):
            return
        root = store.get("tpu_dist/elastic/ckpt_root").decode()
        from ..resilience import reshard
        vis = reshard.local_visibility(root)
        steps = reshard.resumable_steps([vis])
        if not steps:
            return
        step = max(steps)
        manifest = None
        for o in sorted(vis["shards"]):
            if vis["shards"][o].get(step) == steps[step]:
                manifest = reshard.load_manifest(root, step, o)
                if manifest is not None:
                    break
        if manifest is None:
            return
        for line in reshard.plan_summary(manifest, new_world).splitlines():
            _log(line)
    except Exception as e:  # a summary must never block the restart
        _log(f"reshard plan summary unavailable ({e!r})")


def _elastic_new_world(elastic_range, cur_world: int,
                       rcs: List[Optional[int]]) -> Optional[int]:
    """The world size the next round re-forms at, or None when this failed
    round is not an elastic world change (an ordinary crash: the restart
    budget applies).  The JAX launcher's rule, rule for rule: a rank exiting
    PREEMPTED_EXIT_CODE (117) is gone for good — re-form at the survivors
    (clamped to MIN: below it there is no legal world, so the round falls
    back to a budgeted full-world restart); GROW_EXIT_CODE (118) means
    capacity is back — re-form at MAX, but a simultaneous preemption wins
    (the grow came from a world that no longer exists)."""
    if elastic_range is None:
        return None
    from ..resilience.chaos import GROW_EXIT_CODE, PREEMPTED_EXIT_CODE
    lo, hi = elastic_range
    preempted = sum(1 for rc in rcs if rc == PREEMPTED_EXIT_CODE)
    if preempted:
        surviving = cur_world - preempted
        if surviving < lo:
            _log(f"{preempted} rank(s) preempted but {surviving} survivors "
                 f"is below --elastic_world MIN {lo}; retrying at the full "
                 f"world size")
            return None
        return surviving if surviving != cur_world else None
    if any(rc == GROW_EXIT_CODE for rc in rcs):
        # already at MAX: a redundant grow request is a free same-world
        # relaunch, not a crash
        return hi if hi != cur_world else cur_world
    return None


def _reset_round_state(store, finished_round: Optional[int] = None) -> None:
    """Reset the last round's control-plane state before a restart: the
    liveness marks and the teardown barrier's counter (a partial teardown
    leaves it off-generation, and the next round's first caller would pass
    the barrier early), the finished round's heartbeat keys and its whole
    ``tpu_dist/g{round}/`` keyspace — each one server-side
    ``DELETE_PREFIX`` sweep.  The port's launcher also sweeps
    ``monitored_barrier``'s keys, which are numbered by call and not by
    generation: a stale arrival from the failed round would let rank 0 of
    the next one release a call before its peers arrive, and delete the
    release key a peer still waits on."""
    sweeps = ["tpu_dist/alive/", "__monitored_barrier__/"]
    if finished_round is not None:
        sweeps += [f"tpu_dist/hb/{finished_round}/",
                   f"tpu_dist/g{finished_round}/"]
    for prefix in sweeps:
        try:
            store.delete_prefix(prefix)
        except Exception:
            pass
    try:
        store.delete_key("__barrier__/teardown")
    except Exception:
        pass


def _publish_generation(store, rnd: int) -> None:
    """Fence out stragglers of earlier incarnations: children compare their
    TPU_DIST_RESTART_COUNT with this key at the rendezvous pre-flight."""
    try:
        store.set("tpu_dist/generation", str(rnd))
    except Exception:
        pass


def _restart_backoff(args, restarts: int) -> None:
    """Exponential backoff with jitter before a relaunch round: restart
    storms help nobody, and the jitter de-phases launchers of several
    nodes racing to re-rendezvous."""
    if args.restart_backoff <= 0:
        return
    delay = (min(args.restart_backoff * 2 ** (restarts - 1), 30.0)
             * (1.0 + 0.25 * random.random()))
    _log(f"backing off {delay:.1f}s before restart {restarts}")
    time.sleep(delay)


def _exit_sync(args, store, rnd: int) -> None:
    """Final ack before the launchers leave the agreement: node 0 hosts the
    store and must not tear it down while a peer still polls it."""
    try:
        key = f"tpu_dist/elastic/exit/{rnd}"
        store.add(key, 1)
        if args.node_rank == 0:
            store.wait_value_ge(key, args.nnodes,
                                timeout=min(15.0, args.elastic_timeout))
    except Exception:
        pass  # best effort: at worst the peer takes its noisier error path


def _cluster_agree(args, store, rnd: int, local_rc: int,
                   rcs: List[Optional[int]], cur_nproc: int, restarts: int,
                   negotiated_port: bool, master_port: int, elastic_range):
    """The launchers' end-of-round agreement (multi-node ``--max_restarts``
    or ``--elastic_world``) → ``("done", 0)``, ``("giveup", rc)``,
    ``("restart", new_master_port)`` or ``("reform", (port, world,
    base_rank, nproc))``, on the JAX launcher's round-scoped keys:

    1. with ``--elastic_world`` every launcher publishes its node's round
       counts (preempted 117s, grow 118s, ranks run); a failed node
       publishes ``fail/{rnd}``; every launcher adds itself to
       ``done/{rnd}`` once its workers have exited;
    2. and waits for all ``--nnodes`` (bounded: a vanished machine must
       not hang the rest; an idle node, 0 ranks this round, waits out the
       whole phase unbounded);
    3. the round failed iff anyone published ``fail/{rnd}``; then every
       launcher runs the same pure plan
       (:func:`tpu_dist_torch.cluster.membership.elastic_plan`) over the
       same store-agreed counts and membership records, so all agree which
       node's ranks drop and where each span starts;
    4. to go on, node 0 picks a fresh port when it was negotiated, resets
       the round's keys, then publishes ``go/{rnd}`` with the port and the
       plan; the others respawn only after reading it.

    A re-form does NOT charge the restart budget."""
    from ..cluster import membership as _cm
    from ..resilience.chaos import GROW_EXIT_CODE, PREEMPTED_EXIT_CODE

    prefix = "tpu_dist/elastic"
    idle = cur_nproc == 0
    try:
        if elastic_range is not None:
            _cm.publish_elastic_counts(
                store, rnd, args.node_rank, nproc=cur_nproc,
                full_nproc=args.nproc_per_node,
                preempted=sum(1 for rc in rcs if rc == PREEMPTED_EXIT_CODE),
                grow=any(rc == GROW_EXIT_CODE for rc in rcs))
        if local_rc != 0:
            store.set(f"{prefix}/fail/{rnd}", str(args.node_rank).encode())
        store.add(f"{prefix}/done/{rnd}", 1)
        store.wait_value_ge(f"{prefix}/done/{rnd}", args.nnodes,
                            timeout=None if idle else args.elastic_timeout)
        failed = local_rc != 0 or store.check(f"{prefix}/fail/{rnd}")
        plan = None
        if failed and elastic_range is not None:
            counts = _cm.gather_elastic_counts(store, rnd, args.nnodes,
                                               timeout=args.elastic_timeout)
            plan = _cm.elastic_plan(counts,
                                    _cm.read_nodes(store, args.nnodes),
                                    elastic_range[0], elastic_range[1])
    except Exception as e:
        _log(f"cluster agreement failed ({e!r}); giving up")
        return ("giveup", local_rc or 1)
    if not failed:
        _exit_sync(args, store, rnd)
        return ("done", 0)
    if plan is None and restarts >= args.max_restarts:
        _exit_sync(args, store, rnd)
        return ("giveup", local_rc or 1)
    rc_port = master_port
    try:
        if args.node_rank == 0:
            if negotiated_port:
                rc_port = _free_port()
            _reset_round_state(store, finished_round=rnd)
            store.set(f"{prefix}/go/{rnd}",
                      json.dumps({"port": rc_port,
                                  "plan": ({str(n): list(v)
                                            for n, v in plan.items()}
                                           if plan else None)}).encode())
        else:
            store.wait([f"{prefix}/go/{rnd}"],
                       timeout=None if idle else args.elastic_timeout)
            go = json.loads(store.get(f"{prefix}/go/{rnd}").decode())
            rc_port = int(go["port"])
            # every launcher computed the same plan from the same inputs;
            # node 0's published copy rules out a read racing a late count
            plan = ({int(n): tuple(v) for n, v in go["plan"].items()}
                    if go.get("plan") else None)
    except Exception as e:
        _log(f"cluster restart handshake failed ({e!r}); giving up")
        return ("giveup", local_rc or 1)
    if plan is not None:
        base, nproc = plan.get(args.node_rank, (0, 0))
        return ("reform", (rc_port, sum(n for _, n in plan.values()), base,
                           nproc))
    return ("restart", rc_port)


def _start_sidecar(args, store_addr: str) -> list:
    """The ``--store_replica`` control plane inside the launcher: node 0's
    store is the initial leader (it writes the endpoints file at epoch 0
    and runs a leader's agent); every other node runs a follower replica
    and an agent that can be elected.  Returns what to stop at exit, the
    agent first."""
    from ..cluster import NodeAgent, StoreFollower
    from ..cluster import endpoints as _cep
    if args.node_rank == 0:
        _cep.write_endpoints(args.store_endpoints, store_addr, 0)
        os.environ[_cep.ENDPOINTS_ENV] = args.store_endpoints
        agent = NodeAgent(0, args.store_endpoints,
                          nproc=args.nproc_per_node)
        agent.is_leader.set()
        return [agent.start()]
    addr = _cep.leader_addr(args.store_endpoints)
    follower = StoreFollower(addr[0], addr[1]).start()
    try:
        agent = NodeAgent(args.node_rank, args.store_endpoints,
                          follower=follower,
                          nproc=args.nproc_per_node).start()
    except BaseException:
        follower.stop()
        raise
    return [agent, follower]


def _stop_gateway(proc: Optional[subprocess.Popen]) -> None:
    if proc is not None and proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            reap_process(proc)


def _verify_role_graph(args) -> int:
    """``--verify_graph`` pre-flight: statically model-check the role
    graph and its channel topology (:mod:`tpu_dist_torch.analysis.protocol`)
    BEFORE spawning anything, refusing a provably hazardous graph.  A TD101
    deadlock finding prints its witness schedule — the put/get
    interleaving that wedges every role of the cycle.  With ``-m
    pkg.mod`` the graph is the ``--roles`` spec alone, as in the JAX
    launcher; a note names the graph's source either way."""
    from ..analysis.protocol import build_graph, verify_graph

    src = args.script if (args.script and not args.module
                          and os.path.exists(args.script)) else None
    label = src or "<--roles spec>"
    graph = None
    findings: list = []
    notes: list = []
    if src:
        # a script exporting a module-level build_graph() hands over the
        # REAL graph — builder-constructed ChannelSpecs that literal
        # extraction cannot see.  Anything else falls back to extraction.
        try:
            graph = build_graph(graph_target=f"{src}:build_graph",
                                path=label)[0]
            notes.append(f"graph from {src}:build_graph()")
        except Exception:
            graph = None
    if graph is None:
        graph, findings, notes = build_graph(roles_spec=args.roles,
                                             script=src, path=label)
        notes = ["graph from the --roles spec"
                 + (f" and {src}'s ChannelSpec literals" if src else "")
                 ] + notes
    if graph is not None:
        findings = list(findings) + verify_graph(graph, nnodes=args.nnodes,
                                                 path=label)
    for note in notes:
        sys.stderr.write(f"--verify_graph: note: {note}\n")
    for f in findings:
        sys.stderr.write(f.render() + "\n")
    errors = [f for f in findings if f.severity == "error"
              and not f.suppressed]
    if errors:
        sys.stderr.write(
            f"--verify_graph: refusing to launch — {len(errors)} "
            f"error-severity protocol finding(s) above (run "
            f"'python -m tpu_dist_torch.analysis graph' for the full "
            f"report)\n")
        return 2
    return 0


def _run_role_graph(args) -> int:
    """``--roles``: launch a heterogeneous role graph instead of one SPMD
    world.  The graph supervisor (:func:`tpu_dist_torch.roles.spawn_graph`)
    owns the store, the role-map publication and per-role restart routing;
    this wrapper validates the CLI surface and assembles the worker env
    and argv.  With ``--serve`` the gateway rides outside the graph's
    restart loop, on the same store."""
    from ..roles import RoleGraphError, parse_roles_spec, spawn_graph

    if args.no_store:
        sys.stderr.write("--roles needs the control-plane store (role map, "
                         "channels, liveness); drop --no_store\n")
        return 2
    if args.elastic_world:
        sys.stderr.write("--roles and --elastic_world are mutually "
                         "exclusive: per-role restart policy IS the "
                         "elastic story for role graphs\n")
        return 2
    if args.max_restarts < 0 or args.solo_restarts < 0:
        sys.stderr.write("restart budgets must be >= 0\n")
        return 2
    try:
        graph = parse_roles_spec(args.roles)
    except RoleGraphError as e:
        sys.stderr.write(f"--roles: {e}\n")
        return 2
    # pipeline launches (>= 2 stageN roles) get the pre-flight
    # automatically: a mis-depthed act/grad ring deadlocks every stage,
    # so refusing before spawn with a witness beats hanging after
    pipelined = sum(1 for r in graph.roles
                    if re.fullmatch(r"stage\d+", r.name)) >= 2
    if args.verify_graph or (pipelined and not args.no_verify_graph):
        rc = _verify_role_graph(args)
        if rc:
            return rc
    argv = [sys.executable]
    argv += ["-m", args.script] if args.module else [args.script]
    argv += args.script_args
    role_argv = {}
    for spec in args.role_script:
        name, _, script = spec.partition("=")
        if not script:
            sys.stderr.write(f"--role_script must be ROLE=SCRIPT, got "
                             f"{spec!r}\n")
            return 2
        try:
            graph.role(name)
        except RoleGraphError as e:
            sys.stderr.write(f"--role_script: {e}\n")
            return 2
        role_argv[name] = [sys.executable, script] + list(args.script_args)
    store = None
    store_addr = None
    gateway_proc = None
    if args.nnodes > 1:
        # multi-node placement: @node pins decide which launcher supervises
        # which span (unpinned roles are node 0's), and every launcher
        # validates the same pins against the same cluster size
        from ..cluster.membership import validate_placement
        try:
            validate_placement(graph, args.nnodes)
        except ValueError as e:
            sys.stderr.write(f"--roles: {e}\n")
            return 2
        # one store across the launchers: node 0 hosts it (or the cluster
        # leader of --store_endpoints serves); the gang rounds ride it
        if args.store_replica:
            os.environ["TPU_DIST_STORE_REPLICATE"] = "1"
        store, _, store_addr = _setup_store(args)
        if store is None or store_addr is None:
            sys.stderr.write("--roles with --nnodes>1 needs a working "
                             "control-plane store; fix the store setup "
                             "error above\n")
            return 2
        if args.store_replica and args.node_rank == 0:
            from ..cluster import endpoints as _cep
            _cep.write_endpoints(args.store_endpoints, store_addr, 0)
            os.environ[_cep.ENDPOINTS_ENV] = args.store_endpoints
    if args.serve and args.node_rank == 0:
        # host the store here so the gateway and spawn_graph share it
        # (a multi-node launch holds the shared one already)
        if store is None:
            from ..dist.store import TCPStore
            try:
                store = TCPStore(args.master_addr, args.store_port,
                                 is_master=True)
            except Exception as e:
                sys.stderr.write(f"--roles --serve: store setup failed "
                                 f"({e})\n")
                return 2
            store_addr = f"{args.master_addr}:{store.port}"
        gateway_proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.serve", "gateway",
             "--port", str(args.serve_port)],
            env=dict(os.environ, TPU_DIST_STORE_ADDR=store_addr))
    try:
        return spawn_graph(graph, argv, role_argv or None,
                           max_restarts=args.max_restarts,
                           solo_restarts=args.solo_restarts,
                           heartbeat_timeout=args.heartbeat_timeout,
                           restart_backoff=args.restart_backoff,
                           master_addr=args.master_addr,
                           store_port=args.store_port,
                           store=store, store_addr=store_addr,
                           extra_env=_diagnostic_env(args),
                           obs_dir=args.obs_dir, node_id=args.node_rank,
                           nnodes=args.nnodes)
    finally:
        _stop_gateway(gateway_proc)
        if store is not None:
            try:
                store.close()
            except Exception:
                pass


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.standalone:
        overridden = [f for f, default in (("--nnodes", 1),
                                           ("--node_rank", 0),
                                           ("--master_port", 29500))
                      if getattr(args, f[2:]) != default]
        if overridden:
            sys.stderr.write(
                f"--standalone overrides {', '.join(overridden)} "
                f"(single-node, auto rendezvous port)\n")
        args.nnodes, args.node_rank = 1, 0
        # torchrun's --standalone needs no store: pick the port directly
        # rather than through store negotiation (which --no_store disables)
        args.master_port = _free_port() if args.no_store else 0
    if args.node_rank >= args.nnodes or args.node_rank < 0:
        sys.stderr.write(f"--node_rank {args.node_rank} out of range for "
                         f"--nnodes {args.nnodes}\n")
        return 2
    if args.max_restarts < 0:
        sys.stderr.write("--max_restarts must be >= 0\n")
        return 2
    if args.max_restarts > 0 and args.nnodes > 1 and args.no_store:
        sys.stderr.write("--max_restarts with --nnodes>1 needs the "
                         "control-plane store; drop --no_store\n")
        return 2
    if args.store_replica and not args.store_endpoints:
        sys.stderr.write("--store_replica needs --store_endpoints (the "
                         "shared file clients re-resolve the leader "
                         "from)\n")
        return 2
    if (args.store_endpoints or args.store_replica) and args.no_store:
        sys.stderr.write("--store_endpoints/--store_replica need the "
                         "control-plane store; drop --no_store\n")
        return 2
    world_size = args.nproc_per_node * args.nnodes
    elastic_range = None
    if args.elastic_world:
        try:
            lo, hi = (int(v) for v in args.elastic_world.split(":"))
        except ValueError:
            sys.stderr.write(f"--elastic_world must be MIN:MAX, got "
                             f"{args.elastic_world!r}\n")
            return 2
        if not 1 <= lo <= hi:
            sys.stderr.write(f"--elastic_world needs 1 <= MIN <= MAX, got "
                             f"{lo}:{hi}\n")
            return 2
        if args.nnodes > 1 and hi != world_size:
            # the cluster's grow restores each node to its capacity, so MAX
            # must be the full static world: anything else would cap growth
            # below what the flags promise
            sys.stderr.write(f"--elastic_world MAX must equal "
                             f"nproc_per_node*nnodes ({world_size}) with "
                             f"--nnodes>1, got {hi}\n")
            return 2
        if args.no_store:
            # generation fencing and the reshard visibility exchange ride
            # the store
            sys.stderr.write("--elastic_world needs the control-plane "
                             "store; drop --no_store\n")
            return 2
        if not lo <= world_size <= hi:
            sys.stderr.write(f"--nproc_per_node={args.nproc_per_node} is "
                             f"outside --elastic_world={lo}:{hi}\n")
            return 2
        elastic_range = (lo, hi)
    # flight-recorder wiring: --flight-recorder (or an already armed env)
    # resolves one dump directory shared by the supervisor's messages and
    # every worker.  The env test is the recorder's own parser: a bare
    # truthiness check would arm an explicit TPU_DIST_OBS=0
    from ..obs.recorder import enabled as _obs_enabled
    args.obs_dir = None
    if args.flight_recorder or _obs_enabled():
        args.obs_dir = (os.environ.get("TPU_DIST_OBS_DIR")
                        or os.path.join(os.getcwd(), "tpu_dist_obs"))
    if args.roles:
        return _run_role_graph(args)

    if args.store_replica:
        # replication is armed BEFORE the store is hosted (node 0's server
        # owns the mutation log), and takes the Python wire in every
        # process of this tree
        os.environ["TPU_DIST_STORE_REPLICATE"] = "1"
    store, master_port, store_addr = _setup_store(args)
    if master_port is None:
        return 2
    negotiated_port = args.master_port == 0
    cluster = []   # the --store_replica sidecar: agent (and follower)
    if args.store_replica and store is not None:
        try:
            cluster = _start_sidecar(args, store_addr)
        except Exception as e:
            sys.stderr.write(f"--store_replica: cluster sidecar setup "
                             f"failed ({e!r})\n")
            store.close()
            return 2
    elif (args.nnodes > 1 and store is not None
          and (elastic_range or args.max_restarts > 0)):
        # a membership record for the cluster's elastic plan (the
        # host-fingerprint order of nodes), even without the sidecar
        try:
            from ..cluster.membership import register_node
            register_node(store, args.node_rank, args.nproc_per_node)
        except Exception:
            pass
    multi_node = (args.nnodes > 1
                  and (args.max_restarts > 0 or elastic_range is not None))
    if multi_node and store is None:
        sys.stderr.write("--max_restarts/--elastic_world with --nnodes>1 "
                         "needs a working control-plane store; fix the "
                         "store setup error above or drop the flag\n")
        return 2
    # --serve: the gateway is spawned ONCE, outside the restart loop — its
    # whole point is surviving worker relaunches (it re-resolves the
    # backend registry after each restart)
    gateway_proc = None
    if args.serve:
        if store_addr is None:
            sys.stderr.write("--serve needs the control-plane store (drop "
                             "--no_store / fix the store error above)\n")
            return 2
        if args.node_rank == 0:
            gateway_proc = subprocess.Popen(
                [sys.executable, "-m", "tpu_dist_torch.serve", "gateway",
                 "--port", str(args.serve_port)],
                env=dict(os.environ, TPU_DIST_STORE_ADDR=store_addr))

    restarts = 0   # failure budget, compared against --max_restarts
    rnd = 0        # generation: EVERY relaunch (failure or elastic world
    #                change) advances it, so a re-formed gang never meets a
    #                stale rank's keyspace
    cur_world = world_size
    cur_nproc = args.nproc_per_node
    base_rank = args.node_rank * args.nproc_per_node
    try:
        while True:
            if store is not None and args.node_rank == 0:
                _publish_generation(store, rnd)
            procs = _spawn_world(args, cur_world, master_port, store_addr,
                                 rnd, nproc=cur_nproc, base_rank=base_rank)
            exit_code, interrupted, rcs = _watch_world(
                args, procs, store, cur_world, rnd=rnd, base_rank=base_rank)
            if interrupted:
                return exit_code
            if exit_code != 0 and args.node_rank == 0:
                # before any reaping: the tails live under the failed
                # generation's keyspace
                _report_obs(args, store, cur_world, rnd)
            if multi_node:
                # a group decision: a node whose workers all exited 0 (or
                # an idle node running none) waits too — a peer's failure
                # restarts everyone, a peer's preemption or grow re-forms
                # the world for everyone
                verdict, val = _cluster_agree(
                    args, store, rnd, exit_code, rcs, cur_nproc, restarts,
                    negotiated_port, master_port, elastic_range)
                if verdict == "done":
                    return 0
                if verdict == "giveup":
                    return val
                if verdict == "reform":
                    # the world size and/or the rank placement changed (the
                    # plan may drop THIS node to 0 ranks: it idles in the
                    # agreement until a grow); not a failure restart
                    master_port, new_world, base_rank, cur_nproc = val
                    rnd += 1
                    _log(f"cluster elastic re-form: world {cur_world} -> "
                         f"{new_world}, node {args.node_rank} runs "
                         f"{cur_nproc} rank(s) from base {base_rank} "
                         f"(generation {rnd}; restart budget untouched at "
                         f"{restarts}/{args.max_restarts})")
                    if args.node_rank == 0:
                        _report_reshard_plan(store, new_world)
                    cur_world = new_world
                    _restart_backoff(args, 1)
                    continue
                master_port = val
                restarts += 1
                rnd += 1
                _log(f"world failed; agreed restart {restarts}/"
                     f"{args.max_restarts} across {args.nnodes} nodes — "
                     f"relaunching")
                _restart_backoff(args, restarts)
                continue
            new_world = (_elastic_new_world(elastic_range, cur_world, rcs)
                         if exit_code != 0 else None)
            if new_world is not None:
                # elastic re-form: preempted ranks are gone for good (117)
                # or capacity returned (118).  Not a failure restart: the
                # budget stays untouched, the generation advances; other
                # non-zero exits of the round are the dying gang's fallout
                rnd += 1
                _log(f"elastic world change: {cur_world} -> {new_world} "
                     f"(generation {rnd}; restart budget untouched at "
                     f"{restarts}/{args.max_restarts}) — re-forming")
                _report_reshard_plan(store, new_world)
                cur_world = cur_nproc = new_world  # one node: all local
                if store is not None:
                    _reset_round_state(store, finished_round=rnd - 1)
                _restart_backoff(args, 1)
                if negotiated_port:
                    master_port = _free_port()
                continue
            if exit_code == 0 or restarts >= args.max_restarts:
                return exit_code
            restarts += 1
            rnd += 1
            _log(f"worker failed (rc={exit_code}); restart "
                 f"{restarts}/{args.max_restarts} — relaunching the world"
                 + (f" (obs dumps: {args.obs_dir})" if args.obs_dir else ""))
            if store is not None:
                _reset_round_state(store, finished_round=rnd - 1)
            _restart_backoff(args, restarts)
            if negotiated_port:
                # the previous round's c10d store socket may linger in
                # TIME_WAIT: a negotiated port is picked afresh
                master_port = _free_port()
    finally:
        _stop_gateway(gateway_proc)
        for part in cluster:
            try:
                part.stop()
            except Exception:
                pass
        if store is not None:
            try:
                store.close()
            except Exception:
                pass
