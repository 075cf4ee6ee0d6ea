"""Two launchers, world 2n → n → 2n across the node boundary: the
``elastic_train`` twin under the cluster control plane.

Two ``python -m tpu_dist_torch.launch --nnodes=2`` launchers, ``n`` ranks
each, share one replicated store (``--store_endpoints=FILE
--store_replica``: node 0 hosts it, node 1 runs a follower and an agent)
and ``--elastic_world=n:2n``.  The twin runs with ``--zero
--exit-on-preempt``; ``TPU_DIST_CHAOS`` preempts every rank of node 1 at
step 20 (node 1 idles at zero ranks while node 0 carries world n) and asks
to grow at step 35, when the world re-forms at 2n across both nodes.  Both
world changes are cluster decisions (``cluster.membership.elastic_plan``
over both nodes' counts), outside the restart budget.

Then each destination world is held against one launcher at that world
resumed from a copy of the same checkpoint tree (the two at once): the
world-n phase's losses and the world-2n phase's losses and final
parameters must be equal bit for bit.

``cuda`` with ``2n`` cards: each launcher takes its own ``n`` cards
(``CUDA_VISIBLE_DEVICES``), the gradients ride the group's NCCL;
with fewer cards every rank shares ``cuda:0`` and the gradients ride the
host data plane (``TPU_DIST_HOST_TRANSPORT=dataplane``: the NCCL group
forms no communicator).  One JSON line::

    python -m tpu_dist_torch.benchmarks.cluster_elastic [--world 4]
    python -m tpu_dist_torch.benchmarks.cluster_elastic --device cpu
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TWIN = ["--synthetic", "--max-steps", "40", "--save-every", "10",
        "--batch-size", "100", "--zero", "--exit-on-preempt"]
SHRINK_AT, GROW_AT = 20, 35
TIMEOUT = 300


def _env(extra: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), PYTHONWARNINGS="ignore",
               OMP_NUM_THREADS="1")
    for var in ("TPU_DIST_CHAOS", "TPU_DIST_OBS", "TPU_DIST_NETCHAOS",
                "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR", "TPU_DIST_STORE_ENDPOINTS",
                "TPU_DIST_STORE_REPLICATE", "TPU_DIST_HOST_TRANSPORT",
                "CUDA_VISIBLE_DEVICES"):
        env.pop(var, None)
    env.update(extra)
    return env


def _launch(launcher: list, twin: list, out: str, env: dict, stdout):
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--master_port=0",
         "--restart_backoff=0", *launcher, "-m",
         "tpu_dist_torch.examples.elastic_train", *twin], cwd=out, env=env,
        stdout=stdout, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _finish(procs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def _records(path: str) -> list:
    try:
        with open(path) as f:
            return [json.loads(line) for line in f]
    except OSError:
        return []


def _losses(recs, gen=None) -> dict:
    return {(r["rank"], r["step"]): r["loss"] for r in recs
            if "step" in r and (gen is None or r["gen"] == gen)}


def trim_tree(root: str, max_step: int) -> None:
    """Roll a checkpoint tree's copy back to ``max_step`` (the replicated
    root and every shard root): the tree an earlier incarnation resumed
    from."""
    for r in [root] + sorted(glob.glob(os.path.join(root, "shard_r*"))):
        for d in glob.glob(os.path.join(r, "step_*")):
            if int(os.path.basename(d).split("_")[1]) > max_step:
                shutil.rmtree(d)


def plans_acted(logs) -> list:
    """The ``{node: (base, nproc)}`` plan of each re-form, as the two
    launchers logged acting on it."""
    per_node = [re.findall(r"node (\d+) runs (\d+) rank\(s\) from base (\d+)",
                           log) for log in logs]
    return [{int(n): (int(b), int(k)) for n, k, b in row}
            for row in zip(*per_node)]


def run(world: int = 2, device: str = "cuda") -> dict:
    """The two-launcher run and its two references; the checks, the plans
    the launchers acted on and the seconds from the preemption (and from
    the grow) to the re-formed world's first step."""
    n = world // 2
    cards = 0
    if device == "cuda":
        import torch
        cards = torch.cuda.device_count()
    split = device == "cuda" and cards >= world
    extra = {} if split or device == "cpu" else {
        "TPU_DIST_HOST_TRANSPORT": "dataplane"}
    twin = TWIN + (["--device", "cpu"] if device == "cpu" else [])
    chaos = ";".join([f"shrink:rank={r},step={SHRINK_AT}"
                      for r in range(n, world)]
                     + [f"grow:rank=0,step={GROW_AT},world={world}"])
    out = tempfile.mkdtemp(prefix="cluster_elastic_",
                           dir=os.environ.get("TMPDIR"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        store_port = s.getsockname()[1]
    t0 = time.time()
    procs = []
    for node in (0, 1):
        env = _env(dict(extra, TPU_DIST_CHAOS=chaos))
        if split:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(c) for c in range(node * n, node * n + n))
        with open(os.path.join(out, f"node{node}.log"), "w") as log:
            procs.append(_launch(
                ["--nnodes=2", f"--node_rank={node}",
                 f"--nproc_per_node={n}", f"--store_port={store_port}",
                 f"--store_endpoints={os.path.join(out, 'ep.json')}",
                 "--store_replica", f"--elastic_world={n}:{world}",
                 "--elastic_timeout=120"],
                twin + ["--ckpt-root", os.path.join(out, "ck"), "--record",
                        os.path.join(out, "cluster.jsonl")], out, env, log))
    _finish(procs, TIMEOUT)
    logs = []
    for node in (0, 1):
        with open(os.path.join(out, f"node{node}.log")) as f:
            logs.append(f.read())
    refs = {}
    for w, upto in ((n, SHRINK_AT), (world, GROW_AT)):
        ck = os.path.join(out, f"ck_w{w}")
        shutil.copytree(os.path.join(out, "ck"), ck)
        trim_tree(ck, upto)
        refs[w] = _launch(["--standalone", f"--nproc_per_node={w}"],
                          twin + ["--ckpt-root", ck, "--record",
                                  os.path.join(out, f"w{w}.jsonl")],
                          out, _env(extra), subprocess.PIPE)
    ref_out = {w: p.communicate(timeout=TIMEOUT)[0] for w, p in refs.items()}
    _finish(list(refs.values()), TIMEOUT)
    wall = time.time() - t0

    recs = _records(os.path.join(out, "cluster.jsonl"))
    ref_n, ref_2n = (_records(os.path.join(out, f"w{w}.jsonl"))
                     for w in (n, world))
    g1, g2 = _losses(recs, 1), _losses(recs, 2)
    worlds = {}
    for r in recs:
        if "step" in r:
            worlds.setdefault(r["gen"], set()).add(r["rank"])
    finals = ({r["final"] for r in recs if "final" in r and r["gen"] == 2}
              | {r["final"] for r in ref_2n if "final" in r})
    want_plans = [{0: (0, n), 1: (n, 0)}, {0: (0, n), 1: (n, n)}]
    checks = {
        "launchers_exit_0": [p.returncode for p in procs] == [0, 0],
        "plans_are_elastic_plan": plans_acted(logs) == want_plans,
        "node1_idled": f"node 1 runs 0 rank(s) from base {n}" in logs[1],
        "budget_untouched": "restart budget untouched" in logs[0]
        and "relaunching" not in logs[0] + logs[1],
        "worlds": worlds == {0: set(range(world)), 1: set(range(n)),
                             2: set(range(world))},
        "references_exit_0": all(p.returncode == 0 for p in refs.values()),
        "world_n_bitwise": sorted(g1) == [
            (r, s) for r in range(n) for s in range(SHRINK_AT + 1,
                                                    GROW_AT + 1)]
        and all(_losses(ref_n).get(k) == v for k, v in g1.items()),
        "world_2n_bitwise": bool(g2) and g2 == _losses(ref_2n)
        and len(finals) == 1}
    pre = [r["t"] for r in recs if r.get("gen") == 0
           and r.get("step") == SHRINK_AT and r.get("rank") == n]
    grow = [r["t"] for r in recs if r.get("gen") == 1
            and r.get("step") == GROW_AT and r.get("rank") == 0]
    first = {g: min((r["t"] for r in recs if r.get("gen") == g
                     and "step" in r), default=None) for g in (1, 2)}
    row = {"metric": "cluster_elastic", "world": world, "device": device,
           "cards": cards, "transport": ("nccl" if split else "gloo"
                                         if device == "cpu" else "dataplane"),
           "chaos": chaos, "twin": twin,
           "plans_acted": [{str(k): list(v) for k, v in p.items()}
                           for p in plans_acted(logs)],
           "preempt_to_world_n_step_s": (first[1] - pre[0])
           if pre and first[1] else None,
           "grow_to_world_2n_step_s": (first[2] - grow[0])
           if grow and first[2] else None,
           "wall_s": wall, "checks": checks,
           "ok": all(checks.values())}
    if not row["ok"]:
        row["log_tail"] = [log[-2500:] for log in logs] + [
            o[-1500:] for o in ref_out.values()]
    if device == "cuda":
        import torch
        row["device_name"] = torch.cuda.get_device_name(0)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2,
                    help="the full world, 2n: n ranks on each launcher")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.world < 2 or args.world % 2:
        ap.error("--world must be even: n ranks on each of two launchers")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("cluster_elastic: no CUDA device (use --device cpu)",
                  file=sys.stderr)
            return 2
    row = run(args.world, args.device)
    print(json.dumps(row), flush=True)
    return 0 if row["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
