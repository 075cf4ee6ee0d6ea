"""Cross-rank merge: per-rank dumps → Chrome trace timeline + hang diagnosis
(counterpart of ``tpu_dist/obs/trace.py``; it reads either package's dumps).

:func:`read_dumps` loads the ``obs_g{gen}_r{rank}.json`` files a gang's
ranks flushed (keeping one generation — by default the newest present);
:func:`merge_trace` lays them out as a Chrome ``trace_event`` JSON object
(one *process* track per rank, one *thread* lane per event kind, collectives
named ``op #seq`` so the lockstep sequence numbers line up visually); and
:func:`diagnose` answers the on-call question directly: which rank is
behind, at which collective sequence number and call-site, and which ranks
were already waiting on it.

Time alignment: each dump carries a (wall, monotonic) anchor pair taken at
recorder construction; the merge maps every rank's monotonic timestamps
onto the shared wall axis through its own anchors.  That is exact on one
host (one monotonic clock) and approximate across hosts — which is why the
*diagnosis* never uses time at all: it compares the collective sequence
numbers every rank increments in lockstep.

Load the merged file in ``chrome://tracing`` or https://ui.perfetto.dev.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

__all__ = ["read_dumps", "merge_trace", "diagnose", "render_diagnosis"]

# trace lane per event kind (tid within each rank's track)
_TID = {"collective": 0, "p2p": 1, "transport": 2, "store": 3, "beat": 4,
        "channel": 5, "plan": 6, "pipeline": 7}
_TID_NAMES = {0: "collectives", 1: "p2p", 2: "transport", 3: "store",
              4: "beats", 5: "channels", 6: "plans", 7: "pipeline",
              8: "other"}
_OTHER_TID = 8
_ARG_KEYS = ("seq", "coll", "outcome", "site", "path", "bytes",
             "wire_bytes", "raw_wire_bytes", "comm", "digest", "reduce",
             "src", "dst", "peer", "key", "step", "detail",
             "channel", "slot", "plan", "plan_seq", "req", "group",
             "stage", "mb", "phase", "stash_bytes")


def read_dumps(path, generation: Optional[int] = None) -> List[dict]:
    """Load flight-recorder dumps from a directory (all ``obs_g*_r*.json``
    inside), a single file path, or an iterable of file paths; returns the
    dumps of one generation (``generation`` or the newest found), sorted by
    rank.  Unreadable or alien JSON files are skipped."""
    if isinstance(path, (str, os.PathLike)):
        path = os.fspath(path)
        files = (sorted(glob.glob(os.path.join(path, "obs_g*_r*.json")))
                 if os.path.isdir(path) else [path])
    else:
        files = [os.fspath(p) for p in path]
    dumps = []
    for fname in files:
        try:
            with open(fname) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            continue
        if not isinstance(d, dict) or d.get("version") != 1 \
                or not isinstance(d.get("events"), list):
            continue
        dumps.append(d)
    if not dumps:
        return []
    gen = (generation if generation is not None
           else max(d.get("generation", 0) for d in dumps))
    return sorted((d for d in dumps if d.get("generation", 0) == gen),
                  key=lambda d: d.get("rank", 0))


def merge_trace(dumps: List[dict]) -> dict:
    """Chrome ``trace_event`` object over the given dumps.  Complete ("X")
    events, microsecond timestamps; an event still pending at dump time
    spans up to the dump instant with ``args.outcome == "pending"``."""
    events: List[dict] = []
    if not dumps:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    wall0 = min(d.get("wall_anchor_ns", 0) for d in dumps)
    for d in dumps:
        rank = d.get("rank", 0)
        # monotonic -> shared wall axis through this rank's anchor pair
        off = (d.get("wall_anchor_ns", 0) - wall0
               - d.get("mono_anchor_ns", 0))
        dump_mono = d.get("mono_dump_ns", d.get("mono_anchor_ns", 0))
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "args": {"name": f"rank {rank}"}})
        for tid, name in sorted(_TID_NAMES.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": tid, "args": {"name": name}})
        for e in d["events"]:
            t0 = e.get("t0")
            if t0 is None:
                continue
            t1 = e.get("t1")
            if t1 is None:
                t1 = max(dump_mono, t0)
            name = str(e.get("op", "?"))
            if e.get("coll") is not None:
                name = f"{name} #{e['coll']}"
            events.append({
                "name": name,
                "cat": str(e.get("kind", "event")),
                "ph": "X",
                "pid": rank,
                "tid": _TID.get(e.get("kind"), _OTHER_TID),
                "ts": (t0 + off) / 1e3,
                "dur": max((t1 - t0) / 1e3, 0.001),
                "args": {k: e[k] for k in _ARG_KEYS if e.get(k) is not None},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"tool": "tpu_dist.obs", "version": 1}}


def _last_collective(dump: dict) -> Optional[dict]:
    for e in reversed(dump["events"]):
        if e.get("kind") == "collective" and e.get("coll") is not None:
            return e
    return None


def diagnose(dumps: List[dict]) -> dict:
    """Hang diagnosis over one generation's dumps.

    Verdicts: ``no-dumps``; ``no-collectives`` (nothing to compare —
    healthy only if every dump was a clean exit, see ``clean_exit``);
    ``healthy`` (every rank's last collective completed);
    ``missing-ranks`` (the dumped ranks look fine but some ranks left no
    dump at all — SIGKILL/OOM — see ``missing_ranks``); ``straggler``
    (some rank's collective sequence number is behind the front — THE
    silent-stall shape: the others sit ``pending`` in a collective the
    straggler never reached); ``stuck`` (all ranks at the same sequence
    number but some still pending — a dead peer or in-collective wedge
    rather than a straggler).
    """
    if not dumps:
        return {"version": 1, "verdict": "no-dumps", "ranks": {}}
    ranks: dict = {}
    for d in dumps:
        last = _last_collective(d)
        ranks[d.get("rank", 0)] = (None if last is None else {
            "coll": last["coll"], "op": last.get("op"),
            "site": last.get("site"), "outcome": last.get("outcome"),
            "reduce": last.get("reduce"), "path": last.get("path")})
    reached = {r: (info["coll"] if info else -1) for r, info in ranks.items()}
    front = max(reached.values())
    stragglers = sorted(r for r, c in reached.items() if c < front)
    waiting = sorted(r for r, info in ranks.items()
                     if info and info["outcome"] == "pending"
                     and reached[r] == front)
    world = max(dumps[0].get("world", len(dumps)), len(ranks))
    out = {"version": 1,
           "generation": dumps[0].get("generation", 0),
           "world": world,
           "ranks": ranks, "stragglers": stragglers,
           "waiting_ranks": waiting,
           # a SIGKILLed/OOMed rank leaves no dump at all — a "healthy"
           # verdict over a partial world would mislead the operator
           "missing_ranks": sorted(set(range(world)) - set(ranks)),
           # a crash/signal dump with no collectives is NOT a healthy run
           "clean_exit": all(d.get("reason") == "exit" for d in dumps)}
    # serving ranks: a request's decode is not a lockstep collective, but a
    # PENDING serve span in a dump is exactly "the request this rank was
    # working on when it died/hung" — name it (the serve engine opens one
    # span per request with its queue/prefill/decode split)
    stuck_requests = []
    for dmp in dumps:
        role = (f"{dmp['role']}[{dmp.get('role_rank')}]"
                if dmp.get("role") else None)
        for e in dmp.get("events", []):
            if e.get("kind") == "serve" and e.get("outcome") == "pending":
                stuck_requests.append({
                    "rank": dmp.get("rank", 0), "role": role,
                    "req": e.get("req"),
                    "phase": ("decode" if e.get("slot") is not None
                              else "queued"),
                    "slot": e.get("slot"),
                    "prompt_len": e.get("prompt_len"),
                    "site": e.get("site")})
    out["stuck_requests"] = stuck_requests
    # control-plane leader changes: a client that rode a store failover
    # records kind="store" op="failover" naming the promoted leader —
    # surface them so an operator reading a hang/restart diagnosis can see
    # the control plane moved under the job (and where it moved TO)
    store_failovers = []
    for dmp in dumps:
        for e in dmp.get("events", []):
            if e.get("kind") == "store" and e.get("op") == "failover":
                store_failovers.append({
                    "rank": dmp.get("rank", 0),
                    "leader": e.get("key"),
                    "old": e.get("old"),
                    "epoch": e.get("epoch")})
    out["store_failovers"] = store_failovers
    # pipeline stages: a PENDING kind="pipeline" span is a stage blocked
    # claiming a microbatch (op "claim-act"/"claim-grad") — the starved
    # stage a dead neighbor leaves behind.  A SIGKILLed stage rank leaves
    # no dump; its survivors' pending claims name it by adjacency.
    pipeline_stalls = []
    for dmp in dumps:
        role = (f"{dmp['role']}[{dmp.get('role_rank')}]"
                if dmp.get("role") else None)
        stall = None
        for e in dmp.get("events", []):
            if e.get("kind") == "pipeline" and e.get("outcome") == "pending":
                stall = e
        if stall is not None:
            pipeline_stalls.append({
                "rank": dmp.get("rank", 0), "role": role,
                "stage": stall.get("stage"), "mb": stall.get("mb"),
                "phase": stall.get("phase"), "op": stall.get("op")})
    out["pipeline_stalls"] = pipeline_stalls
    stuck_ref = ranks[waiting[0]] if waiting else None
    if front < 0:
        out.update({"verdict": "no-collectives", "straggler": None})
        return out
    if stragglers:
        s = stragglers[0]
        info = ranks[s]
        out.update({
            "verdict": "straggler",
            "straggler": s,
            "straggler_last_coll": info["coll"] if info else None,
            "straggler_last_op": info["op"] if info else None,
            "straggler_last_site": info["site"] if info else None,
            "stuck_coll": stuck_ref["coll"] if stuck_ref else front,
            "stuck_op": stuck_ref["op"] if stuck_ref else None,
            "stuck_site": stuck_ref["site"] if stuck_ref else None,
        })
    elif waiting:
        out.update({"verdict": "stuck", "straggler": None,
                    "stuck_coll": front,
                    "stuck_op": stuck_ref["op"],
                    "stuck_site": stuck_ref["site"]})
    elif out["missing_ranks"]:
        out.update({"verdict": "missing-ranks", "straggler": None})
    else:
        out.update({"verdict": "healthy", "straggler": None})
    return out


def _rank_line(r: int, info: Optional[dict]) -> str:
    if info is None:
        return f"  rank {r}: no collective recorded"
    return (f"  rank {r}: collective #{info['coll']} {info['op']} "
            f"{info['outcome']}"
            + (f" at {info['site']}" if info.get("site") else ""))


def render_diagnosis(d: dict) -> str:
    """Human rendering of a :func:`diagnose` result."""
    v = d.get("verdict")
    if v == "no-dumps":
        return "no flight-recorder dumps found"
    lines = []
    if v == "no-collectives":
        lines.append(
            "no collective events recorded"
            + (": nothing to diagnose" if d.get("clean_exit") else
               " but the dump was NOT a clean exit — if the job hung, it "
               "stalled before its first collective (check rendezvous / "
               "the launcher's liveness warning)"))
    elif v == "healthy":
        lines.append("no hang detected: every rank's last recorded "
                     "collective completed")
    elif v == "straggler":
        s = d["straggler"]
        last = ("never reached a collective"
                if d.get("straggler_last_coll") is None else
                f"last at collective #{d['straggler_last_coll']} "
                f"({d['straggler_last_op']}"
                + (f" at {d['straggler_last_site']}"
                   if d.get("straggler_last_site") else "") + ")")
        stuck = f"collective #{d['stuck_coll']}"
        if d.get("stuck_op"):
            stuck += (f" ({d['stuck_op']}"
                      + (f" at {d['stuck_site']}" if d.get("stuck_site")
                         else "") + ")")
        lines.append(f"hang diagnosis: rank {s} is behind — {last}; "
                     f"rank(s) {d['waiting_ranks']} already waiting in "
                     f"{stuck}")
    elif v == "stuck":
        lines.append(f"hang diagnosis: all ranks reached collective "
                     f"#{d['stuck_coll']} ({d.get('stuck_op')}) but rank(s) "
                     f"{d['waiting_ranks']} never completed it — dead peer "
                     f"or wedged transport rather than a straggler")
    elif v == "missing-ranks":
        lines.append("every dumped rank's collectives completed, but some "
                     "ranks left no dump at all (see below) — a "
                     "SIGKILLed/OOMed rank cannot dump; check its store "
                     "tail in the supervisor's positions table")
    if d.get("missing_ranks"):
        lines.append(f"  WARNING: no dump from rank(s) {d['missing_ranks']} "
                     f"(world {d.get('world')})")
    for sr in d.get("stuck_requests", []):
        who = (f"rank {sr['rank']} ({sr['role']})" if sr.get("role")
               else f"rank {sr['rank']}")
        lines.append(
            f"  stuck request: {who} req {sr['req']} "
            f"({sr['phase']}"
            + (f", slot {sr['slot']}" if sr.get("slot") is not None else "")
            + (f", prompt {sr['prompt_len']} tokens"
               if sr.get("prompt_len") is not None else "")
            + ") never completed"
            + (f" — submitted at {sr['site']}" if sr.get("site") else ""))
    for ps in d.get("pipeline_stalls", []):
        who = (f"rank {ps['rank']} ({ps['role']})" if ps.get("role")
               else f"rank {ps['rank']}")
        what = ("activations" if ps.get("op") == "claim-act"
                else "gradients" if ps.get("op") == "claim-grad"
                else ps.get("op"))
        neighbor = (f"stage{ps['stage'] - 1}" if ps.get("op") == "claim-act"
                    and ps.get("stage") is not None
                    else f"stage{ps['stage'] + 1}"
                    if ps.get("op") == "claim-grad"
                    and ps.get("stage") is not None else "its neighbor")
        lines.append(
            f"  stalled pipeline stage: {who} starved at stage "
            f"{ps.get('stage')} {ps.get('phase')} mb {ps.get('mb')} — "
            f"blocked claiming {what} that {neighbor} never produced")
    failovers = d.get("store_failovers") or []
    if failovers:
        latest = max(failovers, key=lambda f: f.get("epoch") or 0)
        seen = sorted({f["rank"] for f in failovers})
        lines.append(
            f"  store failover: leader {latest.get('old')} lost; clients "
            f"re-resolved to promoted leader {latest.get('leader')} "
            f"(epoch {latest.get('epoch')}) — observed by rank(s) {seen}")
    for r in sorted(d.get("ranks", {})):
        lines.append(_rank_line(r, d["ranks"][r]))
    return "\n".join(lines)
