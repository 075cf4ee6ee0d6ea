"""Offline trace-replay sanitizer — the TD110 rule family; counterpart of
``tpu_dist/analysis/replay.py`` (the dump schema is the JAX package's, so
either package's replay reads either package's dumps).

Consumes obs flight-recorder dumps (the ``obs_g{gen}_r{rank}.json``
merge format from obs/trace.py) and re-verifies the run's *protocol*
post-hoc, so any chaos e2e or production incident dump replays into a
named verdict instead of a folder of JSON.  Surfaced as
``python -m tpu_dist_torch.analysis replay <dump-dir>``.

What it checks (each emitted through the tpudlint findings machinery):

- **TD110** — lockstep ``coll`` linearization: every rank of an SPMD
  program increments the collective sequence number in lockstep, so at
  each seq the ranks must agree on the op (and reduce/digest for
  symmetric ops).  Divergence is named like the live sanitizer's
  ``CollectiveMismatchError`` — but from a crash dump.
- **TD111** — store-key lifecycle: access to another generation's
  ``tpu_dist/g{N}/…`` namespace, a write under a prefix this rank
  already reaped with ``delete_prefix``, and sub-group
  (``…/grp{id}/…``) keys touched by a rank that the recorded
  group-collective membership says is not a member.
- **TD112** — channel cursor invariants over the ``channel`` event kind
  (roles/channel.py emits one event per cursor transition): a claim that
  is never resolved by an ack/consume/hole-skip and never returned is an
  **orphaned claim** (the PR 12 documented limit — a rank killed holding
  multi-consumer claims), and a slot resolved more than once is a
  double-ack accounting error.
- **TD113** — hole-skip vs late-write conflict: a slot that was
  settle-acked as a hole *and* has a recorded write — the message was
  lost and its ``m/{idx}`` key leaks until the generation reap.
- **TD114** — serve plan/ack pairing (``plan`` event kind): a sharded
  follower with a gap in its applied plan-seq stream, and a disagg
  descriptor dispatched to prefill whose KV arrival was never recorded.
- **TD115** — the post-hoc hang verdict: obs/trace.py's
  :func:`~tpu_dist_torch.obs.trace.diagnose` runs over the same dumps and its
  straggler/stuck verdict becomes an error finding naming the rank,
  collective seq and call-site; the full diagnosis dict is embedded in
  the JSON report (one schema with ``obs diagnose --json``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from .findings import Finding, counts as _counts

__all__ = ["REPLAY_RULE_DOCS", "ReplayReport", "replay_dumps",
           "replay_dir"]

REPLAY_RULE_DOCS = {
    "TD110": "lockstep collective divergence: ranks disagree on "
             "op/reduce/digest at one collective seq",
    "TD111": "store-key lifecycle violation: cross-generation access, "
             "write after a prefix reap, or sub-group namespace touched "
             "by a non-member rank",
    "TD112": "channel cursor invariant: orphaned claim (claimed, never "
             "resolved or returned) or double-acked slot",
    "TD113": "hole-skip vs late-write conflict: a settle-acked hole was "
             "actually written — message lost, slot key leaked",
    "TD114": "serve plan/ack pairing: follower plan-seq gap, or a "
             "dispatched disagg descriptor with no recorded KV arrival",
    "TD115": "post-hoc hang verdict: straggler/stuck rank named with its "
             "collective seq and site (same schema as obs diagnose)",
}

# key-namespace shapes (built from a root constant so these regex
# sources are not themselves raw store-key literals)
_ROOT = "tpu_dist"
_GEN_RE = re.compile(rf"^{_ROOT}/g(\d+)/")
_GRP_RE = re.compile(r"/grp(\d+)/")
_GROUP_LABEL_RE = re.compile(r"grp(\d+)\[([0-9,\s]*)\]")

# channel cursor transitions (roles/channel.py): ops that resolve a
# slot's accounting vs ops that open a claim on it
_RESOLVE_OPS = frozenset({"ack", "consume", "hole-skip"})
_CLAIM_OPS = frozenset({"claim", "inherit"})


@dataclasses.dataclass
class ReplayReport:
    """One replay verdict: findings + the embedded live-diagnosis dict."""
    path: str
    generation: int
    ranks: List[int]
    findings: List[Finding]
    diagnosis: dict

    def to_json(self) -> dict:
        return {"version": 1, "tool": "replay", "path": self.path,
                "generation": self.generation, "ranks": self.ranks,
                "diagnosis": self.diagnosis,
                "findings": [f.to_dict() for f in self.findings],
                "counts": _counts(self.findings)}


def _check_diagnosis(diag: dict, path: str) -> List[Finding]:
    out: List[Finding] = []
    v = diag.get("verdict")
    if v == "straggler":
        s = diag.get("straggler")
        last = diag.get("straggler_last_coll")
        out.append(Finding(
            "TD115", "error", path, 0, 0,
            f"straggler: rank {s} is behind — "
            + ("never reached a collective"
               if last is None else
               f"last at collective #{last} "
               f"({diag.get('straggler_last_op')})")
            + f"; rank(s) {diag.get('waiting_ranks')} waiting in "
              f"collective #{diag.get('stuck_coll')} "
              f"({diag.get('stuck_op')}"
            + (f" at {diag.get('stuck_site')}"
               if diag.get("stuck_site") else "") + ")"))
    elif v == "stuck":
        out.append(Finding(
            "TD115", "error", path, 0, 0,
            f"stuck: all ranks reached collective "
            f"#{diag.get('stuck_coll')} ({diag.get('stuck_op')}) but "
            f"rank(s) {diag.get('waiting_ranks')} never completed it — "
            f"dead peer or wedged transport"))
    elif v == "missing-ranks":
        out.append(Finding(
            "TD115", "warning", path, 0, 0,
            f"missing ranks: no dump from rank(s) "
            f"{diag.get('missing_ranks')} (world {diag.get('world')}) — "
            f"SIGKILL/OOM leaves no dump"))
    return out


def _check_collectives(dumps: List[dict], path: str) -> List[Finding]:
    out: List[Finding] = []
    by_coll: Dict[int, Dict[int, dict]] = {}
    for d in dumps:
        rank = d.get("rank", 0)
        for e in d.get("events", []):
            if e.get("kind") != "collective" or e.get("coll") is None:
                continue
            by_coll.setdefault(e["coll"], {}).setdefault(rank, e)
    for coll in sorted(by_coll):
        ranks = by_coll[coll]
        if len(ranks) < 2:
            continue  # ring eviction / stragglers: nothing to compare
        ops = {r: e.get("op") for r, e in ranks.items()}
        if len(set(ops.values())) > 1:
            pairing = ", ".join(f"rank {r}: {op}"
                                for r, op in sorted(ops.items()))
            out.append(Finding(
                "TD110", "error", path, 0, 0,
                f"collective #{coll}: ranks paired different ops "
                f"({pairing}) — the lockstep sequence diverged"))
            continue
        reduces = {r: e.get("reduce") for r, e in ranks.items()
                   if e.get("reduce") is not None}
        if len(set(reduces.values())) > 1:
            pairing = ", ".join(f"rank {r}: {red}"
                                for r, red in sorted(reduces.items()))
            out.append(Finding(
                "TD110", "error", path, 0, 0,
                f"collective #{coll} ({next(iter(ops.values()))}): ranks "
                f"disagree on the reduce op ({pairing})"))
        if set(ops.values()) == {"all_reduce"}:
            digests = {r: e.get("digest") for r, e in ranks.items()
                       if e.get("digest") is not None}
            if len(set(digests.values())) > 1:
                pairing = ", ".join(f"rank {r}: {dg}"
                                    for r, dg in sorted(digests.items()))
                out.append(Finding(
                    "TD110", "error", path, 0, 0,
                    f"collective #{coll} (all_reduce): payload digests "
                    f"diverge across ranks ({pairing}) — shape/dtype "
                    f"mismatch the live sanitizer would name"))
    return out


def _group_membership(dumps: List[dict]) -> Dict[int, set]:
    """``grp id -> member ranks`` recovered from group-collective events'
    ``group`` labels (``grp{id}[r0, r1, ...]``)."""
    members: Dict[int, set] = {}
    for d in dumps:
        for e in d.get("events", []):
            label = e.get("group")
            if not label:
                continue
            m = _GROUP_LABEL_RE.search(str(label))
            if not m:
                continue
            gid = int(m.group(1))
            ranks = {int(tok) for tok in m.group(2).split(",")
                     if tok.strip()}
            members.setdefault(gid, set()).update(ranks)
    return members


def _check_store(dumps: List[dict], path: str) -> List[Finding]:
    out: List[Finding] = []
    membership = _group_membership(dumps)
    for d in dumps:
        rank = d.get("rank", 0)
        gen = d.get("generation", 0)
        reaped: List[str] = []
        for e in d.get("events", []):
            if e.get("kind") != "store":
                continue
            op = e.get("op")
            key = e.get("key")
            if op == "failover" or not isinstance(key, str):
                continue  # failover's "key" is the promoted leader addr
            m = _GEN_RE.match(key)
            if m and int(m.group(1)) != gen:
                out.append(Finding(
                    "TD111", "error", path, 0, 0,
                    f"rank {rank} (generation {gen}) {op} on another "
                    f"generation's key {key!r} — stale-incarnation "
                    f"cross-talk the generation fence exists to prevent"))
            if op == "delete_prefix":
                reaped.append(key)
                continue
            if op in ("set", "add"):
                hit = next((p for p in reaped
                            if key == p or key.startswith(p)), None)
                if hit is not None:
                    out.append(Finding(
                        "TD111", "warning", path, 0, 0,
                        f"rank {rank} wrote {key!r} after reaping prefix "
                        f"{hit!r} — the write outlives the reap and "
                        f"leaks until the next generation sweep"))
            g = _GRP_RE.search(key)
            if g:
                gid = int(g.group(1))
                known = membership.get(gid)
                if known and rank not in known:
                    out.append(Finding(
                        "TD111", "warning", path, 0, 0,
                        f"rank {rank} touched sub-group namespace key "
                        f"{key!r} but recorded grp{gid} membership is "
                        f"{sorted(known)} — non-member access breaks "
                        f"the group's scoped counters"))
    return out


def _check_channels(dumps: List[dict], path: str) -> List[Finding]:
    out: List[Finding] = []
    # (channel, slot) -> op -> [ranks]
    slots: Dict[Tuple[str, int], Dict[str, List[int]]] = {}
    for d in dumps:
        rank = d.get("rank", 0)
        for e in d.get("events", []):
            if e.get("kind") != "channel":
                continue
            ch = e.get("channel")
            slot = e.get("slot")
            if ch is None or slot is None:
                continue
            ops = slots.setdefault((str(ch), int(slot)), {})
            ops.setdefault(str(e.get("op")), []).append(rank)
    for (ch, slot) in sorted(slots):
        ops = slots[(ch, slot)]
        resolutions = [(op, r) for op in _RESOLVE_OPS
                       for r in ops.get(op, [])]
        if len(resolutions) > 1:
            pairing = ", ".join(f"{op} by rank {r}"
                                for op, r in sorted(resolutions))
            out.append(Finding(
                "TD112", "error", path, 0, 0,
                f"channel {ch!r} slot {slot}: resolved "
                f"{len(resolutions)} times ({pairing}) — a double-ack "
                f"inflates the backpressure window"))
        claimants = [r for op in _CLAIM_OPS for r in ops.get(op, [])]
        returned = bool(ops.get("claim-return"))
        abandoned = bool(ops.get("abandon"))
        if ((claimants or abandoned) and not resolutions
                and not returned):
            who = sorted(set(claimants)) or sorted(
                set(ops.get("abandon", [])))
            out.append(Finding(
                "TD112", "warning", path, 0, 0,
                f"channel {ch!r} slot {slot}: orphaned claim — rank(s) "
                f"{who} claimed the slot but no ack/consume/hole-skip "
                f"or claim-return followed (a rank killed holding a "
                f"multi-consumer claim strands the slot until its "
                f"respawn inherits it)"))
        if ops.get("hole-skip") and ops.get("put"):
            out.append(Finding(
                "TD113", "warning", path, 0, 0,
                f"channel {ch!r} slot {slot}: settle-acked as a hole by "
                f"rank(s) {sorted(set(ops['hole-skip']))} but rank(s) "
                f"{sorted(set(ops['put']))} recorded a write — the "
                f"message was lost and its slot key leaks until the "
                f"generation reap"))
    return out


def _check_plans(dumps: List[dict], path: str) -> List[Finding]:
    out: List[Finding] = []
    applied: Dict[int, List[int]] = {}
    dispatched: Dict[str, int] = {}
    arrived: set = set()
    for d in dumps:
        rank = d.get("rank", 0)
        for e in d.get("events", []):
            if e.get("kind") != "plan":
                continue
            op = e.get("op")
            if op == "apply" and e.get("plan_seq") is not None:
                applied.setdefault(rank, []).append(int(e["plan_seq"]))
            elif op == "dispatch" and e.get("req") is not None:
                dispatched[str(e["req"])] = rank
            elif op == "arrive" and e.get("req") is not None:
                arrived.add(str(e["req"]))
    for rank in sorted(applied):
        seqs = sorted(set(applied[rank]))
        missing = sorted(set(range(seqs[0], seqs[-1] + 1)) - set(seqs))
        if missing:
            out.append(Finding(
                "TD114", "warning", path, 0, 0,
                f"sharded follower rank {rank} applied plan seqs "
                f"{seqs[0]}..{seqs[-1]} but skipped {missing} — a "
                f"missed plan frame desyncs the follower's slot state"))
    for rid, rank in sorted(dispatched.items()):
        if rid not in arrived:
            out.append(Finding(
                "TD114", "warning", path, 0, 0,
                f"disagg descriptor req={rid!r} was dispatched to "
                f"prefill (rank {rank}) but no KV arrival was recorded "
                f"— the request was in flight when the run ended "
                f"(re-dispatch territory)"))
    return out


def replay_dumps(dumps: List[dict], path: str = "<dumps>") -> ReplayReport:
    """Re-verify one generation's dumps; returns the full report (the
    findings list is empty for a protocol-clean run)."""
    from ..obs.trace import diagnose

    diag = diagnose(dumps)
    findings: List[Finding] = []
    findings += _check_diagnosis(diag, path)
    findings += _check_collectives(dumps, path)
    findings += _check_store(dumps, path)
    findings += _check_channels(dumps, path)
    findings += _check_plans(dumps, path)
    findings.sort(key=lambda f: (f.rule, f.message))
    return ReplayReport(
        path=path,
        generation=dumps[0].get("generation", 0) if dumps else 0,
        ranks=sorted(d.get("rank", 0) for d in dumps),
        findings=findings, diagnosis=diag)


def replay_dir(path: str,
               generation: Optional[int] = None) -> ReplayReport:
    """Load ``obs_g*_r*.json`` dumps from ``path`` (newest generation
    unless pinned) and replay them."""
    from ..obs.trace import read_dumps

    return replay_dumps(read_dumps(path, generation=generation),
                        path=str(path))
