"""Runtime cross-rank collective sanitizer (``TPU_DIST_SANITIZE=1``,
launcher ``--sanitize``); counterpart of ``tpu_dist/analysis/sanitizer.py``
with the same keys, signatures and majority rule, so JAX ranks and port
ranks check each other in one gang.

It catches rank-divergent collectives at run time (divergence through
data, config skew, library code).  When enabled, every eager host
collective first publishes a per-call **signature** to the
generation-scoped control-plane store and cross-checks agreement across
ranks before any payload moves:

    {ns}/san[/grp{set}]/{seq}/{rank}  ->  {"op": "all_reduce",
                               "reduce": "sum",
                               "tree": "<structure hash>",
                               "leaves": [["float32", [1024]], ...],
                               "src"/"dst": ...,
                               "group": "world[4]" | "grp<id>[0, 1]",
                               "site": "train.py:123", "rank": 2}

Sub-group collectives (:mod:`..collectives.topology`) post under a
scope derived from the member *set* and sign the group id + the exact
ordered membership, so mismatched group objects raise naming BOTH
memberships (see ``_group_sig``); each scope counts its own ``seq``.

``seq`` is a process-local counter: in an SPMD program every rank arrives
at sanitized collective #seq together, so the keys line up.  Each rank
waits (bounded by ``TPU_DIST_SANITIZE_TIMEOUT``, default 30 s) for every
peer's signature, then compares the *semantic* fields (op, reduce op,
tree structure, leaf dtypes/shapes, root rank — everything that must be
uniform for the collective to be well-formed).  Divergence raises
:class:`CollectiveMismatchError` on **every** rank, naming the divergent
rank(s), their call-sites, and the first differing field — a named error
at first occurrence instead of a silent hang.  A rank that never announces
(the ``if rank == 0: all_reduce(...)`` bug: the other ranks never reach a
collective at all) surfaces as the same error via the deadline.

Cost model: one store SET + one bounded poll per peer per collective —
strictly control-plane traffic, so it rides the same server the small-leaf
path already uses.  Off (the default), the only cost is one environment
lookup per collective call.

Signatures are built from each leaf's shape and dtype only (numpy's dtype
names: ``bfloat16`` for ``torch.bfloat16``), so a CUDA tensor is never
copied to the host for them; the ``tree`` field hashes the JAX rendering
of the tree's structure (:func:`..collectives._tree.treedef_str`).  The
counters are per process: ranks run as threads of one process share them.

Call-site attribution walks the stack to the first frame outside
``tpu_dist_torch/collectives`` and ``tpu_dist_torch/analysis``, so the
error names the user's line, not the framework's.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = ["CollectiveMismatchError", "enabled", "check_collective",
           "reset", "SEMANTIC_FIELDS"]

# fields that must agree across ranks (compared); "site"/"rank" are
# diagnostic only — the same collective may legitimately be reached from
# different lines (e.g. matching calls in both branches of a conditional).
# "comm" is the wire-compression scheme (TPU_DIST_COMM_DTYPE — a dtype
# cast or an int8 block-quant spec): ranks running different schemes would
# exchange frames in different wire formats and corrupt the ring, so a
# skewed compression config fails here naming both schemes instead.
# "group" is the SubGroup identity (group_id + the ordered membership):
# ranks whose group objects diverge — different ring order, different
# members, or a sub-group vs the flat world — would run incompatible rings
# over colliding tags; the signature names BOTH memberships before any
# payload moves.
# "role" is the process's role-graph role (.roles), signed for
# collectives on the FLAT world only: a collective that accidentally spans
# two roles (a learner-side all_reduce reaching actor ranks through the
# default group) then fails naming BOTH role names instead of a bare
# membership deadline.  Deliberately-scoped cross-role SubGroups are
# exempt — their identity is already signed via "group" — and role_rank
# rides along as a diagnostic field (it legitimately differs per rank).
SEMANTIC_FIELDS = ("op", "reduce", "tree", "leaves", "src", "dst", "comm",
                   "group", "role")

# process-local sanitized-collective counters, one per signature scope:
# every group (and the flat world) counts its own collectives, because a
# rank participates in different subsets of each group's traffic
_seqs: Dict[str, int] = {}


class CollectiveMismatchError(RuntimeError):
    """Ranks disagreed on (or never announced) a host collective.

    Attributes: ``rank`` (this process), ``seq`` (sanitized-call index),
    ``op``, ``site`` (this rank's call-site), ``divergent`` (rank ->
    signature dict for the disagreeing ranks, empty on a timeout),
    ``missing`` (ranks that never announced, empty on a mismatch)."""

    def __init__(self, rank: int, seq: int, op: str, site: str,
                 message: str, divergent: Optional[Dict[int, Dict]] = None,
                 missing: Optional[List[int]] = None):
        self.rank, self.seq, self.op, self.site = rank, seq, op, site
        self.divergent = divergent or {}
        self.missing = missing or []
        super().__init__(message)


def enabled() -> bool:
    return os.environ.get("TPU_DIST_SANITIZE", "").strip().lower() in (
        "1", "true", "yes", "on")


def _timeout() -> float:
    try:
        return float(os.environ.get("TPU_DIST_SANITIZE_TIMEOUT", "30"))
    except ValueError:
        return 30.0


def reset() -> None:
    """Restart the sanitized-call counters (tests / re-init)."""
    _seqs.clear()


def _group_sig(group):
    """``(scope_segment, group_field)`` for a collective's group.

    ``scope_segment`` namespaces the signature keys.  It hashes the
    *sorted member set*, NOT the ordered list: two ranks holding groups
    that diverge only in ring order / id still post into the SAME
    keyspace, so the divergence is diagnosed as a named mismatch (the
    ``group`` field below differs) rather than a mute deadline.  Groups
    over different member sets can never rendezvous at all — those fail
    via the deadline, naming the ranks that never announced.

    ``group_field`` is the compared signature value: the group id plus
    the exact ordered membership — the error therefore NAMES both
    memberships."""
    gid = getattr(group, "group_id", None)
    if gid is None:
        return "", f"world[{group.num_processes}]"
    set_scope = getattr(group, "set_scope", gid)
    return f"/grp{set_scope}", f"grp{gid}{list(group.members)}"


def _call_site() -> str:
    """First stack frame outside the collectives/analysis machinery
    (the flight recorder's attribution helper)."""
    from ..obs.recorder import call_site
    return call_site(skip_parts=("collectives", "analysis"))


def _current_role():
    """This process's ``(role, role_rank)`` under a role graph, or None —
    consulted only on the armed path."""
    try:
        from ..roles.graph import current_role
        return current_role()
    except Exception:
        return None


def _role_notes(ranks) -> str:
    """``" (roles: 2=actor[1], 3=actor[2])"`` for a rank list when a role
    graph is installed, so a membership deadline names roles, not just
    bare ranks.  Empty outside any graph."""
    try:
        from ..roles.graph import role_label
        labels = [(r, role_label(r)) for r in ranks]
        if any(lbl for _, lbl in labels):
            return (" (roles: "
                    + ", ".join(f"{r}={lbl or '?'}" for r, lbl in labels)
                    + ")")
    except Exception:
        pass
    return ""


def _signature(op: str, rank: int, value: Any = None,
               reduce_op: Optional[str] = None, src: Optional[int] = None,
               dst: Optional[int] = None, comm: Optional[str] = None,
               with_leaves: bool = True) -> Dict:
    sig: Dict[str, Any] = {"op": op, "rank": rank, "site": _call_site()}
    if reduce_op is not None:
        sig["reduce"] = str(reduce_op).lower()
    if src is not None:
        sig["src"] = int(src)
    if dst is not None:
        sig["dst"] = int(dst)
    if comm is not None:
        sig["comm"] = str(comm)
    if value is not None and with_leaves:
        from ..collectives import _tree
        from ..obs.recorder import _dtype_name
        leaves, treedef = _tree.flatten(value)
        sig["tree"] = hashlib.sha256(
            _tree.treedef_str(treedef).encode()).hexdigest()[:12]
        sig["leaves"] = [_leaf_sig(leaf, _dtype_name) for leaf in leaves]
    return sig


def _leaf_sig(leaf, dtype_name) -> list:
    """``[dtype name, shape]`` from the leaf's own shape and dtype (a
    Python scalar as numpy would see it), never its values."""
    if getattr(leaf, "dtype", None) is None or getattr(
            leaf, "shape", None) is None:
        import numpy as np
        leaf = np.asarray(leaf)
    return [dtype_name(leaf.dtype)[0], [int(d) for d in leaf.shape]]


def _first_divergence(ref: Dict, other: Dict) -> str:
    for field in SEMANTIC_FIELDS:
        if ref.get(field) != other.get(field):
            return (f"{field}: {json.dumps(ref.get(field))} vs "
                    f"{json.dumps(other.get(field))}")
    return "<consistent>"


def _ns() -> str:
    import importlib
    rdzv = importlib.import_module("tpu_dist_torch.dist.rendezvous")
    return f"tpu_dist/g{rdzv.generation()}/san"


def check_collective(group, store, op: str, value: Any = None,
                     reduce_op: Optional[str] = None,
                     src: Optional[int] = None, dst: Optional[int] = None,
                     comm: Optional[str] = None,
                     with_leaves: bool = True) -> None:
    """Publish this rank's signature for the next sanitized collective and
    verify every peer announced an identical one; raises
    :class:`CollectiveMismatchError` (never hangs: bounded by
    ``TPU_DIST_SANITIZE_TIMEOUT``).

    Called by the eager collectives and the Bucketer before any payload
    moves; safe to call directly around custom store-based synchronization
    as well."""
    n = group.num_processes
    if store is None or n <= 1:
        return
    scope, group_field = _group_sig(group)
    # signature keys carry GLOBAL rank identity: two ranks holding groups
    # that diverge in ring order would collide on group-local ranks (both
    # think they are local rank 0) and mis-wait — global ids keep the
    # rendezvous honest, so order divergence is compared and NAMED
    members = getattr(group, "members", None)
    me = group.parent_rank if members is not None else group.rank
    peers = ([r for r in members if r != me] if members is not None
             else [r for r in range(n) if r != me])
    seq = _seqs.get(scope, 0)
    _seqs[scope] = seq + 1
    mine = _signature(op, me, value=value, reduce_op=reduce_op, src=src,
                      dst=dst, comm=comm, with_leaves=with_leaves)
    mine["group"] = group_field
    if getattr(group, "group_id", None) is None:
        # flat-world collectives sign the caller's role (see the
        # SEMANTIC_FIELDS note): inside a role graph, the default group
        # spanning two roles is almost always the accident this catches
        role = _current_role()
        if role is not None:
            mine["role"], mine["role_rank"] = role
    base = f"{_ns()}{scope}/{seq}"
    store.set(f"{base}/{me}", json.dumps(mine, sort_keys=True).encode())

    timeout = _timeout()
    deadline = time.monotonic() + timeout
    waiting = set(peers)
    delay = 0.0005
    while waiting:
        waiting = {r for r in waiting if not store.check(f"{base}/{r}")}
        if not waiting:
            break
        if time.monotonic() > deadline:
            missing = sorted(waiting)
            raise CollectiveMismatchError(
                me, seq, op, mine["site"],
                f"collective sanitizer: rank {me} announced collective "
                f"#{seq} ({op} at {mine['site']}) but rank(s) "
                f"{missing}{_role_notes(missing)} "
                f"never announced theirs within {timeout:.0f}s "
                f"(TPU_DIST_SANITIZE_TIMEOUT) — a rank-divergent "
                f"collective: those ranks skipped this call or are blocked "
                f"elsewhere", missing=missing)
        time.sleep(delay)
        delay = min(delay * 2, 0.02)

    sigs = {me: mine}
    for r in peers:
        sigs[r] = json.loads(store.get(f"{base}/{r}"))
        # ack-counter clean-up (the store all-gather's discipline): the
        # last reader of a peer's signature deletes it
        if store.add(f"{base}/{r}/ack", 1) >= n - 1:
            store.delete_key(f"{base}/{r}")
            store.delete_key(f"{base}/{r}/ack")

    # reference = the majority signature (ties -> lowest rank holding one)
    by_sem: Dict[str, List[int]] = {}
    for r, sig in sigs.items():
        key = json.dumps([sig.get(f) for f in SEMANTIC_FIELDS],
                         sort_keys=True)
        by_sem.setdefault(key, []).append(r)
    if len(by_sem) == 1:
        return
    ref_ranks = max(by_sem.values(), key=lambda rs: (len(rs), -min(rs)))
    ref = sigs[min(ref_ranks)]
    divergent = {r: sigs[r] for rs in by_sem.values() if rs is not ref_ranks
                 for r in rs}
    detail = "; ".join(
        f"rank {r} called {sigs[r].get('op')} at {sigs[r].get('site')} "
        f"({_first_divergence(ref, sigs[r])})"
        for r in sorted(divergent))
    raise CollectiveMismatchError(
        me, seq, op, mine["site"],
        f"collective sanitizer: ranks diverged on collective #{seq}: "
        f"majority ranks {sorted(ref_ranks)} called {ref.get('op')} at "
        f"{ref.get('site')}, but {detail}", divergent=divergent)
