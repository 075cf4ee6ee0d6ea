"""Static whole-graph protocol verifier — the TD100 rule family;
counterpart of ``tpu_dist/analysis/protocol.py`` (the same rules, messages
and witness schedules over the port's role graphs).

tpudlint (rules.py) checks single call sites; this module model-checks the
*graph*: a :class:`~tpu_dist_torch.roles.graph.RoleGraph` plus its
:class:`~tpu_dist_torch.roles.graph.ChannelSpec` topology, before a single
process is spawned.  Surfaced as ``python -m tpu_dist_torch.analysis
graph`` and as the launcher's ``--verify-graph`` pre-flight, which refuses
to spawn a provably-deadlocking graph.

The model: roles are processes, ``queue`` channels are bounded FIFO
buffers whose ``put`` blocks once ``depth`` messages are unacknowledged,
``latest`` channels are registers whose writes never block.  That is
exactly the Kahn-network boundedness setting, so:

- **TD101** (error) — a directed cycle of ``queue`` edges is a
  may-deadlock: there exists a schedule in which every role on the cycle
  fills its outgoing queue and then blocks in ``put`` waiting for the next
  role — which is itself blocked.  The finding carries the witness
  schedule, step by step.  ``latest`` edges never block a writer and
  therefore break cycles.  A cycle whose every edge carries a
  ``ChannelSpec.credits`` annotation (the producer's claim discipline
  bounds its unacknowledged in-flight messages) is admitted when every
  edge has ``depth >= credits`` — in-flight never reaches the
  backpressure wall, so no put on the cycle can block (the 1F1B
  pipeline's fwd/grad loop); an annotated edge with ``depth < credits``
  keeps the error, with a credit-overflow witness naming the edge.
- **TD102** (warning) — claim-safety under restarts: a solo-restarting
  producer can die inside the head-claim/write kill window (holes the
  consumers must settle-ack, losing the message), and a solo-restarting
  rank of a *multi*-consumer role dies holding claims that no sibling can
  return (the orphaned-claim ledger reconciles them only at respawn).
- **TD103** — restart-policy soundness: an ``@node`` pin beyond the
  cluster (error: ``validate_placement`` would refuse at spawn), an
  all-solo graph (warning: no gang anchor means the generation fence
  never advances), and a solo producer pool wider than the channel depth
  (warning: simultaneous kill windows can wedge every slot until the
  hole-settle deadline).
- **TD104** (warning) — dp-path feasibility: a channel whose consumer
  role spans multiple ranks keeps array payloads on the store funnel
  (~96x slower than the p2p lane at 8 MiB); a ``payload_bytes`` hint at
  or above ``TPU_DIST_DP_THRESHOLD`` makes that a named warning instead
  of a production surprise.
- **TD105** (error) — graph/spec mismatch: a channel endpoint naming a
  role absent from the ``--roles`` spec (``RoleGraphError`` at spawn).

Graph sources (``build_graph`` orchestrates; the CLI and the
``--verify-graph`` pre-flight both go through it):

- ``--graph file.py:builder`` / ``--graph pkg.mod:builder`` — import and
  call the graph builder (``load_graph_builder``), the precise path.
- ``--roles`` spec (roles/graph.py grammar) + ``ChannelSpec`` literals
  AST-extracted from the target script (``extract_channel_specs``) and/or
  a ``--channels`` spec (``parse_channels_spec``).
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import os
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = ["GRAPH_RULE_DOCS", "verify_graph", "extract_channel_specs",
           "parse_channels_spec", "load_graph_builder", "build_graph",
           "render_witness", "render_credit_witness"]

GRAPH_RULE_DOCS = {
    "TD101": "bounded-channel wait-for cycle: every role on the cycle can "
             "fill its outgoing queue and block in put() waiting for the "
             "next blocked role — deadlock, witness schedule printed; a "
             "cycle fully annotated with credits <= depth on every edge "
             "is admitted (credit-disciplined, puts never block)",
    "TD102": "claim-safety under solo restarts: producer kill-window holes "
             "are settle-acked (message loss), and a killed rank of a "
             "multi-consumer role strands claims until respawn "
             "reconciliation",
    "TD103": "restart-policy soundness: @node pin beyond the cluster, "
             "all-solo graph without a gang anchor, or a solo producer "
             "pool wider than the channel depth",
    "TD104": "dp-path feasibility: multi-rank consumer role with a payload "
             "hint at/above TPU_DIST_DP_THRESHOLD rides the store funnel "
             "instead of the p2p lane",
    "TD105": "graph/spec mismatch: channel endpoint names a role absent "
             "from the role spec (RoleGraphError at spawn)",
}


def _default_dp_threshold() -> int:
    try:
        return int(os.environ.get("TPU_DIST_DP_THRESHOLD",
                                  str(64 * 1024)))
    except ValueError:
        return 64 * 1024


# -- witness rendering --------------------------------------------------------


def render_witness(cycle: Sequence[Tuple[str, "object"]]) -> str:
    """The step-by-step schedule that realizes a TD101 cycle.

    ``cycle`` is ``[(role, outgoing ChannelSpec), ...]`` with each
    channel's ``dst`` equal to the next entry's role (wrapping)."""
    lines = ["witness schedule (from the initial empty-channel state):"]
    step = 1
    for role, ch in cycle:
        lines.append(
            f"  {step}. {role} puts {ch.depth} message(s) on "
            f"{ch.name!r} (depth {ch.depth}) before {ch.dst} drains any "
            f"-> {ch.name!r} is full")
        step += 1
    for role, ch in cycle:
        lines.append(
            f"  {step}. {role} blocks in put #{ch.depth + 1} on "
            f"{ch.name!r}: needs {ch.dst} to ack a slot")
        step += 1
    ring = " -> ".join([role for role, _ in cycle] + [cycle[0][0]])
    lines.append(
        f"  wait-for cycle: {ring}; no role can ack while blocked in "
        f"put, so every put times out and no schedule drains the graph")
    return "\n".join(lines)


def render_credit_witness(cycle: Sequence[Tuple[str, "object"]],
                          over: Sequence[Tuple[str, "object"]]) -> str:
    """The witness schedule for a credit-annotated cycle with an
    under-depth edge: the producer's declared in-flight window
    (``credits``) overflows the channel's ``depth``, so the claim
    discipline that was supposed to keep the cycle live blocks instead."""
    lines = ["witness schedule (from the initial empty-channel state):"]
    step = 1
    for role, ch in over:
        lines.append(
            f"  {step}. {role} opens its declared window: puts "
            f"{ch.depth} message(s) on {ch.name!r} (depth {ch.depth}) "
            f"before claiming any inbound ack")
        step += 1
        lines.append(
            f"  {step}. {role} blocks in put #{ch.depth + 1} of its "
            f"{ch.credits}-credit window on {ch.name!r}: the window "
            f"does not fit the depth, and its claim discipline only "
            f"acks inbound edges *between* window puts")
        step += 1
    ring = " -> ".join([role for role, _ in cycle] + [cycle[0][0]])
    lines.append(
        f"  wait-for cycle: {ring}; the blocked producer never reaches "
        f"the claim that would ack its inbound edge, so the cycle "
        f"wedges — raise depth to at least credits on the edge(s) above")
    return "\n".join(lines)


# -- the verifier -------------------------------------------------------------


def _queue_edges(graph) -> List[Tuple[str, str, "object"]]:
    # latest registers never block a writer; a dedicated-drain consumer
    # (ChannelSpec.drain) acks from its own thread even while the role's
    # main loop is blocked in put — neither can close a wait-for cycle
    return [(c.src, c.dst, c) for c in graph.channels
            if c.kind == "queue"
            and getattr(c, "drain", "inline") != "dedicated"]


def _find_cycles(graph) -> List[List[Tuple[str, "object"]]]:
    """One elementary cycle per strongly-connected component of the
    queue-edge graph (Tarjan SCC + a DFS walk inside the component)."""
    edges = _queue_edges(graph)
    adj: Dict[str, List[Tuple[str, "object"]]] = {}
    for src, dst, ch in edges:
        adj.setdefault(src, []).append((dst, ch))

    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan: (node, iterator-position) frames
        work = [(v, 0)]
        while work:
            node, pi = work.pop()
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            recurse = False
            succs = adj.get(node, [])
            for i in range(pi, len(succs)):
                w = succs[i][0]
                if w not in index:
                    work.append((node, i + 1))
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for src, _, _ in edges:
        if src not in index:
            strongconnect(src)

    cycles: List[List[Tuple[str, "object"]]] = []
    for comp in sccs:
        comp_set = set(comp)
        self_loops = [ch for src, dst, ch in edges
                      if src == dst and src in comp_set]
        if self_loops:
            cycles.append([(self_loops[0].src, self_loops[0])])
            continue
        if len(comp) < 2:
            continue
        # walk a simple cycle inside the component
        start = comp[0]
        path: List[Tuple[str, "object"]] = []
        seen = {start}
        node = start
        while True:
            nxt = next(((dst, ch) for dst, ch in adj.get(node, [])
                        if dst in comp_set), None)
            if nxt is None:  # pragma: no cover - SCC guarantees an edge
                break
            dst, ch = nxt
            path.append((node, ch))
            if dst == start:
                cycles.append(path)
                break
            if dst in seen:
                # trim the tail before the repeated node
                i = next(i for i, (r, _) in enumerate(path) if r == dst)
                cycles.append(path[i:])
                break
            seen.add(dst)
            node = dst
    return cycles


def verify_graph(graph, nnodes: Optional[int] = None,
                 dp_threshold: Optional[int] = None,
                 path: str = "<graph>") -> List[Finding]:
    """Model-check ``graph`` (a :class:`RoleGraph`); returns TD100-family
    :class:`Finding` objects (line/col 0 — findings are about the graph,
    not a source location)."""
    out: List[Finding] = []
    thr = dp_threshold if dp_threshold is not None \
        else _default_dp_threshold()
    roles = {r.name: r for r in graph.roles}

    # TD101: bounded-queue wait-for cycles.  A cycle in which EVERY edge
    # is credit-annotated is deadlock-free iff every edge has depth >=
    # credits: the producer's claim discipline keeps in-flight <= credits
    # <= depth, so no put on the cycle ever reaches the backpressure wall
    # and no wait-for edge can form (the 1F1B fwd/grad loop).  A single
    # unannotated edge voids the argument — the classic witness stands.
    for cycle in _find_cycles(graph):
        ring = " -> ".join([r for r, _ in cycle] + [cycle[0][0]])
        credited = all(getattr(ch, "credits", None) is not None
                       for _, ch in cycle)
        if credited:
            over = [(r, ch) for r, ch in cycle if ch.depth < ch.credits]
            if not over:
                continue  # credit-disciplined cycle: puts never block
            chans = ", ".join(
                f"{ch.name!r}(depth {ch.depth} < credits {ch.credits})"
                for _, ch in over)
            out.append(Finding(
                "TD101", "error", path, 0, 0,
                f"bounded-channel deadlock: credit-annotated queue cycle "
                f"{ring} has under-depth edge(s) {chans} — the producer's "
                f"declared in-flight window does not fit the channel, so "
                f"its put blocks mid-window and the cycle's claim "
                f"discipline wedges\n{render_credit_witness(cycle, over)}"))
            continue
        chans = ", ".join(f"{ch.name!r}(depth {ch.depth})"
                          for _, ch in cycle)
        out.append(Finding(
            "TD101", "error", path, 0, 0,
            f"bounded-channel deadlock: queue cycle {ring} over {chans} "
            f"— a schedule exists where every role is blocked in put() "
            f"on a full queue only the next blocked role could drain\n"
            f"{render_witness(cycle)}"))

    # TD102: claim-safety under solo restarts.  The healed cases stay
    # silent: a single consumer rewinds orphans at attach, a gang
    # restart re-fences the generation, and a solo respawn inherits the
    # dead rank's persisted claims.  What cannot be healed in place is a
    # tight window: multi-consumer claims are unreturnable (a sibling
    # may have claimed past the dead rank), so with depth <= consumer
    # world a simultaneous kill can strand EVERY slot in orphaned
    # claims until the respawns attach — puts wedge meanwhile.
    for ch in graph.channels:
        if ch.kind != "queue":
            continue
        dst = roles.get(ch.dst)
        if (dst is not None and dst.restart == "solo"
                and dst.world > 1 and ch.depth <= dst.world):
            out.append(Finding(
                "TD102", "warning", path, 0, 0,
                f"channel {ch.name!r}: depth {ch.depth} <= "
                f"{dst.world} solo-restarting consumers — ranks killed "
                f"holding multi-consumer claims (unreturnable: a "
                f"sibling may have claimed past them) can strand the "
                f"entire backpressure window in orphaned claims until "
                f"their respawns inherit them; raise depth above the "
                f"consumer world or restart {ch.dst!r} as a gang "
                f"(replay names the orphans, TD112)"))

    # TD103: restart-policy soundness
    for r in graph.roles:
        if r.node is not None and nnodes is not None and r.node >= nnodes:
            out.append(Finding(
                "TD103", "error", path, 0, 0,
                f"role {r.name!r} pins @node{r.node} but the cluster has "
                f"{nnodes} node(s) (node indices 0..{nnodes - 1}) — "
                f"validate_placement refuses this at spawn"))
    if graph.roles and all(r.restart == "solo" for r in graph.roles):
        out.append(Finding(
            "TD103", "warning", path, 0, 0,
            f"all {len(graph.roles)} role(s) restart solo: the graph has "
            f"no gang anchor, so the generation fence never advances and "
            f"an exhausted solo-restart budget halts the graph with no "
            f"collective restart path"))
    for ch in graph.channels:
        if ch.kind != "queue":
            continue
        src = roles.get(ch.src)
        if (src is not None and src.restart == "solo"
                and src.world > ch.depth):
            out.append(Finding(
                "TD103", "warning", path, 0, 0,
                f"channel {ch.name!r}: depth {ch.depth} < {src.world} "
                f"solo producers — simultaneous kill windows can hole "
                f"every slot, wedging the queue for the full hole-settle "
                f"deadline; raise depth to at least the producer world"))

    # TD104: dp-path feasibility
    for ch in graph.channels:
        dst = roles.get(ch.dst)
        hint = getattr(ch, "payload_bytes", None)
        if (dst is not None and dst.world > 1 and hint is not None
                and hint >= thr):
            out.append(Finding(
                "TD104", "warning", path, 0, 0,
                f"channel {ch.name!r}: consumer role {ch.dst!r} spans "
                f"{dst.world} ranks, so {hint} B payloads stay on the "
                f"store funnel (p2p lane needs a single-rank consumer; "
                f"threshold TPU_DIST_DP_THRESHOLD={thr}) — expect ~96x "
                f"the latency of the data plane at 8 MiB"))

    out.sort(key=lambda f: (f.rule, f.message))
    return out


# -- graph sources ------------------------------------------------------------


def extract_channel_specs(path: str) -> Tuple[List["object"], List[str]]:
    """AST-extract literal ``ChannelSpec(...)`` calls from a Python file.

    Returns ``(specs, notes)`` — notes name calls that were skipped
    because an argument was not a literal (those channels cannot be
    checked statically; point ``--graph`` at the builder instead)."""
    from ..roles.graph import ChannelSpec

    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    fields = ("name", "src", "dst", "depth", "kind", "payload_bytes",
              "drain", "credits")
    specs: List[object] = []
    notes: List[str] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name != "ChannelSpec":
            continue
        kw: Dict[str, object] = {}
        ok = True
        for i, arg in enumerate(node.args):
            try:
                kw[fields[i]] = ast.literal_eval(arg)
            except (ValueError, IndexError):
                ok = False
        for k in node.keywords:
            if k.arg is None:
                ok = False
                continue
            try:
                kw[k.arg] = ast.literal_eval(k.value)
            except ValueError:
                ok = False
        if not ok or not {"name", "src", "dst"} <= set(kw):
            notes.append(
                f"{path}:{node.lineno}: ChannelSpec call with non-literal "
                f"arguments skipped — use --graph to import the builder")
            continue
        try:
            specs.append(ChannelSpec(**kw))
        except Exception as e:
            notes.append(f"{path}:{node.lineno}: invalid ChannelSpec "
                         f"literal skipped ({e})")
    return specs, notes


def parse_channels_spec(text: str) -> List["object"]:
    """Parse a ``--channels`` spec: comma-separated
    ``name:src>dst[:N][:queue|latest][:payload=BYTES]`` entries (a bare
    integer token is the depth, ``queue``/``latest`` the kind)."""
    from ..roles.graph import ChannelSpec, RoleGraphError

    out: List[object] = []
    for entry in [e.strip() for e in text.split(",") if e.strip()]:
        parts = entry.split(":")
        if len(parts) < 2 or ">" not in parts[1]:
            raise RoleGraphError(
                f"bad channel spec {entry!r}: want "
                f"name:src>dst[:depth][:kind][:payload=BYTES]")
        name = parts[0]
        src, _, dst = parts[1].partition(">")
        kw: Dict[str, object] = {"name": name, "src": src.strip(),
                                 "dst": dst.strip()}
        for tok in parts[2:]:
            tok = tok.strip()
            if tok in ("queue", "latest"):
                kw["kind"] = tok
            elif tok.startswith("payload="):
                kw["payload_bytes"] = int(tok[len("payload="):])
            elif tok.isdigit():
                kw["depth"] = int(tok)
            else:
                raise RoleGraphError(
                    f"bad channel spec token {tok!r} in {entry!r}")
        out.append(ChannelSpec(**kw))
    return out


def load_graph_builder(target: str, args_json: Optional[str] = None):
    """Import ``file.py:func`` or ``pkg.mod:func`` and call it with the
    JSON-decoded positional args (``--graph-args '[4]'``); returns the
    RoleGraph the builder returns."""
    import json as _json

    mod_part, _, fn_name = target.rpartition(":")
    if not mod_part:
        raise ValueError(f"--graph wants file.py:func or pkg.mod:func, "
                         f"got {target!r}")
    if mod_part.endswith(".py") or os.path.sep in mod_part:
        spec = importlib.util.spec_from_file_location(
            "_tpu_dist_torch_graph_target", mod_part)
        if spec is None or spec.loader is None:
            raise ValueError(f"cannot import {mod_part!r}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_part)
    fn = getattr(mod, fn_name)
    call_args = _json.loads(args_json) if args_json else []
    if not isinstance(call_args, list):
        call_args = [call_args]
    return fn(*call_args)


def build_graph(roles_spec: Optional[str] = None,
                script: Optional[str] = None,
                channels_spec: Optional[str] = None,
                graph_target: Optional[str] = None,
                graph_args: Optional[str] = None,
                path: str = "<graph>"):
    """Assemble the graph to verify from the CLI/pre-flight inputs.

    Returns ``(graph_or_None, findings, notes)`` — endpoint mismatches
    become TD105 error findings instead of raising, so the pre-flight can
    refuse with the normal findings machinery."""
    from ..roles.graph import RoleGraph, RoleGraphError, parse_roles_spec

    notes: List[str] = []
    findings: List[Finding] = []
    if graph_target:
        graph = load_graph_builder(graph_target, graph_args)
        return graph, findings, notes
    if not roles_spec:
        raise RoleGraphError("no graph source: give --graph, or --roles "
                             "(with an optional script / --channels)")
    base = parse_roles_spec(roles_spec)
    channels = list(base.channels)
    if script and os.path.exists(script) and script.endswith(".py"):
        specs, ex_notes = extract_channel_specs(script)
        channels.extend(specs)
        notes.extend(ex_notes)
    if channels_spec:
        channels.extend(parse_channels_spec(channels_spec))
    role_names = {r.name for r in base.roles}
    kept = []
    seen = set()
    for ch in channels:
        if ch.name in seen:
            continue  # first declaration wins (script + --channels overlap)
        seen.add(ch.name)
        missing = [e for e in (ch.src, ch.dst) if e not in role_names]
        if missing:
            findings.append(Finding(
                "TD105", "error", path, 0, 0,
                f"channel {ch.name!r} endpoint(s) "
                f"{', '.join(repr(m) for m in missing)} not in the role "
                f"spec ({', '.join(sorted(role_names))}) — "
                f"RoleGraphError at spawn"))
            continue
        kept.append(ch)
    try:
        graph = RoleGraph(list(base.roles), kept)
    except RoleGraphError as e:
        findings.append(Finding("TD105", "error", path, 0, 0, str(e)))
        return None, findings, notes
    return graph, findings, notes
