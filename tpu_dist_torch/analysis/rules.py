"""``tpudlint`` rule implementations — AST passes over one module;
counterpart of ``tpu_dist/analysis/rules.py``.

The port spells its collectives, store keys (``tpu_dist/g{gen}/...``),
locks, named errors and role graphs as the JAX package does, so every rule
keeps its JAX code, severity and meaning, and gives the JAX linter's
findings on the same source.

Each rule is a function ``(tree, path) -> [Finding]`` registered in
:data:`RULES`.  The rules encode the distributed-correctness hazards this
framework's own layers are exposed to (see docs/analysis.md for a
deadlocking example per rule):

- **TD001** — collective call inside a rank-conditional branch (classic
  ``if rank == 0: all_reduce(...)``): ranks taking the other branch never
  enter the collective, the participating ranks block forever.  Also fires
  on collectives *after* a rank-conditional early return.
- **TD002** — both branches of a rank-conditional call collectives, but
  different *sequences* of them: ranks pair a ring all-reduce against a
  broadcast and both sides hang (or worse, mis-match payloads).
- **TD003** — raw ``tpu_dist/...`` control-plane store key that is not
  namespaced by gang generation (``tpu_dist/g{gen}/...``) and is not one
  of the known cross-generation infrastructure prefixes.  Stale keys a
  crashed incarnation left behind would collide with a restarted
  incarnation's fresh sequence counters.
- **TD004** — blocking store/queue/socket wait without a deadline: a dead
  peer turns the call into an infinite hang the supervisor cannot name.
- **TD005** — host side effects (store ops, host collectives, ``time``,
  ``random``) inside code that runs once and is then replayed: functions
  traced by ``jax.jit``/``pjit``/``pmap`` (the JAX anchors, kept so the
  rule gives the JAX linter's findings), and the port's trace-once
  constructs — the body of a ``with torch.cuda.graph(...)`` capture, and
  functions passed to ``torch.cuda.make_graphed_callables`` or
  ``torch.jit.trace``/``torch.jit.script``.  They run at trace or capture
  time, once, not per step — silently wrong, and rank-divergent tracing
  deadlocks the compile barrier.
- **TD006** — inconsistent lock-acquisition order inside one module (lock
  A taken under B in one place, B under A in another): the ABBA deadlock
  pattern for transport-style modules full of fine-grained locks.
- **TD008** — sub-group hazards (ROADMAP item 5's sub-group collectives
  rule): a ``new_group(...)`` member list computed from this rank's
  identity (every rank builds a DIFFERENT group — ids, store scopes and
  wire tags can never match), or a collective issued on a literal
  sub-group with no rank/membership guard (non-member ranks reach the
  call and die on ``GroupMembershipError`` — or deadlock the members if
  only some ranks guard).
- **TD009** — broad (``except Exception`` / bare) or explicit handler
  swallowing a *named* tpu_dist error class (``PeerGoneError``,
  ``RankLostError``, ``CollectiveMismatchError``, ``FrameCorruptError``,
  ``CollectiveTimeoutError``) without re-raising or logging: the
  anti-pattern that turns the resilience layer's named diagnoses — and
  every injected netchaos fault — back into silent hangs.
- **TD010** — role-graph channel hazards (tpu_dist.roles): a channel
  ``put``/``get``/``get_latest`` on a channel-named receiver without a
  timeout argument (warning — the TD004 family; channels do have an
  internal default deadline, but loops should state their budget), or a
  ``Channel``/``ChannelSpec`` whose literal ``src``/``dst`` names a role
  absent from the module's ``RoleGraph`` literal (error — a dangling
  endpoint raises ``RoleGraphError`` at runtime and can never carry a
  message).
- **TD011** — hand-rolled ``PartitionSpec`` naming a rule-plane layout
  axis (``model``/``shard``/``expert``) outside ``parallel/rules.py``
  and its spec builders (``gspmd.py``, ``fsdp.py``): parameter
  placements derive from the unified logical-axis table
  (``rules.spec_for``/``partition_pairs``/``spans_for``) — duplicated
  layout literals are exactly how the pjit, ZeRO, reshard and serving
  layouts drifted before the rule plane existed.  The rule keeps its JAX
  anchor only (a ``PartitionSpec`` call, ``as P`` included).  The port
  spells a spec as a plain tuple of mesh-axis names
  (``tpu_dist_torch/parallel/rules.py``), and a tuple heuristic would flag
  every mesh-axes tuple, so in the port's own code the rule finds nothing.

- **TD007** — async collective ``Work`` handle dropped without ``wait()``:
  a bare-expression call with ``async_op=True`` (the handle is discarded
  on the spot), or a handle assigned to a name that is never used again.
  The collective's *errors* travel on the handle (``PeerGoneError``,
  ``CollectiveMismatchError`` re-raise at ``wait()``) — dropping it
  swallows the diagnosis, and gradients synced this way are silently
  unordered against the consumer.

Heuristics are deliberately name-based (``rank``-ish identifiers,
``*_host`` collectives, ``_mu``/``_lock``/``_cv`` locks): this linter
checks *this* codebase's conventions, the same way PR 2 fixed the key
namespace by convention.  False positives are expected to be silenced with
a justified ``# tpudlint: disable=TDnnn`` (findings.py).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = ["RULES", "RULE_DOCS", "run_rules",
           "COLLECTIVE_CALLS", "RANK_NAMES"]

# -- shared vocabulary --------------------------------------------------------

# identifiers whose value is (a function of) this process's rank
RANK_NAMES = frozenset({
    "rank", "local_rank", "node_rank", "global_rank", "process_id",
    "process_index", "proc_id", "worker_rank",
})
RANK_CALLS = frozenset({
    "get_rank", "get_local_rank", "process_index", "get_process_index",
})

# blocking cross-rank collectives: every rank of the group must call these
# the same number of times in the same order.  Point-to-point send/recv are
# rank-asymmetric BY DESIGN and deliberately absent.
COLLECTIVE_CALLS = frozenset({
    "all_reduce_host", "all_gather_host", "broadcast_host", "reduce_host",
    "gather_host", "scatter_host", "all_to_all_host",
    "all_gather_object", "gather_object", "broadcast_object_list",
    "scatter_object_list",
    "barrier", "monitored_barrier",
    "ring_all_reduce", "ring_all_gather", "ring_reduce_scatter",
    "tree_broadcast",
})

# blocking waits that need a deadline (TD004); per-method positional index
# (0-based) at which a timeout may legally arrive positionally
_WAIT_METHODS: Dict[str, int] = {
    "wait": 1,             # store.wait(keys, timeout)
    "wait_value_ge": 2,    # store.wait_value_ge(key, target, timeout)
    "wait_ge": 2,
    "barrier": 2,          # store.barrier(world, tag, timeout)
    "monitored_barrier": 2,
    "recv_array": 2,       # dp.recv_array(src, tag, timeout)
    "wait_done": 0,        # serve RequestHandle.wait_done(timeout)
    "drain": 0,            # serve Scheduler.drain(timeout)
    "recv_plan": 0,        # serve ShardFollower.recv_plan(timeout): a
                           # dead shard leader must surface as a named
                           # PeerGoneError/TimeoutError, never a hang
    "fetch": 2,            # disagg KVTransfer.fetch(src, rid, timeout):
                           # receiver-gated on kv/xfer names in the rule
                           # body — `fetch` is too common a verb to flag
                           # on arbitrary receivers
}
_TIMEOUT_KWARGS = frozenset({"timeout", "deadline", "timeout_s"})

# cross-generation infrastructure keys that legitimately live OUTSIDE the
# g{gen} namespace (bootstrap/liveness/supervisor agreement — written and
# reaped by the launcher itself, see docs/analysis.md#td003)
TD003_ALLOWED_PREFIXES = (
    "tpu_dist/alive",       # pre-rendezvous liveness (reset every round)
    "tpu_dist/generation",  # THE generation fence key itself
    "tpu_dist/master_port", # coordinator port negotiation (pre-generation)
    "tpu_dist/elastic",     # launcher restart agreement (round-scoped keys)
    "tpu_dist/hb",          # heartbeats (generation-scoped by path segment)
    "tpu_dist/serve",       # serving-role service discovery (backend/gateway
                            # addresses): overwritten by each incarnation and
                            # read ACROSS restarts by design — the gateway
                            # re-resolves a restarted backend through it
    "tpu_dist/cluster",     # cluster control plane (node registry, leases,
                            # replica liveness, cross-launcher elastic
                            # counts and roles-gang agreement): written by
                            # node agents/launchers, read ACROSS
                            # generations and leader failovers by design —
                            # the election and the cluster re-form both
                            # outlive any single generation
    "tpu_dist/g",           # already in the generation namespace
)

_LOCK_SUFFIXES = ("_mu", "_lock", "_cv", "_cond", "_mutex")
_LOCK_EXACT = frozenset({"mu", "lock", "cv", "cond", "mutex", "lk"})


def _terminal_name(func: ast.AST) -> Optional[str]:
    """The final identifier of a call target: ``C.all_reduce_host`` ->
    ``all_reduce_host``; ``barrier`` -> ``barrier``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """Dotted path of a Name/Attribute chain (``self._out_mu`` ->
    ``self._out_mu``), or None for non-trivial expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_rank(expr: ast.AST) -> bool:
    """True when the expression reads a rank-ish identifier or calls a
    rank accessor — the test of a rank-conditional branch."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in RANK_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in RANK_NAMES:
            return True
        if isinstance(node, ast.Call):
            name = _terminal_name(node.func)
            if name in RANK_CALLS:
                return True
    return False


def _subgroup_names(tree: ast.AST) -> frozenset:
    """Names bound from ``new_group(...)`` anywhere in the module.
    Collectives scoped ``group=<one of these>`` are *expected* to sit
    under rank/membership guards (only members call them), so TD001/TD002
    leave them to TD008's membership analysis."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _terminal_name(node.value.func) == "new_group":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return frozenset(names)


def _subgroup_scoped(call: ast.Call, skip: frozenset) -> bool:
    for kw in call.keywords:
        if kw.arg == "group" and isinstance(kw.value, ast.Name) \
                and kw.value.id in skip:
            return True
    return False


def _collective_sequence(stmts: Sequence[ast.stmt],
                         skip: frozenset = frozenset()) -> List[ast.Call]:
    """All collective Call nodes in the statements' subtrees, in source
    order (the *sequence* every rank must agree on).  Sub-group-scoped
    calls (``skip``) are excluded — their agreement set is the group's
    members, not every rank reaching this code."""
    calls = []
    for stmt in stmts:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and _terminal_name(node.func) in COLLECTIVE_CALLS
                    and not _subgroup_scoped(node, skip)):
                calls.append(node)
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return calls


def _canonical_names(stmts: Sequence[ast.stmt],
                     skip: frozenset = frozenset()) -> List[str]:
    """Collective-call name sequence a rank EXECUTES through these
    statements: a nested conditional whose branches contribute identical
    sequences counts once (either path makes the same calls), so
    `if fast: all_reduce(...) else: all_reduce(...)` is one call, not
    two.  Divergent nested branches are flattened — a nested *rank*
    conditional gets its own TD001/TD002 visit anyway."""
    out: List[str] = []
    for stmt in stmts:
        out.extend(_canonical_names_node(stmt, skip))
    return out


def _canonical_names_node(node: ast.AST,
                          skip: frozenset = frozenset()) -> List[str]:
    if isinstance(node, ast.If):
        test = _canonical_names_node(node.test, skip)
        body = _canonical_names(node.body, skip)
        orelse = _canonical_names(node.orelse, skip)
        return test + (body if body == orelse else body + orelse)
    out: List[str] = []
    for child in ast.iter_child_nodes(node):
        out.extend(_canonical_names_node(child, skip))
    if isinstance(node, ast.Call):
        name = _terminal_name(node.func)
        if name in COLLECTIVE_CALLS and not _subgroup_scoped(node, skip):
            out.append(name)  # after children: argument-evaluation order
    return out


def _src(node: ast.AST, limit: int = 60) -> str:
    try:
        text = ast.unparse(node)
    except Exception:
        return "<expr>"
    return text if len(text) <= limit else text[:limit - 3] + "..."


def _branch_terminates(stmts: Sequence[ast.stmt]) -> bool:
    """True when the branch unconditionally leaves the enclosing block
    (return/raise/continue/break as a top-level statement)."""
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Continue,
                              ast.Break)) for s in stmts)


# -- TD001 / TD002: rank-divergent collectives --------------------------------


def _check_rank_if(test: ast.expr, body: Sequence[ast.stmt],
                   orelse: Sequence[ast.stmt], path: str,
                   out: List[Finding],
                   skip: frozenset = frozenset()) -> None:
    # canonical sequences decide consistency (nested same-on-both-sides
    # conditionals count once); raw Call nodes locate the TD001 findings
    names_body = _canonical_names(body, skip)
    names_else = _canonical_names(orelse, skip)
    if names_body == names_else:
        return  # both sides run the same collective sequence: consistent
    seq_body = _collective_sequence(body, skip)
    seq_else = _collective_sequence(orelse, skip)
    if names_body and names_else:
        out.append(Finding(
            "TD002", "error", path, test.lineno, test.col_offset,
            f"branches of rank-conditional `if {_src(test)}` call divergent "
            f"collective sequences ({names_body} vs {names_else}); ranks "
            f"taking different branches enter mismatched collectives and "
            f"deadlock"))
        return
    for call in (seq_body or seq_else):
        out.append(Finding(
            "TD001", "error", path, call.lineno, call.col_offset,
            f"collective {_terminal_name(call.func)}() inside "
            f"rank-conditional branch (`if {_src(test)}`): ranks taking "
            f"the other branch never enter it — the group deadlocks"))


def rule_td001_td002(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    skip = _subgroup_names(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and _mentions_rank(node.test):
            _check_rank_if(node.test, node.body, node.orelse, path, out,
                           skip)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.For, ast.While, ast.With)):
            # rank-conditional EARLY RETURN: `if rank != 0: return` followed
            # by collectives — the remaining ranks block in them forever
            _check_early_exit(node.body, path, out, skip)
    return out


def _check_early_exit(stmts: Sequence[ast.stmt], path: str,
                      out: List[Finding],
                      skip: frozenset = frozenset()) -> None:
    for i, stmt in enumerate(stmts):
        if (isinstance(stmt, ast.If) and _mentions_rank(stmt.test)
                and not stmt.orelse and _branch_terminates(stmt.body)
                and not _collective_sequence(stmt.body, skip)):
            for call in _collective_sequence(stmts[i + 1:], skip):
                out.append(Finding(
                    "TD001", "error", path, call.lineno, call.col_offset,
                    f"collective {_terminal_name(call.func)}() is only "
                    f"reached by ranks that pass the rank-conditional "
                    f"early exit at line {stmt.lineno} "
                    f"(`if {_src(stmt.test)}`): the exiting ranks never "
                    f"join it — the group deadlocks"))
            return  # one diagnosis per block; nested blocks walk separately


# -- TD003: un-namespaced store keys ------------------------------------------


def _key_literal_prefix(node: ast.AST) -> Optional[Tuple[str, bool]]:
    """``(literal_prefix, generation_namespaced)`` for a string constant or
    f-string, or None for other expressions.  ``generation_namespaced`` is
    True when the first path segment after ``tpu_dist/`` is ``g`` + an
    interpolated value or digits (the ``tpu_dist/g{gen}/...`` shape)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        text = node.value
    elif isinstance(node, ast.JoinedStr):
        first = node.values[0] if node.values else None
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            return None
        text = first.value
        # "tpu_dist/g{rdzv.generation()}/..." — the literal head ends right
        # at "g" and the interpolation supplies the generation number
        if text.startswith("tpu_dist/g") and len(node.values) > 1:
            rest = text[len("tpu_dist/g"):]
            if rest == "" or rest.isdigit():
                return text, True
    else:
        return None
    # tpudlint: disable=TD003  # prefix literals of the rule itself
    if not text.startswith("tpu_dist/"):
        return None
    # tpudlint: disable=TD003  # the rule's own prefix literal, as above
    seg = text[len("tpu_dist/"):].split("/", 1)[0]
    namespaced = seg.startswith("g") and seg[1:].isdigit() and len(seg) > 1
    return text, namespaced


def _is_docstring_position(parents: Dict[ast.AST, ast.AST],
                           node: ast.AST) -> bool:
    parent = parents.get(node)
    return isinstance(parent, ast.Expr)


def rule_td003(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    seen_joined: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                seen_joined.add(id(v))
        lit = _key_literal_prefix(node)
        if lit is None or id(node) in seen_joined:
            continue
        if _is_docstring_position(parents, node):
            continue  # docstrings routinely NAME keys; they don't mint them
        text, namespaced = lit
        if namespaced:
            continue
        if any(text == p or text.startswith(p + "/")
               for p in TD003_ALLOWED_PREFIXES):
            continue
        out.append(Finding(
            "TD003", "error", path, node.lineno, node.col_offset,
            f"raw store key {text!r} is not namespaced by gang generation: "
            f"route it through the generation helper "
            f"(tpu_dist/g{{gen}}/..., see "
            f"tpu_dist_torch.collectives.eager._ns) or a documented "
            f"cross-generation prefix — stale keys from a crashed "
            f"incarnation otherwise collide with the restarted one"))
    return out


# -- TD004: deadline-less blocking waits --------------------------------------


def _has_timeout(call: ast.Call, method: str) -> bool:
    for kw in call.keywords:
        if kw.arg in _TIMEOUT_KWARGS:
            return True
    pos_idx = _WAIT_METHODS[method]
    return len(call.args) > pos_idx


def rule_td004(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal_name(node.func)
        if name not in _WAIT_METHODS or not isinstance(node.func,
                                                       ast.Attribute):
            continue
        if _has_timeout(node, name):
            continue
        recv = _dotted(node.func.value) or "<expr>"
        if name == "fetch" and "kv" not in recv.lower() \
                and "xfer" not in recv.lower():
            # only the disagg KV-transfer fetch blocks on a dead peer;
            # any other receiver's fetch is ordinary vocabulary
            continue
        if name == "wait" and len(node.args) == 1 \
                and "store" not in recv.lower():
            # cv.wait(t) / event.wait(t): the single positional IS the
            # timeout; only store.wait(keys) takes keys first
            continue
        out.append(Finding(
            "TD004", "warning", path, node.lineno, node.col_offset,
            f"blocking {recv}.{name}(...) without a timeout/deadline "
            f"argument: a dead peer turns this into an unbounded hang the "
            f"supervisor cannot diagnose — pass timeout= (or suppress with "
            f"a justification if an internal default deadline applies)"))
    return out


# -- TD005: host side effects under jit or a capture -------------------------


_JIT_NAMES = frozenset({"jit", "pjit", "pmap"})


def _is_jit_expr(node: ast.AST) -> bool:
    """True for ``jax.jit`` / ``pjit`` / ``partial(jax.jit, ...)`` /
    ``jax.jit(...)`` decorator expressions."""
    name = _terminal_name(node) if isinstance(node, (ast.Name,
                                                     ast.Attribute)) else None
    if name in _JIT_NAMES:
        return True
    if isinstance(node, ast.Call):
        fname = _terminal_name(node.func)
        if fname in _JIT_NAMES:
            return True
        if fname == "partial" and node.args \
                and _terminal_name(node.args[0]) in _JIT_NAMES:
            return True
    return False


_TIME_FUNCS = frozenset({"time", "sleep", "perf_counter", "monotonic",
                         "time_ns", "perf_counter_ns", "monotonic_ns"})
_STORE_OPS = frozenset({"set", "get", "add", "check", "delete_key",
                        "delete_prefix", "wait", "wait_value_ge", "barrier",
                        "num_keys"})


def _td005_offense(call: ast.Call,
                   rng_hint: str = "use jax.random with a key"
                   ) -> Optional[str]:
    name = _terminal_name(call.func)
    dotted = _dotted(call.func) or name or ""
    root = dotted.split(".", 1)[0]
    if root == "time" and name in _TIME_FUNCS:
        return f"wall-clock call {dotted}()"
    if root == "random" or dotted.startswith(("np.random.", "numpy.random.")):
        return f"host RNG call {dotted}() ({rng_hint})"
    if name in COLLECTIVE_CALLS:
        return f"host collective {name}()"
    if name in _STORE_OPS and isinstance(call.func, ast.Attribute):
        recv = (_dotted(call.func.value) or "").lower()
        if "store" in recv:
            return f"control-plane store op {dotted}()"
    return None


def _jitted_functions(tree: ast.AST):
    """FunctionDefs that are jit-traced: decorated with a jit expression,
    or referenced by a ``jax.jit(fn)`` call in the same module."""
    by_name: Dict[str, ast.AST] = {}
    jitted = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)
            if any(_is_jit_expr(d) for d in node.decorator_list):
                jitted.append(node)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _terminal_name(node.func) in _JIT_NAMES:
            for arg in node.args:
                target = _terminal_name(arg) if isinstance(
                    arg, (ast.Name, ast.Attribute)) else None
                fn = by_name.get(target or "")
                if fn is not None and fn not in jitted:
                    jitted.append(fn)
    return jitted


# the port's trace-once constructs, as dotted-name suffixes: functions
# handed to the tracers run once when traced or captured; the body of a
# ``with torch.cuda.graph(...)`` block runs once at capture, and every
# replay afterwards runs the captured kernels only
_TORCH_TRACERS = ("cuda.make_graphed_callables", "jit.trace", "jit.script")
_TORCH_CAPTURE = "cuda.graph"


def _torch_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local names bound by ``from torch.cuda import graph`` (or from
    ``torch.jit``), mapped to their dotted suffix (``cuda.graph``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) \
                and node.module in ("torch.cuda", "torch.jit"):
            short = node.module.split(".", 1)[1]
            for alias in node.names:
                out[alias.asname or alias.name] = f"{short}.{alias.name}"
    return out


def _torch_construct(func: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """The trace-once suffix a call target names (``jit.trace``,
    ``cuda.graph``, ...), or None."""
    dotted = _dotted(func)
    if dotted is None:
        return None
    dotted = aliases.get(dotted, dotted)
    for suffix in _TORCH_TRACERS + (_TORCH_CAPTURE,):
        if dotted == suffix or dotted.endswith("." + suffix):
            return suffix
    return None


def _torch_traced_functions(tree: ast.AST, aliases: Dict[str, str]):
    """``[(FunctionDef, tracer)]``: functions decorated with
    ``torch.jit.script``/``trace``, or passed by name (alone, or in a tuple
    or list) as the first argument of a tracer or of
    ``torch.cuda.make_graphed_callables`` in the same module."""
    by_name: Dict[str, ast.AST] = {}
    out: List[Tuple[ast.AST, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)
            for d in node.decorator_list:
                kind = _torch_construct(
                    d.func if isinstance(d, ast.Call) else d, aliases)
                if kind in _TORCH_TRACERS:
                    out.append((node, kind))
                    break
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        kind = _torch_construct(node.func, aliases)
        if kind not in _TORCH_TRACERS:
            continue
        first = node.args[0]
        for arg in (first.elts if isinstance(first, (ast.Tuple, ast.List))
                    else [first]):
            target = _terminal_name(arg) if isinstance(
                arg, (ast.Name, ast.Attribute)) else None
            fn = by_name.get(target or "")
            if fn is not None and all(fn is not f for f, _ in out):
                out.append((fn, kind))
    return out


def _graph_captures(tree: ast.AST, aliases: Dict[str, str]):
    """``with torch.cuda.graph(...)`` statements."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and _torch_construct(item.context_expr.func, aliases)
                == _TORCH_CAPTURE for item in node.items):
            yield node


def rule_td005(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in _jitted_functions(tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            offense = _td005_offense(node)
            if offense:
                out.append(Finding(
                    "TD005", "error", path, node.lineno, node.col_offset,
                    f"{offense} inside jit-traced function "
                    f"`{fn.name}`: runs once at trace time (not per step) "
                    f"and may diverge across ranks during compilation"))
    seen = {(f.line, f.col) for f in out}

    def scan(stmts, where: str) -> None:
        for stmt in stmts:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call) \
                        or (node.lineno, node.col_offset) in seen:
                    continue
                offense = _td005_offense(
                    node, "draw from a torch.Generator on the device")
                if offense:
                    seen.add((node.lineno, node.col_offset))
                    out.append(Finding(
                        "TD005", "error", path, node.lineno,
                        node.col_offset,
                        f"{offense} inside {where}: runs once when traced "
                        f"or captured (not on every replay) and may "
                        f"diverge across ranks"))

    aliases = _torch_aliases(tree)
    for fn, kind in _torch_traced_functions(tree, aliases):
        scan([fn], f"function `{fn.name}` traced by torch.{kind}()")
    for w in _graph_captures(tree, aliases):
        scan(w.body, f"the torch.cuda.graph capture at line {w.lineno}")
    return out


# -- TD006: lock-acquisition order --------------------------------------------


def _lock_name(expr: ast.AST) -> Optional[str]:
    dotted = _dotted(expr)
    if dotted is None:
        return None
    last = dotted.rsplit(".", 1)[-1].lower()
    if last in _LOCK_EXACT or last.endswith(_LOCK_SUFFIXES):
        return dotted
    return None


class _LockOrderVisitor(ast.NodeVisitor):
    """Collects (outer, inner) lock-nesting edges from `with` blocks.

    Per-function lock stacks (a `with` in one function does not cover a
    nested function's body at runtime), aggregated module-wide — two
    functions disagreeing on order is exactly the ABBA hazard."""

    def __init__(self):
        self.edges: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._stack: List[str] = []

    def _visit_scope(self, node):
        saved, self._stack = self._stack, []
        self.generic_visit(node)
        self._stack = saved

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_Lambda = _visit_scope

    def visit_With(self, node: ast.With):
        names = []
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call):
                ctx = ctx.func  # with self._out_lock(dst): -> _out_lock
            name = _lock_name(ctx)
            if name:
                names.append(name)
        for i, name in enumerate(names):
            # `with a, b:` acquires left to right — the earlier items of
            # the same statement are held when the later ones are taken
            for held in self._stack + names[:i]:
                if held != name:
                    self.edges.setdefault(
                        (held, name), (node.lineno, node.col_offset))
        self._stack.extend(names)
        self.generic_visit(node)
        del self._stack[len(self._stack) - len(names):]


def rule_td006(tree: ast.AST, path: str) -> List[Finding]:
    v = _LockOrderVisitor()
    v.visit(tree)
    out: List[Finding] = []
    reported = set()
    for (a, b), (line, col) in sorted(v.edges.items(),
                                      key=lambda kv: kv[1]):
        if (b, a) in v.edges and frozenset((a, b)) not in reported:
            reported.add(frozenset((a, b)))
            other_line = v.edges[(b, a)][0]
            first, second = ((a, b, line), (b, a, other_line))
            if other_line < line:
                first, second = second, first
            out.append(Finding(
                "TD006", "warning", path, second[2], col,
                f"inconsistent lock order: {second[0]} -> {second[1]} "
                f"here, but {first[0]} -> {first[1]} at line {first[2]} — "
                f"two threads taking the locks in opposite order deadlock "
                f"(ABBA)"))
    return out


# -- TD007: dropped async Work handles ----------------------------------------

# calls whose async_op=True form returns a Work future (the eager
# collectives), plus the bucketer issue call which ALWAYS returns a
# BucketWork needing wait_all()
_ASYNC_ISSUERS = COLLECTIVE_CALLS | {"send", "recv"}


def _is_async_call(node: ast.AST) -> bool:
    """A call that returns a Work-like handle: any collective/p2p call with
    a truthy-constant ``async_op=``; ``<bucketer>.all_reduce(...)`` /
    ``<bucketer>.reduce_scatter(...)`` (always return a BucketWork); or a
    ZeRO optimizer's handle-returning calls (``<zero-ish>.update(...)``
    yields the async param-gather handle, ``<zero-ish>.reduce_scatter(...)``
    the in-flight gradient shards).  Handles *held* somewhere — a tuple
    unpack, an attribute, a container — count as used; only a
    bare-expression drop or a never-read name fires, so the lazily-waited
    param gather a train loop keeps in state is not a finding."""
    if not isinstance(node, ast.Call):
        return False
    name = _terminal_name(node.func)
    if name in _ASYNC_ISSUERS:
        for kw in node.keywords:
            if kw.arg == "async_op" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False
    if not isinstance(node.func, ast.Attribute):
        return False
    recv_name = (_dotted(node.func.value) or "").lower()
    # disagg KV transfer: <kv/xfer>.fetch(src, rid, timeout,
    # async_op=True) returns a Work-like handle — the captured
    # KVTransferError (dead prefill rank, geometry drift) surfaces only
    # at wait(), so dropping it loses the failure with the result.
    # (kv.send's async form is already covered by _ASYNC_ISSUERS.)
    if name == "fetch" and ("kv" in recv_name or "xfer" in recv_name):
        for kw in node.keywords:
            if kw.arg == "async_op" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False
    if name in ("all_reduce", "reduce_scatter") \
            and ("bucketer" in recv_name or "zopt" in recv_name
                 or "zero" in recv_name):
        return True
    # sharded-serving partial combines: <shard/decoder>.all_reduce(part,
    # async_op=True) returns a Work handle on the group's ordered engine
    # (tpu_dist/serve/sharded.py); the SYNC form returns the reduced
    # array, so only the truthy async_op spelling is a handle drop
    if name == "all_reduce" and ("shard" in recv_name
                                 or "decoder" in recv_name):
        for kw in node.keywords:
            if kw.arg == "async_op" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False
    # .update() is ubiquitous (dict/set/Counter) — only receivers that
    # unambiguously name a ZeRO optimizer count, not any *zero* substring
    if name == "update" and ("zopt" in recv_name or "zeroopt" in recv_name
                             or "zero_opt" in recv_name):
        return True
    # host-pipeline issuers (tpu_dist/pipeline): a stage's async
    # activation/gradient put — <stage/pipe>.send_async(...) ALWAYS
    # returns a PendingSend whose captured channel error (closed, peer
    # gone, backpressure timeout) surfaces only at wait() — and the
    # trainer's step handle: <trainer/pipe>.step(...) returns the
    # StepHandle that applies the optimizer update at wait(); dropping
    # it silently drops the whole step.  ``.step()`` is common English,
    # so only receivers that name a trainer/pipeline count.
    if name == "send_async" and ("stage" in recv_name
                                 or "pipe" in recv_name):
        return True
    if name == "step" and ("trainer" in recv_name or "pipe" in recv_name):
        return True
    # handle-returning submits: the ordered collective engine
    # (collectives/work.py Engine.submit -> Work) and the serving layer
    # (Scheduler.submit / ServeClient.submit -> RequestHandle, whose
    # captured errors — QueueFullError, BackendGoneError — surface at
    # wait_done()).  ThreadPoolExecutor receivers (pool/executor) are
    # deliberately NOT matched.
    if name == "submit" and ("engine" in recv_name or "sched" in recv_name
                             or "serve" in recv_name
                             or "client" in recv_name) \
            and "pool" not in recv_name and "executor" not in recv_name:
        # the exclusion keeps the carve-out honest for names that hit both
        # vocabularies (client_pool.submit is an executor, not an issuer)
        return True
    return False


def _scopes(tree: ast.AST):
    """Module + every function definition (a handle's liveness is judged
    within its enclosing scope, nested functions included — a closure
    waiting on it counts as a use)."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def rule_td007(tree: ast.AST, path: str) -> List[Finding]:
    # bare-expression drops are judged globally; assigned-then-unused is
    # judged per scope (module + each function), where "use" is any
    # load-context read of the name anywhere under the scope — a closure
    # or loop waiting on the handle counts.  A statement nested in a
    # function is seen by both its function's walk and the module walk;
    # the location-keyed dedupe keeps one finding, and the module walk's
    # superset of loads can only suppress, never add, assign findings.
    out: List[Finding] = []
    seen = set()

    def emit(f: Finding) -> None:
        key = (f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)

    for scope in _scopes(tree):
        loads: Dict[str, int] = {}
        for node in ast.walk(scope):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                loads[node.id] = loads.get(node.id, 0) + 1
        for stmt in ast.walk(scope):
            if not isinstance(stmt, (ast.Expr, ast.Assign)) \
                    or not _is_async_call(stmt.value):
                continue
            call = stmt.value
            name = _terminal_name(call.func)
            if isinstance(stmt, ast.Expr):
                emit(Finding(
                    "TD007", "error", path, call.lineno, call.col_offset,
                    f"async collective {name}(..., async_op=True) discards "
                    f"its Work handle: the result AND any captured error "
                    f"(PeerGoneError, CollectiveMismatchError) are lost — "
                    f"keep the handle and wait()/wait_all() it"))
                continue
            for t in stmt.targets:
                if isinstance(t, ast.Name) and loads.get(t.id, 0) == 0:
                    emit(Finding(
                        "TD007", "warning", path, call.lineno,
                        call.col_offset,
                        f"async collective handle `{t.id}` from "
                        f"{name}(...) is never used: nothing ever wait()s "
                        f"on it, so its result and captured errors are "
                        f"silently dropped"))
    out.sort(key=lambda f: (f.line, f.col))
    return out


# -- TD008: sub-group construction / membership hazards -----------------------
#
# new_group() (tpu_dist/collectives/topology.py, the torch new_group
# analogue) must be called by EVERY rank with the IDENTICAL member list —
# the group id that namespaces store keys and wire tags derives from it, so
# rank-divergent lists mint divergent groups whose collectives can never
# match.  And a collective issued on a literal sub-group without any
# rank/membership guard runs on ranks that may not be members, which the
# runtime rejects (GroupMembershipError) — or worse, desynchronizes the
# members if the guard exists on some ranks only.


def _membership_guarded(parents: Dict[ast.AST, ast.AST], node: ast.AST,
                        group_name: str) -> bool:
    """True when an enclosing ``if`` tests rank-ness or the group object
    itself (``if rank in members:``, ``if g.rank is not None:``,
    ``if me in g.members:``, ...) — the caller is gating on membership."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.If):
            test = cur.test
            if _mentions_rank(test):
                return True
            for sub in ast.walk(test):
                if isinstance(sub, ast.Name) and sub.id == group_name:
                    return True
        cur = parents.get(cur)
    return False


def rule_td008(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    # (a) member list computed from this rank's identity: every rank gets a
    # DIFFERENT group — keys/tags/sanitizer scopes can never line up
    literal_groups: Dict[str, int] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _terminal_name(node.func) == "new_group"):
            continue
        member_args = list(node.args) + [kw.value for kw in node.keywords
                                         if kw.arg == "ranks"]
        for arg in member_args:
            if _mentions_rank(arg):
                out.append(Finding(
                    "TD008", "error", path, node.lineno, node.col_offset,
                    f"new_group member list `{_src(arg)}` depends on this "
                    f"process's rank: every rank must pass the IDENTICAL "
                    f"list (torch new_group semantics) — rank-divergent "
                    f"lists mint divergent group ids whose collectives "
                    f"deadlock instead of matching"))
        # remember names bound to groups with fully-literal member lists
        # for the membership check below
        assign = parents.get(node)
        if isinstance(assign, ast.Assign) and member_args:
            m = member_args[0]
            if isinstance(m, (ast.List, ast.Tuple)) and all(
                    isinstance(e, ast.Constant) for e in m.elts):
                for t in assign.targets:
                    if isinstance(t, ast.Name):
                        literal_groups[t.id] = node.lineno

    # (b) collective on a literal sub-group with no rank/membership guard:
    # non-member ranks reaching this call either die on
    # GroupMembershipError or (guarded on SOME ranks only) desynchronize
    # the members
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _terminal_name(node.func) in COLLECTIVE_CALLS):
            continue
        for kw in node.keywords:
            if kw.arg != "group" or not isinstance(kw.value, ast.Name):
                continue
            gname = kw.value.id
            if gname not in literal_groups:
                continue
            if _membership_guarded(parents, node, gname):
                continue
            out.append(Finding(
                "TD008", "warning", path, node.lineno, node.col_offset,
                f"collective {_terminal_name(node.func)}(group={gname}) on "
                f"the sub-group built at line {literal_groups[gname]} has "
                f"no rank/membership guard: ranks outside the member list "
                f"reach this call too — gate it (e.g. `if rank in "
                f"members:` / `if {gname}.rank is not None:`) or run it on "
                f"every rank of a group they are all members of"))
    out.sort(key=lambda f: (f.line, f.col))
    return out


# -- TD009: broad except swallowing named tpu_dist error classes --------------
#
# The resilience/netchaos layers spend a lot of machinery converting hangs
# and silent corruption into NAMED errors (PeerGoneError, RankLostError,
# CollectiveMismatchError, FrameCorruptError, CollectiveTimeoutError).  A
# `try: all_reduce_host(...)\nexcept Exception: pass` converts them right
# back into silent wrong-results/hangs — the diagnosis is swallowed, the
# peers keep waiting.  The rule fires on (a) a broad handler (bare,
# Exception, BaseException) whose try body issues calls that raise the
# named classes, and (b) an explicit catch of a named class — in either
# case only when the handler neither re-raises nor records the error
# (log_event / logger methods / a request-failing callback).

_TD009_NAMED_ERRORS = frozenset({
    "PeerGoneError", "RankLostError", "CollectiveMismatchError",
    "FrameCorruptError", "CollectiveTimeoutError",
})
_TD009_BROAD = frozenset({"Exception", "BaseException"})
# calls whose failure modes are exactly the named error classes
_TD009_SOURCES = COLLECTIVE_CALLS | frozenset({
    "send", "recv", "recv_array", "recv_array_dual", "send_array",
    "send_quant", "wait_done", "wait_all",
})
# handler calls that count as propagating/recording the diagnosis
_TD009_SINKS = frozenset({
    "log_event", "warning", "error", "exception", "critical", "warn",
    "fail", "fail_slot", "fail_all", "safe_record",
})


def _handler_caught(htype: ast.AST):
    """Names a handler catches: set of identifiers, or None for bare."""
    if htype is None:
        return None
    nodes = htype.elts if isinstance(htype, ast.Tuple) else [htype]
    names = set()
    for n in nodes:
        name = _terminal_name(n)
        if name:
            names.add(name)
    return names


def _handler_propagates(handler: ast.ExceptHandler) -> bool:
    for n in ast.walk(handler):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Call) and _terminal_name(n.func) in _TD009_SINKS:
            return True
    return False


def rule_td009(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        try_calls = set()
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    name = _terminal_name(sub.func)
                    if name in _TD009_SOURCES:
                        try_calls.add(name)
        for handler in node.handlers:
            caught = _handler_caught(handler.type)
            named = (caught or set()) & _TD009_NAMED_ERRORS
            broad = caught is None or bool(caught & _TD009_BROAD)
            if not (named or (broad and try_calls)):
                continue
            if _handler_propagates(handler):
                continue
            what = (f"named error class(es) {sorted(named)}" if named
                    else f"errors from {sorted(try_calls)} (PeerGoneError, "
                         f"FrameCorruptError, CollectiveTimeoutError, ...)")
            shape = ("bare except" if caught is None
                     else f"except {'/'.join(sorted(caught))}")
            out.append(Finding(
                "TD009", "error", path, handler.lineno, handler.col_offset,
                f"{shape} swallows {what} without re-raising or logging: "
                f"the named diagnosis the resilience layer produced is "
                f"discarded, turning an injected/real network fault back "
                f"into a silent hang or wrong result — re-raise, "
                f"log_event(...), or fail the owning request by name"))
    out.sort(key=lambda f: (f.line, f.col))
    return out


# -- TD010: role-graph channel hazards ----------------------------------------
#
# Two checks for tpu_dist.roles (docs/roles.md):
#
# (a) TD004-family deadline check on CHANNEL ops: `ch.get()` / `ch.put(x)`
#     / `ch.get_latest(v)` without a timeout argument.  Channels do carry
#     an internal default deadline (TPU_DIST_CH_TIMEOUT), so this is a
#     warning, not an error — but a producer/consumer loop should state
#     its budget explicitly, exactly like store waits.  Receiver-gated
#     ("ch"/"chan"/"channel"-named receivers), because bare `get`/`put`
#     are the most overloaded method names in Python (dict.get,
#     queue.put) — same discipline as TD007's receiver gating.
#
# (b) a ChannelSpec whose literal src=/dst= role name — or a direct
#     Channel rig constructor whose literal role= argument — is
#     absent from the module's RoleGraph literal: the graph constructor
#     raises at runtime (dangling endpoint), but only on the rank that
#     builds it — statically it is always a bug.  Only enforced when the
#     module's Role(...) literals are all string constants (a
#     dynamically-built graph disables the check rather than guessing).

_TD010_CHANNEL_EXACT = frozenset({"ch", "chan", "channel"})
_TD010_CHANNEL_SUFFIXES = ("_ch", "_chan", "_channel")
# blocking channel ops -> 0-based positional index at which a timeout may
# legally arrive (put(value, timeout) / get(timeout) /
# get_latest(last_version, timeout)); put_latest never blocks
_TD010_BLOCKING = {"put": 1, "get": 0, "get_latest": 1}
# endpoint-bearing callables -> (positional index, kwarg name) of their
# role-name arguments: ChannelSpec names roles at (name, src, dst, ...);
# Channel (the direct rig constructor) names THIS endpoint's role at
# (spec, store, rank, role, ...)
_TD010_ENDPOINT_CALLS = {
    "ChannelSpec": ((1, "src"), (2, "dst")),
    "Channel": ((3, "role"),),
}


def _channel_receiver(call: ast.Call) -> Optional[str]:
    """The receiver name when it is channel-ish (``ch``/``traj_chan``/
    ``params_channel``), else None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    base = call.func.value
    name = (base.id if isinstance(base, ast.Name)
            else base.attr if isinstance(base, ast.Attribute) else None)
    if name is None:
        return None
    low = name.lower()
    if low in _TD010_CHANNEL_EXACT or low.endswith(_TD010_CHANNEL_SUFFIXES):
        return name
    return None


def _role_literals(tree: ast.AST):
    """``(names, complete)``: role names collected from ``Role(...)``
    literals.  ``complete`` only when a ``RoleGraph(...)`` literal exists
    and every ``Role`` first argument is a string constant — otherwise
    the endpoint check stays off (we cannot prove a name is absent)."""
    names = set()
    any_graph = False
    complete = True
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        t = _terminal_name(node.func)
        if t == "RoleGraph":
            any_graph = True
        elif t == "Role":
            arg = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "name"),
                None)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
            else:
                complete = False
    return names, (any_graph and complete and bool(names))


def _endpoint_roles(call: ast.Call, layout):
    """``[(end, name_node)]`` for the literal role-name arguments of a
    Channel/ChannelSpec call, per that callable's ``layout`` (positional
    index, kwarg name)."""
    out = []
    for pos, end in layout:
        node = None
        if len(call.args) > pos:
            node = call.args[pos]
        else:
            node = next((kw.value for kw in call.keywords
                         if kw.arg == end), None)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.append((end, node))
    return out


def rule_td010(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    role_names, complete = _role_literals(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal_name(node.func)
        if name in _TD010_BLOCKING:
            recv = _channel_receiver(node)
            if recv is not None:
                has = any(kw.arg in _TIMEOUT_KWARGS
                          for kw in node.keywords) \
                    or len(node.args) > _TD010_BLOCKING[name]
                if not has:
                    out.append(Finding(
                        "TD010", "warning", path, node.lineno,
                        node.col_offset,
                        f"channel {recv}.{name}(...) without a "
                        f"timeout/deadline argument: the internal "
                        f"TPU_DIST_CH_TIMEOUT default applies, but a "
                        f"role-graph producer/consumer loop should state "
                        f"its budget explicitly (TD004 family) — a dead "
                        f"peer role otherwise waits out the full default "
                        f"before ChannelTimeoutError/"
                        f"ChannelPeerGoneError names it"))
        if name in _TD010_ENDPOINT_CALLS and complete:
            for end, lit in _endpoint_roles(node,
                                            _TD010_ENDPOINT_CALLS[name]):
                if lit.value not in role_names:
                    out.append(Finding(
                        "TD010", "error", path, lit.lineno,
                        lit.col_offset,
                        f"channel endpoint {end}={lit.value!r} names no "
                        f"role of this module's RoleGraph literal "
                        f"(roles: {sorted(role_names)}): the graph "
                        f"constructor raises RoleGraphError at runtime — "
                        f"a dangling endpoint can never carry a message"))
    out.sort(key=lambda f: (f.line, f.col))
    return out


# -- TD011: hand-rolled parameter-layout PartitionSpecs -----------------------

# mesh axes the unified rule plane (tpu_dist_torch/parallel/rules.py) owns:
# parameter placements over these derive from the logical-axis rule +
# layout tables.  'data'/'pipe'/shard_map batch specs are NOT layout
# arithmetic and stay free-form.
_TD011_LAYOUT_AXES = frozenset({"model", "shard", "expert"})

# the rule plane itself plus the spec builders that DEFINE the generated
# tables — the only modules allowed to spell layout axes into
# PartitionSpec literals by hand
_TD011_ALLOWED_SUFFIXES = (
    "parallel/rules.py", "parallel/gspmd.py", "parallel/fsdp.py",
)


def _spec_constructor_names(tree: ast.AST) -> frozenset:
    """Local names bound to ``jax.sharding.PartitionSpec`` by import —
    including the conventional ``as P`` alias."""
    names = {"PartitionSpec"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "PartitionSpec":
                    names.add(alias.asname or alias.name)
    return frozenset(names)


def _layout_axis_literal(call: ast.Call) -> Optional[str]:
    """The first string-literal argument naming a rule-plane layout axis,
    looking through tuple entries (``P(("data", "model"))``)."""
    def scan(node):
        if isinstance(node, ast.Constant) and node.value in \
                _TD011_LAYOUT_AXES:
            return node.value
        if isinstance(node, ast.Tuple):
            for elt in node.elts:
                hit = scan(elt)
                if hit is not None:
                    return hit
        return None

    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        hit = scan(arg)
        if hit is not None:
            return hit
    return None


def rule_td011(tree: ast.AST, path: str) -> List[Finding]:
    norm = path.replace("\\", "/")
    if norm.endswith(_TD011_ALLOWED_SUFFIXES):
        return []
    spec_names = _spec_constructor_names(tree)
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _terminal_name(node.func) not in spec_names:
            continue
        axis = _layout_axis_literal(node)
        if axis is None:
            continue
        out.append(Finding(
            "TD011", "error", path, node.lineno, node.col_offset,
            f"hand-rolled PartitionSpec places rule-plane mesh axis "
            f"{axis!r} outside tpu_dist_torch/parallel/rules.py: derive the "
            f"placement from the logical-axis table instead "
            f"(rules.spec_for / partition_pairs for pjit specs, "
            f"rules.spans_for for host-path spans) — duplicated layout "
            f"literals are how the pjit, ZeRO, reshard and serving "
            f"layouts drift apart"))
    out.sort(key=lambda f: (f.line, f.col))
    return out


# -- registry -----------------------------------------------------------------

RULES = {
    "TD001": rule_td001_td002,   # emits TD001 and TD002
    "TD003": rule_td003,
    "TD004": rule_td004,
    "TD005": rule_td005,
    "TD006": rule_td006,
    "TD007": rule_td007,
    "TD008": rule_td008,
    "TD009": rule_td009,
    "TD010": rule_td010,
    "TD011": rule_td011,
}

RULE_DOCS = {
    "TD001": "collective call inside a rank-conditional branch",
    "TD002": "divergent collective sequences across rank-conditional "
             "branches",
    "TD003": "raw control-plane store key not namespaced by generation",
    "TD004": "blocking store/socket/queue wait without a deadline",
    "TD005": "host side effects (store/collectives/time/random) inside "
             "trace-once code: jit-traced functions, torch.cuda.graph "
             "captures, make_graphed_callables and torch.jit functions",
    "TD006": "inconsistent lock-acquisition order within a module",
    "TD007": "async collective Work handle dropped without wait()/"
             "wait_all()",
    "TD008": "sub-group built from a rank-divergent member list, or a "
             "collective issued on a group the caller may not be a "
             "member of",
    "TD009": "broad/bare except swallowing a named tpu_dist error class "
             "(PeerGoneError, RankLostError, CollectiveMismatchError, "
             "FrameCorruptError) without re-raising or logging",
    "TD010": "role-graph channel hazards: deadline-less channel "
             "put/get/get_latest (warning, TD004 family), or a "
             "Channel/ChannelSpec endpoint naming a role absent from "
             "the module's RoleGraph literal (error)",
    "TD011": "hand-rolled PartitionSpec over a rule-plane layout axis "
             "('model'/'shard'/'expert') outside parallel/rules.py and "
             "its spec builders (gspmd.py, fsdp.py) — parameter "
             "placements must derive from the logical-axis rule table",
}


def run_rules(tree: ast.AST, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for fn in RULES.values():
        findings.extend(fn(tree, path))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
