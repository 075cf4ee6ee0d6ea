"""Host-path tensor parallelism driven by the unified rule table —
counterpart of ``tpu_dist/parallel/tensor.py``.

The mesh path does Megatron-style tp in the layers
(``TransformerLM(model_axis=)`` under ``make_gspmd_train_step``).  This
module is its eager host twin: the same ``parallel/rules.py`` table decides
which logical axes shard; each rank runs column-parallel (fused qkv,
mlp-up, lm-head) and row-parallel (attn-out, mlp-down) segments as torch
functions on its device, and the partial sums combine on the host over
``new_group`` sub-groups of the data plane (``collectives/transport.py``).

Layout contract (what makes the twin deterministic):

- every tp rank holds the shard :func:`rules.spans_for` assigns it, in the
  JAX layouts (``partial="replicate"``: row-parallel output biases
  replicate);
- row-parallel segments emit bias-free partials; the bias is added after
  the combine;
- partial sums fold in rank order on every rank (``acc = s0; acc += s1;
  ...`` in numpy), so all ranks hold identical bytes, and the socket-backed
  :class:`TPTrainer` equals the threaded :class:`SerialTPRunner` bit for
  bit;
- backward recomputes each segment's forward and takes ``torch.autograd``
  of it (the JAX engine's ``jax.vjp``); activation cotangents combine at
  once, the small norm-parameter partials once a backward.

Attention in the segments is the port's dispatch (K2f/K2b on the card at
1024 positions and more), where the JAX segments force dense attention:
a per-rank torch program can run the kernel (the GSPMD step's reason).  tp=2
is not bitwise tp=1 here, nor in the JAX package on a CPU (its own tp=2
step differs from tp=1 in the last bits from the second step on): the
tests hold the two within float32 tolerance.

Composes as ``dp`` × ``tp`` in :class:`TPTrainer` (tp gangs and dp gangs
are ``new_group`` sub-groups of one flat world; gradients ride the
bucketer over the dp gang).  ``tp`` inside a pipeline stage
(:func:`build_tp_stage_fns`: a stage's span of the engine as
:class:`~tpu_dist_torch.pipeline.stage.StageFns`) makes dp × tp × pp on the
host route.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .rules import (DEFAULT_RULES, ShardLayoutError, model_axes, shard_leaf,
                    spans_for)

__all__ = ["TPConfigError", "LocalCombiner", "PlaneCombiner",
           "tp_shard_params", "TPTrainer", "SerialTPRunner",
           "build_tp_stage_fns"]

# direct-exchange / ring crossover for tp partial-sum combines, as in the
# JAX package (serve/sharded.py's constant): small payloads take the
# exchange's single one-way latency
_EXCHANGE_MAX_BYTES = 128 << 10

#: logical axes the host engine knows how to split
_HOST_SHARDABLE = ("heads", "mlp", "vocab")


class TPConfigError(ValueError):
    """The model/table cannot run host tensor-parallel as asked (axis not
    divisible by tp, unsupported sharded axis, MoE/sequence-parallel
    model, world not divisible by tp) — named at construction."""


def _tp_span(op: str, value, group: str):
    from ..obs.hooks import collective_span
    return collective_span(op, value=value, reduce_op="sum", group=group)


def _note_algo(algo: str) -> None:
    from ..obs.hooks import note_algo
    note_algo(algo)


# ---------------------------------------------------------------------------
# combiners: rank-order partial-sum folds (the serving exchange discipline)
# ---------------------------------------------------------------------------

class _LocalPort:
    """One rank's handle on a :class:`LocalCombiner`."""

    def __init__(self, combiner: "LocalCombiner", rank: int):
        self._c = combiner
        self.rank = int(rank)
        self.world = combiner.world
        self.bytes_sent = 0

    def all_reduce(self, arr: np.ndarray) -> np.ndarray:
        self.bytes_sent += (self.world - 1) * arr.nbytes
        return self._c._combine(self.rank, arr, "sum")

    def all_gather_last(self, arr: np.ndarray) -> np.ndarray:
        self.bytes_sent += (self.world - 1) * arr.nbytes
        return self._c._combine(self.rank, arr, "gather")

    def tree_all_reduce(self, tree: Dict[str, Dict[str, np.ndarray]]):
        return {p: {k: self.all_reduce(v) for k, v in d.items()}
                for p, d in tree.items()}


class LocalCombiner:
    """In-process tp gang for the threaded oracle: shared slots and a
    barrier; rank 0 folds in rank order (``acc = s0.copy(); acc = acc +
    s1; ...``), every rank reads the same result bytes."""

    def __init__(self, world: int, timeout: float = 120.0):
        self.world = int(world)
        self.timeout = float(timeout)
        self._barrier = threading.Barrier(self.world)
        self._slots: List[Optional[np.ndarray]] = [None] * self.world
        self._out: Optional[np.ndarray] = None

    def bound(self, rank: int) -> _LocalPort:
        return _LocalPort(self, rank)

    def _combine(self, rank: int, arr, how: str) -> np.ndarray:
        arr = np.asarray(arr)
        if self.world == 1:
            return arr.copy()
        self._slots[rank] = arr
        self._barrier.wait(timeout=self.timeout)
        if rank == 0:
            if how == "sum":
                acc: Optional[np.ndarray] = None
                for s in self._slots:
                    acc = s.copy() if acc is None else acc + s
                self._out = acc
            else:
                self._out = np.concatenate(self._slots, axis=-1)
        self._barrier.wait(timeout=self.timeout)
        out = np.array(self._out)
        # a third wait: no rank deposits into the slots again before every
        # rank has copied this round's result out
        self._barrier.wait(timeout=self.timeout)
        return out


def _exchange_sum(dp, arr: np.ndarray, tag: str, timeout: float):
    """Direct-exchange SUM over a group data plane, folded in rank order on
    every rank (byte-identical everywhere)."""
    flat = np.ascontiguousarray(arr.reshape(-1))
    for dst in range(dp.num_processes):
        if dst != dp.rank:
            dp.send_array(dst, tag, flat)
    acc = None
    for src in range(dp.num_processes):
        part = flat if src == dp.rank else dp.recv_array(src, tag, timeout)
        acc = part.copy() if acc is None else acc + part
    return acc.reshape(arr.shape)


class PlaneCombiner:
    """Tp partial-sum combiner over a ``new_group`` sub-group of the data
    plane: small payloads (up to ``_EXCHANGE_MAX_BYTES``) take the
    direct exchange, larger ones the ring; each combine is an obs
    ``group=`` span stamped with its ``algo=``.  ``bytes_sent`` accumulates
    this rank's wire bytes."""

    def __init__(self, group, dp, timeout: float = 120.0):
        self.group = group
        self.world = group.num_processes
        self.rank = group.require_member("tp combine")
        self._view = group.view(dp) if self.world > 1 else None
        self.timeout = float(timeout)
        self.bytes_sent = 0
        self._seq = 0

    def _tag(self) -> str:
        self._seq += 1
        return f"tp{self._seq}"

    def all_reduce(self, arr: np.ndarray) -> np.ndarray:
        arr = np.ascontiguousarray(np.asarray(arr))
        if self.world == 1:
            return arr.copy()
        gid = f"tp:{self.group.group_id}"
        with _tp_span("tp_all_reduce", arr, gid):
            if arr.nbytes <= _EXCHANGE_MAX_BYTES:
                _note_algo("exchange")
                out = _exchange_sum(self._view, arr, self._tag(),
                                    self.timeout)
                self.bytes_sent += (self.world - 1) * arr.nbytes
            else:
                from ..collectives.ring import ring_all_reduce
                _note_algo("ring")
                out = ring_all_reduce(self._view, arr, op="sum",
                                      tag=self._tag())
                self.bytes_sent += (2 * arr.nbytes
                                    * (self.world - 1)) // self.world
        return out

    def all_gather_last(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's block concatenated along the last axis, in rank
        order (the column-parallel lm-head's logits)."""
        arr = np.ascontiguousarray(np.asarray(arr))
        if self.world == 1:
            return arr.copy()
        gid = f"tp:{self.group.group_id}"
        with _tp_span("tp_all_gather", arr, gid):
            _note_algo("exchange")
            tag = self._tag()
            flat = arr.reshape(-1)
            for dst in range(self.world):
                if dst != self.rank:
                    self._view.send_array(dst, tag, flat)
            parts = []
            for src in range(self.world):
                p = (flat if src == self.rank
                     else self._view.recv_array(src, tag, self.timeout))
                parts.append(p.reshape(arr.shape))
            self.bytes_sent += (self.world - 1) * arr.nbytes
        return np.concatenate(parts, axis=-1)

    def tree_all_reduce(self, tree: Dict[str, Dict[str, np.ndarray]]):
        return {p: {k: self.all_reduce(v) for k, v in d.items()}
                for p, d in tree.items()}


# ---------------------------------------------------------------------------
# parameter sharding (rule-table driven)
# ---------------------------------------------------------------------------

def tp_shard_params(model, params, rank: int, world: int, rules=None):
    """This tp rank's local parameter tree: every leaf of ``params`` (a JAX
    layout tree ``{path: {leaf: array}}``, :func:`~tpu_dist_torch.interop.
    jax_params`) sliced per :func:`rules.spans_for` under the table's
    ``model``-axis bindings (``partial="replicate"``), as numpy.  Keys are
    unchanged; merging all ranks' slices reassembles ``params``."""
    if rules is None:
        rules = DEFAULT_RULES
    axes = model_axes(model)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    try:
        for path, leaves in params.items():
            d = {}
            for name, arr in leaves.items():
                a = np.asarray(arr)
                plan = spans_for(path, name, a.shape, axes, rank, world,
                                 rules=rules, mesh_axis="model",
                                 partial="replicate")
                d[name] = shard_leaf(a, plan)
            out[path] = d
    except ShardLayoutError as e:
        raise TPConfigError(str(e)) from None
    return out


# ---------------------------------------------------------------------------
# per-rank segments (torch functions on the rank's device)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _SegCfg:
    norm: str          # "layernorm" | "rmsnorm"
    block_eps: float
    final_eps: float
    heads: int         # LOCAL head count
    head_dim: int
    rope: bool
    rope_theta: float
    causal: bool


def _norm_fwd(kind: str, eps: float, p, x):
    """The op sequence of the port's nn.LayerNorm / nn.RMSNorm forward."""
    if kind == "layernorm":
        return torch.nn.functional.layer_norm(x, (x.shape[-1],),
                                              p["weight"], p["bias"], eps)
    y = torch.nn.functional.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return y.to(x.dtype) * p["weight"].to(x.dtype)


class _Segments:
    """The segment set of one engine shape-config: each branch a torch
    function of (leaf dict, activation), each backward the recompute and
    ``torch.autograd.grad`` of it."""

    def __init__(self, cfg: _SegCfg):
        self.cfg = cfg

    def attn_fwd(self, p, x):
        from ..nn.attention import rotary_embed, scaled_dot_product_attention
        cfg = self.cfg
        h = _norm_fwd(cfg.norm, cfg.block_eps, p["ln"], x)
        qkv = h @ p["qkv_w"]
        if "qkv_b" in p:
            qkv = qkv + p["qkv_b"]
        b, t = x.shape[0], x.shape[1]
        q, k, v = qkv.reshape(b, t, 3, cfg.heads, cfg.head_dim).unbind(2)
        if cfg.rope:
            pos = torch.arange(t, device=x.device)
            q = rotary_embed(q, pos, cfg.rope_theta)
            k = rotary_embed(k, pos, cfg.rope_theta)
        out = scaled_dot_product_attention(q, k, v, causal=cfg.causal)
        return out.reshape(b, t, cfg.heads * cfg.head_dim) @ p["out_w"]

    def mlp_fwd(self, p, x):
        h = _norm_fwd(self.cfg.norm, self.cfg.block_eps, p["ln"], x)
        u = h @ p["w0"]
        if "b0" in p:
            u = u + p["b0"]
        return torch.nn.functional.gelu(u) @ p["w2"]

    def head_fwd(self, p, x):
        z = _norm_fwd(self.cfg.norm, self.cfg.final_eps, p["ln"], x) @ p["w"]
        return z + p["b"] if "b" in p else z

    @staticmethod
    def tok_full(w, idx):
        return torch.nn.functional.embedding(idx, w)

    @staticmethod
    def tok_shard(w, idx, lo: int):
        rows = w.shape[0]
        rel = idx - lo
        ok = (rel >= 0) & (rel < rows)
        e = torch.nn.functional.embedding(rel.clamp(0, rows - 1), w)
        return torch.where(ok[..., None], e, e.new_zeros(()))

    @staticmethod
    def pos_rows(w, idx):
        return w[:idx.shape[1]]

    @staticmethod
    def vjp(fn, p, x, g):
        """``(dp, dx)`` of ``fn(p, x)`` against cotangent ``g``; ``x`` None
        (an integer input) gives ``dp`` alone."""
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in
                      _flat(p).items()}
            xs = [] if x is None else [x.detach().requires_grad_(True)]
            y = fn(_nest(leaves, p), *xs)
            grads = torch.autograd.grad(y, list(leaves.values()) + xs, g)
        dp = _nest(dict(zip(leaves, grads[:len(leaves)])), p)
        return (dp, grads[-1]) if xs else dp


def _flat(p, prefix=""):
    """``{dotted key: tensor}`` of a nested dict of tensors."""
    if isinstance(p, torch.Tensor):
        return {prefix: p}
    out = {}
    for k, v in p.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def _nest(flat, like, prefix=""):
    """``flat`` back in the structure of ``like``."""
    if isinstance(like, torch.Tensor):
        return flat[prefix]
    return {k: _nest(flat, v, f"{prefix}.{k}" if prefix else k)
            for k, v in like.items()}


def _lossgrad(loss_fn, logits, y):
    """``(loss, dlogits)`` of ``loss_fn(logits.reshape(-1, V),
    y.reshape(-1))``: the JAX engine's flattening."""
    with torch.enable_grad():
        lg = logits.detach().requires_grad_(True)
        v = lg.shape[-1]
        loss = loss_fn(lg.reshape(-1, v), y.reshape(-1))
        (g,) = torch.autograd.grad(loss, [lg])
    return float(loss.detach()), g


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the per-rank engine
# ---------------------------------------------------------------------------

class _TPEngine:
    """One tp rank's eager engine over a :class:`~tpu_dist_torch.models.
    TransformerLM`'s blocks ``[lo, hi)``, with the embedding front and the
    lm-head tail (the full model at ``lo=0, hi=depth``).

    Forward: segments on the device, partial sums through the port (host
    numpy) at once.  Backward: recompute and per-segment autograd;
    activation cotangents combine at once, the small norm-parameter
    partials are pooled and combined once a backward.  Every port call
    happens in the same program order on every rank of the gang."""

    def __init__(self, model, rules, port, *, lo: int = 0,
                 hi: Optional[int] = None, embed: bool = True,
                 head: bool = True, loss_fn=None):
        from ..nn import MoELayer, RMSNorm
        if any(isinstance(m, MoELayer) for m in model.modules()):
            raise TPConfigError("host tp engine supports dense "
                                "TransformerLM models only (MoE expert "
                                "banks ride gspmd.MOE_EP_RULES)")
        if getattr(model, "sequence_axis", None) is not None:
            raise TPConfigError("host tp composes with host pipeline/dp, "
                                "not mesh sequence parallelism — build "
                                "the model without sequence_axis")
        rules = DEFAULT_RULES if rules is None else rules
        tp = port.world
        for ax, m in rules.items():
            if m == "model" and ax not in _HOST_SHARDABLE:
                raise TPConfigError(
                    f"host tp engine cannot shard logical axis {ax!r}; "
                    f"supported: {_HOST_SHARDABLE}")
        self.axes = model_axes(model)
        self.port = port
        self.tp = tp
        self.heads_sharded = tp > 1 and rules.get("heads") == "model"
        self.mlp_sharded = tp > 1 and rules.get("mlp") == "model"
        self.vocab_sharded = tp > 1 and rules.get("vocab") == "model"
        for flag, ax in ((self.heads_sharded, "heads"),
                         (self.mlp_sharded, "mlp"),
                         (self.vocab_sharded, "vocab")):
            if flag and self.axes[ax] % tp:
                raise TPConfigError(
                    f"logical axis {ax!r} of size {self.axes[ax]} not "
                    f"divisible by tp={tp}")
        self.lo = lo
        self.hi = model.depth if hi is None else hi
        self.embed = embed
        self.head = head
        self.has_pos = model.pos is not None
        self.device = next(model.parameters()).device
        attn = model.block0.attn
        heads_local = (self.axes["heads"] // tp if self.heads_sharded
                       else self.axes["heads"])
        self.seg = _Segments(_SegCfg(
            norm="rmsnorm" if isinstance(model.ln_f, RMSNorm)
            else "layernorm",
            block_eps=float(model.block0.ln1.eps),
            final_eps=float(model.ln_f.eps),
            heads=heads_local, head_dim=int(attn.head_dim),
            rope=bool(attn.rope), rope_theta=float(attn.rope_theta),
            causal=bool(attn.causal)))
        self.loss_fn = loss_fn
        self._vloc = (self.axes["vocab"] // tp if self.vocab_sharded
                      else self.axes["vocab"])

    def _t(self, a) -> torch.Tensor:
        """``a`` (a host array or a tensor on any device) on the engine's
        device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- segment param views (local leaves, original key layout) ----------

    def _attn_p(self, params, i):
        p = params[f"block{i}.attn"]
        d = {"ln": params[f"block{i}.ln1"], "qkv_w": p["qkv_weight"],
             "out_w": p["out_weight"]}
        if "qkv_bias" in p:
            d["qkv_b"] = p["qkv_bias"]
        return d

    def _mlp_p(self, params, i):
        up, down = params[f"block{i}.mlp.0"], params[f"block{i}.mlp.2"]
        d = {"ln": params[f"block{i}.ln2"], "w0": up["weight"],
             "w2": down["weight"]}
        if "bias" in up:
            d["b0"] = up["bias"]
        return d

    def _head_p(self, params):
        p = params["head"]
        d = {"ln": params["ln_f"], "w": p["weight"]}
        if "bias" in p:
            d["b"] = p["bias"]
        return d

    # -- forward ----------------------------------------------------------

    def _combine(self, part: torch.Tensor, sharded: bool) -> torch.Tensor:
        return self._t(self.port.all_reduce(_np(part))) if sharded else part

    @torch.no_grad()
    def _run(self, params, x):
        """(output, stash): output is logits (a head span) or the span's
        activation; stash holds each branch's input for the backward."""
        st: Dict[str, object] = {"a_in": {}, "m_in": {}}
        if self.embed:
            idx = self._t(x).long()
            st["idx"] = idx
            wtok = params["tok"]["weight"]
            if self.vocab_sharded:
                lo_row = self.port.rank * self._vloc
                h = self._combine(self.seg.tok_shard(wtok, idx, lo_row),
                                  True)
            else:
                h = self.seg.tok_full(wtok, idx)
            if self.has_pos:
                h = h + self.seg.pos_rows(params["pos"]["weight"], idx)
        else:
            h = torch.as_tensor(x, device=self.device)
        for i in range(self.lo, self.hi):
            st["a_in"][i] = h
            comb = self._combine(self.seg.attn_fwd(self._attn_p(params, i),
                                                   h), self.heads_sharded)
            ob = params[f"block{i}.attn"].get("out_bias")
            if ob is not None:
                comb = comb + ob
            h = st["a_in"][i] + comb
            st["m_in"][i] = h
            comb = self._combine(self.seg.mlp_fwd(self._mlp_p(params, i), h),
                                 self.mlp_sharded)
            b2 = params[f"block{i}.mlp.2"].get("bias")
            if b2 is not None:
                comb = comb + b2
            h = st["m_in"][i] + comb
        if self.head:
            st["h_in"] = h
            z = self.seg.head_fwd(self._head_p(params), h)
            if self.vocab_sharded:
                z = self._t(self.port.all_gather_last(_np(z)))
            return z, st
        return h, st

    def forward(self, params, x):
        return self._run(params, x)[0]

    def loss(self, params, x, y):
        logits, _ = self._run(params, x)
        return _lossgrad(self.loss_fn, logits,
                         self._t(y).long())[0]

    # -- backward (recompute + per-segment autograd) ----------------------

    def backward(self, params, x, gy, *, from_loss: bool):
        """(loss_or_None, grads, dx_or_None).  ``gy`` is the target batch
        under ``from_loss``, the output cotangent otherwise.  ``dx`` is None
        on embedding spans (nothing upstream)."""
        out, st = self._run(params, x)
        loss = None
        if from_loss:
            loss, g = _lossgrad(self.loss_fn, out,
                                self._t(gy).long())
        else:
            g = torch.as_tensor(gy, device=self.device)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        pool: Dict[str, Dict[str, np.ndarray]] = {}

        def norm_grad(path, d_ln, partial):
            if partial:
                pool[path] = {k: _np(v) for k, v in d_ln.items()}
            else:
                grads[path] = dict(d_ln)

        def combined(dx, sharded):
            return self._combine(dx, sharded)

        seg = self.seg
        if self.head:
            if self.vocab_sharded:
                lo_col = self.port.rank * self._vloc
                gloc = g[..., lo_col:lo_col + self._vloc].contiguous()
            else:
                gloc = g
            dp, dxp = seg.vjp(seg.head_fwd, self._head_p(params),
                              st["h_in"], gloc)
            grads["head"] = {"weight": dp["w"]}
            if "b" in dp:
                grads["head"]["bias"] = dp["b"]
            norm_grad("ln_f", dp["ln"], self.vocab_sharded)
            g = combined(dxp, self.vocab_sharded)
        for i in reversed(range(self.lo, self.hi)):
            down_path = f"block{i}.mlp.2"
            b2 = params[down_path].get("bias")
            dp, dxp = seg.vjp(seg.mlp_fwd, self._mlp_p(params, i),
                              st["m_in"][i], g)
            grads[f"block{i}.mlp.0"] = {"weight": dp["w0"]}
            if "b0" in dp:
                grads[f"block{i}.mlp.0"]["bias"] = dp["b0"]
            grads[down_path] = {"weight": dp["w2"]}
            if b2 is not None:
                # a row-parallel bias added after the combine on a
                # replicated cotangent: exact on every rank, no combine
                grads[down_path]["bias"] = g.sum(dim=(0, 1))
            norm_grad(f"block{i}.ln2", dp["ln"], self.mlp_sharded)
            g = g + combined(dxp, self.mlp_sharded)
            attn_path = f"block{i}.attn"
            ob = params[attn_path].get("out_bias")
            dp, dxp = seg.vjp(seg.attn_fwd, self._attn_p(params, i),
                              st["a_in"][i], g)
            grads[attn_path] = {"qkv_weight": dp["qkv_w"],
                                "out_weight": dp["out_w"]}
            if "qkv_b" in dp:
                grads[attn_path]["qkv_bias"] = dp["qkv_b"]
            if ob is not None:
                grads[attn_path]["out_bias"] = g.sum(dim=(0, 1))
            norm_grad(f"block{i}.ln1", dp["ln"], self.heads_sharded)
            g = g + combined(dxp, self.heads_sharded)
        dx = g
        if self.embed:
            idx, wtok = st["idx"], params["tok"]["weight"]
            if self.vocab_sharded:
                lo_row = self.port.rank * self._vloc
                grads["tok"] = {"weight": seg.vjp(
                    lambda p: seg.tok_shard(p["w"], idx, lo_row),
                    {"w": wtok}, None, g)["w"]}
            else:
                grads["tok"] = {"weight": seg.vjp(
                    lambda p: seg.tok_full(p["w"], idx), {"w": wtok}, None,
                    g)["w"]}
            if self.has_pos:
                grads["pos"] = {"weight": seg.vjp(
                    lambda p: seg.pos_rows(p["w"], idx),
                    {"w": params["pos"]["weight"]}, None,
                    g.sum(dim=0))["w"]}
            dx = None
        if pool:
            # one deferred combine for all partial norm grads: they gate no
            # other backward work
            for path, d in self.port.tree_all_reduce(pool).items():
                grads[path] = {k: self._t(v) for k, v in d.items()}
        return loss, grads, dx


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def _flat_keys(tree) -> Dict[str, torch.Tensor]:
    """``{"path.leaf": tensor}`` of a ``{path: {leaf: tensor}}`` tree (the
    optimizer's view; the tensors are the tree's own)."""
    return {f"{p}.{k}": v for p, d in tree.items() for k, v in d.items()}


@torch.no_grad()
def _scale(grads: Dict[str, torch.Tensor], factor: float):
    return {k: v * v.new_tensor(factor) for k, v in grads.items()}


@torch.no_grad()
def _sum_lanes(lanes: List[Dict[str, torch.Tensor]]):
    """Rank-order fold across dp lanes (lane 0 + lane 1 + ...)."""
    acc = {k: v.clone() for k, v in lanes[0].items()}
    for lane in lanes[1:]:
        for k in acc:
            acc[k] = acc[k] + lane[k]
    return acc


def _full_params(model, seed: Optional[int]):
    """The model's parameters as a JAX layout tree (numpy), after
    re-initializing them from ``seed`` (None: as they are)."""
    from ..interop import jax_params
    from ..nn.module import reset_parameters
    if seed is not None:
        dev = next(model.parameters()).device
        reset_parameters(model, torch.Generator(device=dev).manual_seed(
            int(seed)))
    return jax_params(model)


def _to_device(tree, device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {p: {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for k, a in d.items()} for p, d in tree.items()}


class TPTrainer:
    """dp×tp host-path training over one flat world: ranks ``[d*tp + t]``,
    tp gangs contiguous.  Every rank builds all tp groups then all dp
    groups in the same program order (the ``new_group`` contract), keeps
    the rule-table shard of the model's parameters (JAX layouts, on the
    model's device), and steps with rule-driven partial-sum combines over
    its tp gang plus bucketed gradient sums over its dp gang (summed, then
    scaled by 1/dp — at dp=2 bitwise the serial oracle's rank-order fold).

    ``dp``: this rank's :class:`~tpu_dist_torch.collectives.transport.
    DataPlane` over the world.  ``seed``: the parameters are re-initialized
    from ``torch.Generator().manual_seed(seed)`` (``DistributedDataParallel.
    init``'s draws); None takes the model's as they are (the tests load the
    JAX package's).  ``step(x, y)``: every tp rank of a lane feeds the same
    microbatch (the lane's dp shard); returns the lane's loss.  Changing
    only ``rules`` re-partitions the run — an all-None table falls back to
    pure dp with replicated params.  In-process rigs (threads) pass
    pre-built ``SubGroup(members, rank, world, instance=0)`` objects as
    ``tp_group`` and ``dp_group``."""

    def __init__(self, model, optimizer, loss_fn, *, dp, tp: int = 1,
                 rules=None, grad_sync: str = "bucket",
                 bucket_bytes: Optional[int] = None, seed: Optional[int] = 0,
                 timeout: float = 120.0, tp_group=None, dp_group=None):
        from ..collectives.topology import new_group
        if grad_sync not in ("bucket", "none"):
            raise TPConfigError(f"unknown grad_sync {grad_sync!r}")
        world, rank = dp.num_processes, dp.rank
        if tp < 1 or world % tp:
            raise TPConfigError(
                f"world {world} not divisible by tp={tp}")
        self.rules = DEFAULT_RULES if rules is None else rules
        self.optimizer = optimizer
        self.dp_size = world // tp
        self.tp = tp
        self.dp_idx, self.tp_idx = divmod(rank, tp)
        self.timeout = float(timeout)
        if tp_group is None or dp_group is None:
            class _Parent:
                pass

            parent = _Parent()
            parent.rank, parent.num_processes = rank, world
            tp_groups = [new_group([d * tp + t for t in range(tp)],
                                   group=parent)
                         for d in range(self.dp_size)]
            dp_groups = [new_group([d * tp + t
                                    for d in range(self.dp_size)],
                                   group=parent)
                         for t in range(tp)]
            tp_group = tp_groups[self.dp_idx]
            dp_group = dp_groups[self.tp_idx]
        self.tp_group = tp_group
        self.dp_group = dp_group
        self.port = PlaneCombiner(self.tp_group, dp, timeout=timeout)
        self.engine = _TPEngine(model, self.rules, self.port,
                                loss_fn=loss_fn)
        full = _full_params(model, seed)
        self.params = _to_device(
            tp_shard_params(model, full, self.tp_idx, tp, self.rules),
            self.engine.device)
        self.opt_state = optimizer.init(_flat_keys(self.params))
        self._bucketer = None
        if self.dp_size > 1 and grad_sync == "bucket":
            from ..collectives.bucketer import Bucketer
            self._bucketer = Bucketer(bucket_bytes,
                                      dp=self.dp_group.view(dp))

    @property
    def tp_bytes_sent(self) -> int:
        return self.port.bytes_sent

    def step(self, x, y) -> float:
        loss, grads, _ = self.engine.backward(self.params, x, y,
                                              from_loss=True)
        grads = _flat_keys(grads)
        if self._bucketer is not None:
            work = self._bucketer.all_reduce(grads, op="sum")
            grads = _scale(work.wait_all(self.timeout), 1.0 / self.dp_size)
        self.optimizer.update(grads, self.opt_state,
                              _flat_keys(self.params))
        return loss


class SerialTPRunner:
    """In-process dp×tp oracle: a (dp, tp) engine grid on threads over
    :class:`LocalCombiner` gangs — no sockets, rank-order folds everywhere,
    so its step outputs are the reference bytes the plane-backed
    :class:`TPTrainer` must reproduce.  Params and optimizer state are kept
    once a tp rank (dp lanes are exact replicas).  ``step`` splits the
    global batch over dp lanes and returns the per-lane losses.  ``seed``
    as :class:`TPTrainer`'s."""

    def __init__(self, model, optimizer, loss_fn, *, tp: int = 1,
                 dp: int = 1, rules=None, seed: Optional[int] = 0):
        self.rules = DEFAULT_RULES if rules is None else rules
        self.optimizer = optimizer
        self.tp, self.dp = int(tp), int(dp)
        self._combiners = [LocalCombiner(tp) for _ in range(dp)]
        self._engines = [[_TPEngine(model, self.rules,
                                    self._combiners[d].bound(t),
                                    loss_fn=loss_fn)
                          for t in range(tp)] for d in range(dp)]
        full = _full_params(model, seed)
        device = self._engines[0][0].device
        self.params = [_to_device(tp_shard_params(model, full, t, tp,
                                                  self.rules), device)
                       for t in range(tp)]
        self.opt_state = [optimizer.init(_flat_keys(p)) for p in self.params]

    def step(self, x, y) -> List[float]:
        x, y = np.asarray(x), np.asarray(y)
        if x.shape[0] % self.dp:
            raise TPConfigError(
                f"batch {x.shape[0]} not divisible by dp={self.dp}")
        xs = np.split(x, self.dp)
        ys = np.split(y, self.dp)
        results: Dict[Tuple[int, int], Tuple] = {}
        errors: List[BaseException] = []

        def run(d, t):
            try:
                results[(d, t)] = self._engines[d][t].backward(
                    self.params[t], xs[d], ys[d], from_loss=True)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(d, t), daemon=True)
                   for d in range(self.dp) for t in range(self.tp)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        losses = [results[(d, 0)][0] for d in range(self.dp)]
        for t in range(self.tp):
            lanes = [_flat_keys(results[(d, t)][1]) for d in range(self.dp)]
            grads = lanes[0] if self.dp == 1 else _scale(
                _sum_lanes(lanes), 1.0 / self.dp)
            self.optimizer.update(grads, self.opt_state[t],
                                  _flat_keys(self.params[t]))
        return losses


def build_tp_stage_fns(part, stage: int, loss_fn, port, rules=None):
    """Tensor-parallel :class:`~tpu_dist_torch.pipeline.stage.StageFns`
    over ``part.spans[stage]`` of a
    :class:`~tpu_dist_torch.pipeline.partition.TransformerPartition` —
    drop-in for ``pipeline.PipelineStage(fns=...)``, so a (pp stage × tp
    rank) grid runs dp × tp × pp training on the host path.

    Every tp peer of a stage runs the same pipeline schedule, hence issues
    the same combiner sequence per F/B op — the recompute inside ``bwd``
    re-fires its forward combines in lockstep too.  Params are this tp
    rank's shard (:func:`tp_shard_params`, JAX layouts, as tensors on the
    model's device) of ``part.stage_params(...)`` of the JAX tree."""
    from ..pipeline.stage import StageFns
    lo, hi = part.spans[stage]
    first, last = part.is_first(stage), part.is_last(stage)
    engine = _TPEngine(part.model, rules, port, lo=lo, hi=hi, embed=first,
                       head=last, loss_fn=loss_fn)
    return StageFns(
        fwd=None if last else (lambda p, x: engine.forward(p, x)),
        fwd_loss=(lambda p, x, y: engine.loss(p, x, y)) if last else None,
        bwd=None if last else (
            lambda p, x, g: engine.backward(p, x, g, from_loss=False)[1:]),
        bwd_loss=(lambda p, x, y:
                  engine.backward(p, x, y, from_loss=True)[1:])
        if last else None)
