"""Tensor-parallel sharded decode — counterpart of
``tpu_dist/serve/sharded.py``: serve a model too large for one card.

A ``model-shard`` group of W ranks holds ONE copy of the model between them
— **head-sharded attention** (each shard owns ``num_heads / W`` heads; its
KV-cache pool holds only those heads' rows) and **column/row-split MLP
weights** (the up-projection column-split, the down-projection row-split)
— and decodes cooperatively:

- every shard runs the SAME slot bookkeeping (admission order, slot choice,
  EOS/length frees) and the same per-slot decode and prefill math over its
  weight shard;
- per transformer block, the two partial activations (attention output
  rows, MLP down-projection rows) are summed across the group over the host
  data plane (:class:`~tpu_dist_torch.collectives.transport.DataPlane`): a
  direct exchange below :data:`_EXCHANGE_MAX_BYTES`, the ring all-reduce
  above it or with ``comm_dtype`` (``"int8_block256"`` wire compression is
  an opt-in).  Each sum is folded in rank order on every rank, so every
  rank gets the same bytes;
- embeddings, norms, the LM head and sampling are replicated, so every
  shard computes identical logits and samples the identical next token.
  Followers stay in lockstep with no per-token broadcast; only the leader's
  decisions (admissions, cancel/deadline sweeps, shutdown) travel, as small
  JSON plan frames on the tag ``sctl``.

Shard rank 0 is the **leader**: it runs the ordinary
:class:`~tpu_dist_torch.serve.Scheduler` and
:class:`~tpu_dist_torch.serve.Frontend` over a :class:`ShardedSlotEngine`,
which broadcasts each engine operation as a plan before executing it.
Ranks 1..W-1 run a :class:`ShardFollower` loop: receive plan → mirror the
operation → join the combines.

Each rank's forward runs on the device of the model it was built from
(``cuda`` unless the caller built that on the CPU); each combine copies
the partial to the host (a sync), sums there and copies the sum back — the
JAX package's route, two combines a block.  The sampling is the
single-rank engine's (:func:`sample_host`).

Failure story: a SIGKILLed shard surfaces as a named ``PeerGoneError`` in
whichever peer touches the wire next — the leader's scheduler records it
as the fatal cause and fails every in-flight request by name; followers get
it from their blocked plan receive.  An idle leader pings its followers
every ``TPU_DIST_SERVE_PROBE`` seconds (2 by default, 0 disables), so a
dead follower is named before the next request needs it.

Parameters cross over in the JAX layout: :func:`shard_params` slices a full
tree (``interop.jax_params`` of a port model, or a JAX package's tree) with
the span math of :mod:`tpu_dist_torch.parallel.rules`, and
:class:`ShardedLM` takes the shard through
:func:`~tpu_dist_torch.interop.load_jax_params`.
:meth:`ShardedParams.from_checkpoint` range-reads a FULL checkpoint's
``arrays.npz`` into one shard's layout through the reshard engine's
``_ShardReader`` without materializing the full tree.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import nn, random
from ..interop import load_jax_params
from ..models.transformer import TransformerLM, write_slot_rows
from .engine import Request, ServeError, SlotEngine, sample_host

__all__ = ["ShardedLM", "ShardedDecoder", "ShardedSlotEngine",
           "ShardFollower", "ShardedParams", "ShardConfigError",
           "ShardPlanError", "shard_params"]

_CTL_TAG = "sctl"        # leader -> follower control-plan frames
_PLAN_TIMEOUT = 300.0    # follower's per-plan recv budget (seconds)

# below this, the partial-sum combine takes a latency-optimal direct
# exchange (every rank sends its FULL partial to every peer, folds in rank
# order) instead of the bandwidth-optimal ring: decode partials are a few
# KB, where the ring's sequential hops are pure latency
_EXCHANGE_MAX_BYTES = 128 << 10


def _probe_interval() -> float:
    """Idle-leader liveness cadence (seconds): with no plan sent for this
    long the leader broadcasts a ``ping`` plan, so a dead follower is named
    by ``PeerGoneError`` now instead of by the first request that has to
    fail to discover it.  ``TPU_DIST_SERVE_PROBE`` tunes it; ``0``
    disables the probe."""
    return float(os.environ.get("TPU_DIST_SERVE_PROBE", "") or 2.0)


def _tp_span(op: str, value, group: str):
    """Obs span for one tensor-parallel combine, stamped with ``group=``
    (the shard gang, not the world's lockstep sequence); the body stamps
    ``algo=`` (exchange or ring)."""
    from ..obs.hooks import collective_span
    return collective_span(op, value=value, reduce_op="sum", group=group)


def _note_algo(algo: str) -> None:
    from ..obs.hooks import note_algo
    note_algo(algo)


def _exchange_all_reduce(dp, arr: np.ndarray, tag: str, timeout: float):
    """Direct-exchange SUM: one one-way latency instead of the ring's
    2(N-1) sequential hops.  Folded in RANK order on every rank, so the
    result is byte-identical everywhere (the lockstep requirement)."""
    flat = np.ascontiguousarray(arr.reshape(-1))
    for dst in range(dp.num_processes):
        if dst != dp.rank:
            dp.send_array(dst, tag, flat)
    acc = None
    for src in range(dp.num_processes):
        part = flat if src == dp.rank else dp.recv_array(src, tag, timeout)
        acc = part.copy() if acc is None else acc + part
    return acc.reshape(arr.shape)


class ShardConfigError(ServeError):
    """The model cannot be sharded this way (heads or MLP hidden width not
    divisible by the shard world, MoE blocks, non-causal model) — named at
    construction, before any rank allocates a cache."""


class ShardPlanError(ServeError):
    """A follower received a control plan it cannot apply (unknown op, slot
    state drift) — the shard group is no longer in lockstep and the only
    safe move is to fail the gang round loudly."""


# ---------------------------------------------------------------------------
# parameter sharding: span math shared by in-memory slicing and range-reads
# ---------------------------------------------------------------------------

def _leaf_plan(path: str, name: str, shape, dims: dict, rank: int,
               world: int):
    """``(flat element spans, out_shape)`` of shard ``rank``'s slice of a
    JAX-layout leaf, or None when this shard drops it (the partial-sum bias
    convention: shard 0 alone carries each row-split projection's bias, so
    the combined sum adds it once)."""
    from ..parallel import rules as _rules
    axes = {"qkv3": 3, "heads": dims["num_heads"],
            "head_dim": dims["head_dim"], "mlp": dims["hidden"],
            "embed": dims["dim"], "vocab": dims["vocab"]}
    try:
        return _rules.spans_for(path, name, tuple(shape), axes, rank, world,
                                rules=_rules.SERVING_RULES,
                                mesh_axis="shard", partial="first")
    except _rules.ShardLayoutError as e:
        raise ShardConfigError(str(e)) from e


def _model_dims(model) -> dict:
    """Shardable hyperparameters read off a built ``TransformerLM``,
    raising :class:`ShardConfigError` for shapes this layout cannot
    split."""
    if getattr(model, "shard_dims", None) is not None:
        return dict(model.shard_dims)
    blk = model.block0
    if isinstance(blk.mlp, nn.MoELayer):
        raise ShardConfigError(
            "sharded serving covers dense MLP blocks; MoE blocks are "
            "already expert-parallel (nn/moe.py) — build the model with "
            "num_experts=0")
    if not getattr(model, "causal", True):
        raise ShardConfigError("sharded decode requires a causal model")
    if getattr(model, "sequence_axis", None) is not None:
        raise ShardConfigError(
            "build the model without sequence_axis for serving (KV-cache "
            "decode runs on gathered sequences)")
    attn = blk.attn
    return {"dim": attn.embed_dim, "num_heads": attn.num_heads,
            "head_dim": attn.head_dim, "depth": model.depth,
            "hidden": blk.mlp[0].out_features, "vocab": model.vocab_size,
            "max_seq_len": model.max_seq_len, "rope": attn.rope,
            "rope_theta": attn.rope_theta,
            "qkv_bias": attn.qkv_bias is not None,
            "rmsnorm": isinstance(model.ln_f, nn.RMSNorm)}


def _check_world(dims: dict, world: int) -> None:
    if world < 1:
        raise ShardConfigError(f"shard world must be >= 1, got {world}")
    if dims["num_heads"] % world:
        raise ShardConfigError(
            f"num_heads {dims['num_heads']} not divisible by shard world "
            f"{world} — the KV cache shards by head")
    if dims["hidden"] % world:
        raise ShardConfigError(
            f"MLP hidden width {dims['hidden']} not divisible by shard "
            f"world {world}")


def shard_params(model, params, shard_rank: int, shard_world: int) -> dict:
    """Slice a FULL parameter tree (JAX layout, ``{path: {name: array}}``:
    ``interop.jax_params(model)`` or a JAX package's tree) into shard
    ``shard_rank``'s layout — the tree a :class:`ShardedLM` of the same
    coordinates loads.  Pure span math over each leaf's flat layout,
    identical to what :meth:`ShardedParams.from_checkpoint` range-reads."""
    dims = _model_dims(model)
    _check_world(dims, shard_world)
    out: Dict[str, dict] = {}
    for path, leaf_dict in params.items():
        sliced = {}
        for name, arr in leaf_dict.items():
            arr = np.asarray(arr)
            plan = _leaf_plan(path, name, arr.shape, dims, shard_rank,
                              shard_world)
            if plan is None:
                continue
            spans, out_shape = plan
            flat = arr.reshape(-1)
            sliced[name] = np.concatenate(
                [flat[lo:hi] for lo, hi in spans]).reshape(out_shape)
        if sliced:
            out[path] = sliced
    return out


def _bf16_to_f32(a: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (2-byte voids or uint16) widened to float32,
    exactly."""
    return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
            << 16).view(np.float32)


class ShardedParams:
    """Loader for shard-layout parameter trees."""

    @staticmethod
    def from_checkpoint(root: str, model, shard_rank: int,
                        shard_world: int, step: Optional[int] = None
                        ) -> dict:
        """Load a FULL checkpoint of a ``{path: {name: array}}`` parameter
        tree in the JAX layout — as the JAX package's ``Module.init()`` tree
        saves, or the port's ``checkpoint.save(root,
        interop.jax_params(model), step)`` — directly into shard
        ``shard_rank``'s layout, reading only the bytes this shard owns plus
        the replicated leaves: each sliced leaf is assembled from contiguous
        fragment range-reads of the uncompressed ``arrays.npz`` through the
        reshard engine's ``_ShardReader``.  Peak host memory is one full
        replicated leaf.  A tree of another structure (a ``TrainState``'s
        torch-layout ``.params['fc.weight']`` leaves) is refused by name.
        bfloat16 leaves come back as float32 (exact)."""
        from .. import checkpoint as ckpt
        from ..resilience.reshard import _ShardReader

        dims = _model_dims(model)
        _check_world(dims, shard_world)
        if step is None:
            step = ckpt.latest_step(root)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {root!r}")
        step_dir = os.path.join(root, f"step_{step:08d}")
        with open(os.path.join(step_dir, "tree.json")) as f:
            doc = json.load(f)
        reader = _ShardReader.from_dir(step_dir, label="full checkpoint")
        out: Dict[str, dict] = {}
        try:
            for key, spec in doc["leaves"].items():
                m = re.match(r"^\['([^']+)'\]\['([^']+)'\]$", key)
                if m is None:
                    raise ShardConfigError(
                        f"checkpoint leaf {key!r} is not a "
                        f"{{path: {{name: array}}}} parameter tree — save "
                        f"the JAX-layout tree (interop.jax_params)")
                path, name = m.group(1), m.group(2)
                shape = tuple(spec["shape"])
                bf16 = spec["dtype"] == "bfloat16"
                dtype = np.dtype("V2") if bf16 else np.dtype(spec["dtype"])
                plan = _leaf_plan(path, name, shape, dims, shard_rank,
                                  shard_world)
                if plan is None:
                    continue
                spans, out_shape = plan
                parts = [reader.read_range(key, lo, hi, dtype)
                         for lo, hi in spans]
                leaf = np.concatenate(parts).reshape(out_shape)
                out.setdefault(path, {})[name] = (_bf16_to_f32(leaf)
                                                  if bf16 else leaf)
        finally:
            reader.close()
        return out


# ---------------------------------------------------------------------------
# the per-shard model: same module paths, sharded shapes
# ---------------------------------------------------------------------------

class _ShardAttention(nn.MultiheadSelfAttention):
    """One shard's attention: ``nl`` heads of ``head_dim`` read from the
    full ``dim``-wide residual stream and projected back to it — qkv weight
    (3·nl·hd, dim), out weight (dim, nl·hd), torch's (out, in) layout.
    ``out_bias=False`` drops the out projection's bias (shard ranks above 0
    under the partial-sum convention) while the qkv bias stays."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 bias: bool, out_bias: bool, rope: bool, rope_theta: float,
                 device=None):
        self._model_dim = int(dim)
        self._has_out_bias = bool(bias and out_bias)
        super().__init__(num_heads * head_dim, num_heads, bias=bias,
                         causal=True, device=device, rope=rope,
                         rope_theta=rope_theta)

    def _init_projections(self, bias: bool, device) -> None:
        inner, dim = self.embed_dim, self._model_dim
        self.qkv_weight = torch.nn.Parameter(
            torch.zeros(3 * inner, dim, device=device))
        self.out_weight = torch.nn.Parameter(
            torch.zeros(dim, inner, device=device))
        self.qkv_bias = (torch.nn.Parameter(torch.zeros(3 * inner,
                                                        device=device))
                         if bias else None)
        self.out_bias = (torch.nn.Parameter(torch.zeros(dim, device=device))
                         if self._has_out_bias else None)

    def reset_parameters(self, generator=None):
        """A shard's weights always come from a full model's tree
        (``interop.load_jax_params``); zeros until then."""
        for p in self.parameters():
            torch.nn.init.zeros_(p)


class ShardedLM(TransformerLM):
    """One shard's slice of a ``TransformerLM``, with the full model's
    parameter PATHS (``block0.attn``, ``block0.mlp.0`` …) and sharded
    shapes — ``num_heads / W`` heads a block, ``hidden / W`` MLP columns —
    so :func:`shard_params` trees load straight in (through
    :func:`~tpu_dist_torch.interop.load_jax_params`).

    Built from a full model *spec* (its hyperparameters are read off the
    model; its weights are not used).  The forward is exposed as per-block
    segments (``op=`` ``embed_attn`` / ``attn`` / ``mlp`` / ``head``)
    because the cross-shard combines run on the host data plane between
    them; each segment adds the previous combine's result into the residual
    stream itself, so every byte of that stream comes from the same code on
    every shard."""

    def __init__(self, model, shard_rank: int, shard_world: int):
        dims = _model_dims(model)
        _check_world(dims, shard_world)
        if not 0 <= shard_rank < shard_world:
            raise ShardConfigError(
                f"shard_rank {shard_rank} out of range for shard world "
                f"{shard_world}")
        device = next(model.parameters()).device
        super().__init__(
            dims["vocab"], dim=dims["dim"], depth=0,
            num_heads=dims["num_heads"], max_seq_len=dims["max_seq_len"],
            causal=True, norm="rmsnorm" if dims["rmsnorm"] else "layernorm",
            device=device, rope=dims["rope"], rope_theta=dims["rope_theta"])
        nl = dims["num_heads"] // shard_world
        hl = dims["hidden"] // shard_world
        norm_cls = nn.RMSNorm if dims["rmsnorm"] else nn.LayerNorm
        for i in range(dims["depth"]):
            blk = torch.nn.Module()
            blk.ln1 = norm_cls(dims["dim"], device=device)
            blk.attn = _ShardAttention(
                dims["dim"], nl, dims["head_dim"], dims["qkv_bias"],
                out_bias=shard_rank == 0, rope=dims["rope"],
                rope_theta=dims["rope_theta"], device=device)
            blk.ln2 = norm_cls(dims["dim"], device=device)
            blk.mlp = nn.Sequential(
                nn.Linear(dims["dim"], hl, device=device), nn.GELU(),
                nn.Linear(hl, dims["dim"], bias=shard_rank == 0,
                          device=device))
            setattr(self, f"block{i}", blk)
        self.depth = dims["depth"]
        self.shard_rank = int(shard_rank)
        self.shard_world = int(shard_world)
        self.shard_dims = dims

    def forward(self, *args, op=None, layer: int = 0, cache=None):
        if op is None:
            raise ShardConfigError(
                "a ShardedLM holds partial weights — drive it through "
                "ShardedDecoder's segments, not a full forward")
        if op == "embed_attn":
            # embeddings fused into block 0's attention segment
            idx, pos_offset = args
            x = self.embed_tokens(idx, pos_offset)
            blk = self.block0
            return x, blk.attn(blk.ln1(x), cache=cache)
        if op == "head":
            x, add = args
            return self.head(self.ln_f(x + add))
        blk = getattr(self, f"block{layer}")
        if op == "attn":
            x, add = args
            x = x + add               # previous block's combined MLP rows
            return x, blk.attn(blk.ln1(x), cache=cache)
        if op == "mlp":
            x, add = args
            y = x + add               # this block's combined attention rows
            return y, blk.mlp(blk.ln2(y))
        raise ShardConfigError(f"unknown segment op {op!r}")


# ---------------------------------------------------------------------------
# the decoder: segments on the device, combines on the host data plane
# ---------------------------------------------------------------------------

class ShardedDecoder:
    """One shard's pipeline over a :class:`ShardedLM`: the slot pool's two
    operations with the single-rank model's signatures —
    :meth:`decode_pool` is ``decode_step``'s, :meth:`prefill_pool`
    ``prefill_into_slot``'s, both returning ``(logits, cache)`` — with each
    block's two partial activations combined by :meth:`all_reduce` between
    segments.  Sampling stays with the engine (replicated on every shard).

    ``model``: the full ``TransformerLM`` (a spec) or a :class:`ShardedLM`.
    ``params``: this shard's tree from :func:`shard_params` or
    :meth:`ShardedParams.from_checkpoint`, loaded into the ShardedLM
    through ``interop``; None when ``model`` is a ShardedLM already
    holding its weights.  ``dp``: the shard group's data plane (its ranks
    are the shard ranks); ``dp=None`` is the world-1 layout.
    ``comm_dtype`` opts the combine's wire into cast or block-quantized
    compression (``"int8_block256"``): every shard still receives the same
    bytes, so the group stays in lockstep, but tokens may differ from the
    uncompressed decode.  The shard runs on the spec model's device."""

    def __init__(self, model, params, dp, shard_rank: int,
                 shard_world: int, comm_dtype=None,
                 ar_timeout: float = 120.0):
        if isinstance(model, ShardedLM):
            self.slm = model
        else:
            self.slm = ShardedLM(model, shard_rank, shard_world)
        if (self.slm.shard_rank, self.slm.shard_world) != (shard_rank,
                                                           shard_world):
            raise ShardConfigError(
                f"ShardedLM coordinates ({self.slm.shard_rank}, "
                f"{self.slm.shard_world}) disagree with the decoder's "
                f"({shard_rank}, {shard_world})")
        if params is not None:
            load_jax_params(self.slm, params)
        self.slm.eval()
        self.device = self.slm.device
        self.dp = dp
        self.rank = int(shard_rank)
        self.world = int(shard_world)
        if self.world > 1 and dp is None:
            raise ShardConfigError(
                "a multi-rank shard group needs the p2p data plane "
                "(dp=None is world-1 only)")
        self.comm_dtype = comm_dtype
        self.ar_timeout = float(ar_timeout)
        self.depth = self.slm.shard_dims["depth"]
        self._seq = 0          # per-combine tag counter (lockstep)
        self.algo_counts = {"exchange": 0, "ring": 0}
        self._paths = [f"block{i}.attn" for i in range(self.depth)]

    # -- the cross-shard combine --------------------------------------------

    def all_reduce(self, partial):
        """Sum ``partial`` (a tensor on this shard's device) across the
        shard group; the sum comes back on the device, the same bytes on
        every shard.  Small partials take the direct exchange
        (:func:`_exchange_all_reduce`) on this thread, larger ones — and
        every ``comm_dtype`` — the ring all-reduce over the data plane on
        the group's ordered engine (after any collective queued there).  A
        peer's death raises the data plane's named ``PeerGoneError``."""
        from ..collectives.work import engine_for

        device = partial.device
        if self.world <= 1:
            return partial
        arr = partial.detach().cpu().numpy()
        seq = self._seq
        self._seq += 1
        grp = f"shard:w{self.world}"
        if self.comm_dtype is None and arr.nbytes <= _EXCHANGE_MAX_BYTES:
            algo = "exchange"

            def run():
                with _tp_span("shard_all_reduce", arr, grp):
                    _note_algo("exchange")
                    out = _exchange_all_reduce(self.dp, arr, f"sx{seq}",
                                               self.ar_timeout)
                return torch.from_numpy(out).to(device)
        else:
            from ..collectives.ring import ring_all_reduce
            algo = "ring"

            def run():
                with _tp_span("shard_all_reduce", arr, grp):
                    _note_algo("ring")
                    out = ring_all_reduce(self.dp, arr, op="sum",
                                          tag=f"sd{seq}",
                                          comm_dtype=self.comm_dtype)
                return torch.from_numpy(
                    np.ascontiguousarray(out)).to(device)
        self.algo_counts[algo] += 1
        if algo == "exchange":
            return run()
        return engine_for(self.dp).submit(
            run, label=f"shard-ar{seq}").wait(self.ar_timeout)

    # -- pool operations (the single-rank model's signatures) ---------------

    def init_slot_cache(self, slots: int, max_len: int, dtype):
        return self.slm.init_slot_cache(slots, max_len, dtype)

    def _segments(self, toks, pos, states: dict):
        """The segment pipeline over every block: ``states`` holds each
        layer's cache entry with its write index; returns the logits."""
        slm = self.slm
        x, part = slm(toks, pos, op="embed_attn",
                      cache=states[self._paths[0]])
        add = None
        for i in range(self.depth):
            if i > 0:
                x, part = slm(x, add, op="attn", layer=i,
                              cache=states[self._paths[i]])
            attn_out = self.all_reduce(part)
            x, part2 = slm(x, attn_out, op="mlp", layer=i)
            add = self.all_reduce(part2)
        return slm(x, add, op="head")

    @torch.inference_mode()
    def decode_pool(self, tokens, lengths, cache: dict):
        """One decode iteration over the whole pool (``decode_step``'s
        contract): two combines a block, logits (B, vocab) the same on every
        shard."""
        lengths = np.asarray(lengths.cpu() if torch.is_tensor(lengths)
                             else lengths, np.int64).reshape(-1)
        tmax = next(iter(cache.values()))["k"].shape[1]
        for slot in np.flatnonzero((lengths < 0) | (lengths >= tmax)):
            raise ValueError(
                f"decode_pool: slot {slot} is at length {lengths[slot]}; "
                f"its cache row holds positions 0..{tmax - 1}")
        lens = torch.from_numpy(lengths).to(self.device)
        states = {path: dict(entry, index=lens)
                  for path, entry in cache.items()}
        toks = torch.as_tensor(tokens, device=self.device).long()[:, None]
        logits = self._segments(toks, lens, states)
        return logits[:, -1], cache

    @torch.inference_mode()
    def prefill_pool(self, prompt, length: int, slot: int, cache: dict):
        """Prefill one request into slot ``slot`` (``prefill_into_slot``'s
        contract): the padded prompt runs the segment pipeline at batch 1
        through a fresh cache row, then each layer's rows land in this
        shard's slice of the pool.  Returns ``(logits of the last real token
        (vocab,), cache)``."""
        entry = next(iter(cache.values()))
        slots, tmax = entry["k"].shape[:2]
        prompt = torch.as_tensor(prompt, device=self.device).long()
        if not 0 < length <= prompt.shape[0] <= tmax:
            raise ValueError(f"prefill_pool: need 0 < length ({length}) <= "
                             f"prompt ({prompt.shape[0]}) <= cache row "
                             f"({tmax})")
        if not 0 <= slot < slots:
            raise ValueError(f"prefill_pool: slot {slot} outside the pool's "
                             f"{slots} slots")
        rows = self.slm.init_cache(1, tmax, entry["k"].dtype)
        logits = self._segments(prompt[None], 0, rows)
        write_slot_rows(cache, rows, slot)
        return logits[0, int(length) - 1], cache


# ---------------------------------------------------------------------------
# leader engine + follower loop
# ---------------------------------------------------------------------------

def _plan_bytes(plan: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(plan).encode(), dtype=np.uint8)


def _plan_from(arr) -> dict:
    return json.loads(bytes(bytearray(np.asarray(arr, np.uint8))).decode())


class ShardedSlotEngine(SlotEngine):
    """The leader's engine (shard rank 0): every slot-bookkeeping line is
    the single-rank engine's; only the pool operations (the
    :class:`ShardedDecoder` pipeline) and the three decision broadcast
    points (admission, expiry sweep, shutdown) differ.  Drive it from the
    ordinary :class:`~tpu_dist_torch.serve.Scheduler`."""

    def __init__(self, decoder: ShardedDecoder, num_slots: int = 8,
                 max_len: Optional[int] = None, cache_dtype=None,
                 min_bucket: int = 16):
        if decoder.rank != 0:
            raise ShardConfigError(
                f"the leader engine runs on shard rank 0; rank "
                f"{decoder.rank} runs a ShardFollower")
        self.decoder = decoder
        self._closed_plan_sent = False
        self._poisoned: Optional[BaseException] = None
        self._bcast_mu = threading.Lock()
        self._last_plan = time.monotonic()
        self._plan_seq = 0
        super().__init__(decoder.slm, num_slots=num_slots, max_len=max_len,
                         cache_dtype=cache_dtype, min_bucket=min_bucket,
                         device=decoder.device)

    def _build_programs(self) -> None:
        self._decode = self.decoder.decode_pool
        self._prefill = self.decoder.prefill_pool

    # -- plan broadcast -------------------------------------------------------

    def _bcast(self, plan: dict, best_effort: bool = False) -> None:
        dec = self.decoder
        if dec.world <= 1:
            return
        # the monotone plan seq rides in the frame: followers record it on
        # apply, so a missed plan frame shows as a gap in their dumps
        self._plan_seq += 1
        plan = dict(plan, seq=self._plan_seq)
        data = _plan_bytes(plan)
        for dst in range(dec.world):
            if dst == dec.rank:
                continue
            try:
                dec.dp.send_array(dst, _CTL_TAG, data)
            except Exception:
                if not best_effort:
                    raise
        from ..obs.recorder import safe_record
        safe_record("plan", "send", plan_seq=self._plan_seq,
                    plan=str(plan.get("op")), dst=dec.world - 1)
        self._last_plan = time.monotonic()

    def _pre_admit(self, req: Request, slot: int) -> None:
        self._check_lockstep()
        staged = req.staged if req.staged is not None else self.stage(req)
        self._bcast({"op": "admit", "slot": slot,
                     "prompt": torch.as_tensor(staged).tolist(),
                     "length": int(len(req.prompt)),
                     "max_new_tokens": int(req.max_new_tokens),
                     "eos_id": req.eos_id,
                     "temperature": float(req.temperature),
                     "seed": int(req.seed)})

    @property
    def fatal_error(self):
        """The scheduler's engine-unusable probe: a poisoned lockstep is
        group-fatal even with no slot decoding."""
        if self._poisoned is None:
            return None
        return ShardPlanError(
            f"shard group lost lockstep: the leader's prefill failed AFTER "
            f"its admit plan was broadcast ({self._poisoned!r}) — followers "
            f"advanced their combine sequence; the gang must restart")

    def _check_lockstep(self) -> None:
        err = self.fatal_error
        if err is not None:
            raise err

    def _admit(self, req: Request, slot: int) -> int:
        try:
            return super()._admit(req, slot)
        except Exception as e:
            # the admit plan is already on the wire (the followers have
            # prefilled this slot and advanced their tag counters): poison
            # the engine — the next step raises and the scheduler fails
            # everything by name (the gang-restart path)
            self._poisoned = e
            raise

    def step(self) -> int:
        self._check_lockstep()
        if self.active.any():
            self._bcast({"op": "step"})
        return super().step()

    def _pre_free(self, slots: List[int]) -> None:
        self._bcast({"op": "free", "slots": [int(s) for s in slots]})

    def sweep_expired(self) -> int:
        """The single-rank sweep plus the idle liveness probe: the scheduler
        loop calls this at every iteration boundary, so an IDLE leader still
        touches every follower's socket on a bounded cadence."""
        freed = super().sweep_expired()
        self._probe_followers()
        return freed

    def _probe_followers(self) -> None:
        if self.decoder.world <= 1 or self._poisoned is not None \
                or self._closed_plan_sent:
            return
        itv = _probe_interval()
        if itv <= 0 or time.monotonic() - self._last_plan < itv:
            return
        # a follower answers a ping by staying connected: the probe's value
        # is the SEND walking every follower's socket
        self._bcast({"op": "ping"})

    def fail_all(self, exc: BaseException) -> None:
        # scheduler close / fatal: tell followers the group is done — best
        # effort (the cause may BE a dead follower), once
        with self._bcast_mu:
            if not self._closed_plan_sent:
                self._closed_plan_sent = True
                self._bcast({"op": "close", "cause": type(exc).__name__},
                            best_effort=True)
        super().fail_all(exc)

    def close(self) -> None:
        """Idempotent clean shutdown plan (a leader exiting without a fatal
        error must still release its followers)."""
        with self._bcast_mu:
            if not self._closed_plan_sent:
                self._closed_plan_sent = True
                self._bcast({"op": "close", "cause": "shutdown"},
                            best_effort=True)


class _Shadow:
    """A follower's per-slot mirror of the leader's Request bookkeeping —
    enough to free slots in lockstep (EOS / length) — and the tokens it
    sampled, for lockstep checks."""

    __slots__ = ("max_new_tokens", "eos_id", "emitted", "tokens")

    def __init__(self, max_new_tokens: int, eos_id: Optional[int]):
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.emitted = 0
        self.tokens: List[int] = []


class ShardFollower:
    """Shard ranks 1..W-1: mirror the leader's engine operations from its
    plan frames and join every combine.  All state is derived — the sampled
    tokens are computed locally (identical logits → identical tokens), so
    the only wire traffic besides the combines is the plan stream.
    ``streams`` keeps every finished request's tokens in admission order
    (``(slot, tokens)``), the stream a lockstep check holds against the
    leader's.

    :meth:`run` loops until a ``close`` plan, the leader's death
    (``PeerGoneError``), or ``deadline`` seconds."""

    def __init__(self, decoder: ShardedDecoder, num_slots: int = 8,
                 max_len: Optional[int] = None, cache_dtype=None,
                 leader: int = 0):
        if decoder.rank == 0:
            raise ShardConfigError(
                "shard rank 0 is the leader (ShardedSlotEngine)")
        self.decoder = decoder
        self.leader = int(leader)
        self.num_slots = int(num_slots)
        dims = decoder.slm.shard_dims
        self.max_len = int(max_len if max_len is not None
                           else dims["max_seq_len"])
        self.cache_dtype = cache_dtype or torch.float32
        with torch.inference_mode():
            self.cache = decoder.init_slot_cache(
                self.num_slots, self.max_len, self.cache_dtype)
        self.lengths = np.zeros(self.num_slots, np.int64)
        self.tokens = np.zeros(self.num_slots, np.int64)
        self.temps = np.zeros(self.num_slots, np.float32)
        self.keys = np.zeros((self.num_slots, 2), np.int64)
        self.steps_ = np.ones(self.num_slots, np.int64)
        self.active = np.zeros(self.num_slots, bool)
        self.shadow: List[Optional[_Shadow]] = [None] * self.num_slots
        self.streams: List[tuple] = []
        self.plans_applied = 0
        self.decode_steps = 0
        self.close_cause: Optional[str] = None

    # -- plan application -----------------------------------------------------

    def _apply_admit(self, plan: dict) -> None:
        slot = int(plan["slot"])
        if self.active[slot]:
            raise ShardPlanError(
                f"admit plan targets slot {slot} this follower still has "
                f"active — the shard group lost lockstep")
        length = int(plan["length"])
        temp = float(plan["temperature"])
        key = random.key(int(plan["seed"])).numpy()
        logits, self.cache = self.decoder.prefill_pool(
            np.asarray(plan["prompt"], np.int64), length, slot, self.cache)
        tok = int(sample_host(logits[None], np.array([temp], np.float32),
                              key[None], np.zeros(1, np.int64))[0])
        self.lengths[slot] = length
        self.tokens[slot] = tok
        self.temps[slot] = temp
        self.keys[slot] = key
        self.steps_[slot] = 1
        self.active[slot] = True
        sh = _Shadow(int(plan["max_new_tokens"]), plan.get("eos_id"))
        self.shadow[slot] = sh
        sh.emitted = 1
        sh.tokens.append(tok)
        self._maybe_free(slot, tok)

    def _apply_step(self) -> None:
        logits, self.cache = self.decoder.decode_pool(
            self.tokens, self.lengths, self.cache)
        nxt = sample_host(logits, self.temps, self.keys, self.steps_)
        self.decode_steps += 1
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            tok = int(nxt[slot])
            self.lengths[slot] += 1
            self.steps_[slot] += 1
            self.tokens[slot] = tok
            self.shadow[slot].emitted += 1
            self.shadow[slot].tokens.append(tok)
            self._maybe_free(slot, tok)

    def _check_slot(self, slot) -> None:
        if not 0 <= int(slot) < self.num_slots:
            raise ShardPlanError(
                f"leader plan targets slot {slot} but this follower has "
                f"{self.num_slots} slots — leader and followers were built "
                f"with different num_slots")

    def _maybe_free(self, slot: int, token: int) -> None:
        sh = self.shadow[slot]
        if (sh.eos_id is not None and token == sh.eos_id) \
                or sh.emitted >= sh.max_new_tokens:
            self.streams.append((slot, list(sh.tokens)))
            self._free(slot)

    def _free(self, slot: int) -> None:
        self.active[slot] = False
        self.lengths[slot] = 0
        self.tokens[slot] = 0
        self.temps[slot] = 0.0
        self.shadow[slot] = None

    def apply_plan(self, plan: dict) -> bool:
        """Mirror one leader operation; False once the group closed."""
        op = plan.get("op")
        from ..obs.recorder import safe_record
        safe_record("plan", "apply", plan_seq=plan.get("seq"),
                    plan=str(op))
        if op == "admit":
            self._check_slot(plan["slot"])
            self._apply_admit(plan)
        elif op == "step":
            self._apply_step()
        elif op == "free":
            for slot in plan["slots"]:
                self._check_slot(slot)
                if self.shadow[int(slot)] is not None:
                    self._free(int(slot))
        elif op == "ping":
            pass    # idle liveness probe: staying connected IS the answer
        elif op == "close":
            self.close_cause = plan.get("cause", "shutdown")
            return False
        else:
            raise ShardPlanError(f"unknown control plan op {op!r}")
        self.plans_applied += 1
        return True

    def recv_plan(self, timeout: float = _PLAN_TIMEOUT) -> dict:
        """Next control plan from the leader (FIFO); raises the data plane's
        named ``PeerGoneError`` when the leader died, ``TimeoutError`` after
        ``timeout``."""
        return _plan_from(self.decoder.dp.recv_array(self.leader, _CTL_TAG,
                                                     timeout))

    def run(self, deadline: Optional[float] = None,
            plan_timeout: float = _PLAN_TIMEOUT) -> str:
        """Serve plans until close / leader death / ``deadline`` seconds.
        Returns the close cause (``"shutdown"``, the leader's fatal error
        name, or ``"deadline"``)."""
        end = None if deadline is None else time.monotonic() + deadline
        while True:
            left = plan_timeout if end is None \
                else min(plan_timeout, end - time.monotonic())
            if left <= 0:
                return "deadline"
            try:
                plan = self.recv_plan(timeout=max(left, 0.001))
            except TimeoutError:
                if end is not None and time.monotonic() >= end:
                    return "deadline"
                continue
            if not self.apply_plan(plan):
                return self.close_cause or "shutdown"
