"""Chunk-pipelined ring collectives over the host data plane — the port's
copy of ``tpu_dist/collectives/ring.py``, bit for bit its arithmetic.

A ring all-reduce is a reduce-scatter (N-1 steps, each passing 1/N of the
payload right while folding what arrives from the left) and an all-gather
(N-1 steps circulating the reduced chunks): 2(N-1)/N of the payload per
rank on the wire.  Each chunk goes as sub-chunk frames
(``TPU_DIST_DP_CHUNK``, 256 KiB; shared-memory peers take coarser frames),
and within a step the send of sub-chunk *j+1* interleaves with the fold of
what already arrived (:func:`_exchange`).  Accumulation order is the ring
order from each chunk's owner, so repeated runs, and a JAX rank beside a
port rank, give the same bytes.

``comm_dtype`` casts the wire (``bfloat16``: hops widen, add and re-cast a
partial sum; the owner re-casts its reduced chunk) or block-quantizes it
(``int8_block256``, :mod:`.quant`: the all-gather forwards the owner's
``(q, scales)`` frames verbatim, so every rank rebuilds each chunk from the
same bytes).  ``quant_residual`` is an error-feedback buffer, full-payload
(every hop and the owner) or owned-chunk sized (the owner only).  ``bounds``
overrides the chunk partition (the Bucketer aligns bucket chunks with each
leaf's own chunks).  ``_Watchdog`` charges every blocking recv of one
collective to ``TPU_DIST_COLL_TIMEOUT`` and raises
:class:`~.transport.CollectiveTimeoutError` naming the stalled hop.

The functions take a :class:`~.transport.DataPlane` (or a group view of
one, :mod:`.topology`) and numpy arrays; low-precision floats are
:mod:`._lowp` arrays.  Each collective opens a flight-recorder span
(:mod:`tpu_dist_torch.obs`, no-op while disarmed) and stamps it with the
wire quantities that the ``stats`` dicts carry.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np

from . import _lowp
from . import quant as _Q
from .transport import CollectiveTimeoutError, coll_timeout

__all__ = ["ring_all_reduce", "ring_all_gather", "ring_reduce_scatter",
           "ring_chunk_all_gather", "tree_broadcast", "ring_chunk_span",
           "RING_OPS"]

# reduce ops the ring path implements; others (product, bitwise) stay on
# the store path in eager.py
RING_OPS = frozenset({"sum", "avg", "mean", "max", "min"})

_DEF_CHUNK = 256 * 1024  # wire frame payload bytes


def _chunk_bytes(dp=None, dst: Optional[int] = None) -> int:
    try:
        base = max(4096, int(os.environ.get("TPU_DIST_DP_CHUNK",
                                            str(_DEF_CHUNK))))
    except ValueError:
        base = _DEF_CHUNK
    if dp is not None and dst is not None:
        # per-destination grain: shared-memory lanes want far coarser
        # frames than a slow wire (the transfer is a memcpy — pipelining
        # buys nothing, per-frame overhead dominates).  Rank-local and
        # value-free: frame segmentation never changes fold arithmetic,
        # so peers need not agree on it.
        hint = getattr(dp, "send_chunk_bytes", None)
        if hint is not None:
            try:
                return max(4096, int(hint(dst, base)))
            except Exception:
                return base
    return base


def _bounds(n_elems: int, n: int):
    """Chunk boundaries [(lo, hi)] * n covering ``n_elems`` elements; the
    first ``n_elems % n`` chunks get one extra element, so payloads that do
    not divide evenly are handled without padding.  The one flat chunk
    contract: ``parallel.rules.chunk_bounds`` is this function, and ZeRO
    shards, the bucketed reduce-scatter and reshard manifests cut by it."""
    q, rem = divmod(int(n_elems), int(n))
    out, lo = [], 0
    for i in range(int(n)):
        hi = lo + q + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def ring_chunk_span(n_elems: int, n: int, rank: int) -> Tuple[int, int]:
    """The (lo, hi) flat span of ``rank``'s chunk in a ring reduce-scatter
    over ``n_elems`` elements."""
    return _bounds(n_elems, n)[rank]


class _Watchdog:
    """End-to-end deadline for ONE collective (``TPU_DIST_COLL_TIMEOUT``).

    Every blocking recv in the ring charges against the same budget, so a
    partitioned/wedged hop raises :class:`CollectiveTimeoutError` naming
    the stalled hop within the configured bound — instead of each frame
    independently waiting out the (much longer) per-frame
    ``TPU_DIST_DP_TIMEOUT``.  Disabled (budget 0) it delegates to the
    transport's own internal deadline, exactly the old behavior."""

    __slots__ = ("op", "budget", "deadline")

    def __init__(self, op: str):
        self.op = op
        self.budget = coll_timeout()
        self.deadline = (time.monotonic() + self.budget
                         if self.budget > 0 else None)

    def recv(self, dp, src: int, tag: str, pos: int, hi: int):
        """One blocking frame recv under the collective deadline."""
        if self.deadline is None:
            # tpudlint: disable=TD004  # recv_array applies TPU_DIST_DP_TIMEOUT
            return dp.recv_array(src, tag)
        left = self.deadline - time.monotonic()
        if left <= 0:
            self._expired(dp, src, tag, pos, hi, None)
        try:
            return dp.recv_array(src, tag, timeout=left)
        except CollectiveTimeoutError:
            raise
        except TimeoutError as e:
            self._expired(dp, src, tag, pos, hi, e)

    def _expired(self, dp, src: int, tag: str, pos: int, hi: int,
                 cause) -> None:
        raise CollectiveTimeoutError(
            f"collective {self.op} wedged: rank {dp.rank} got no frame "
            f"from rank {src} (tag {tag!r}, waiting for span "
            f"[{pos}:{hi})) within TPU_DIST_COLL_TIMEOUT="
            f"{self.budget:.0f}s — stalled hop {src}->{dp.rank}"
            f"{_obs_position()}") from cause


def _obs_position() -> str:
    """This rank's last flight-recorder position (armed runs), stamped
    into watchdog errors so they name where the collective stood when it
    wedged."""
    try:
        from ..obs import hooks as _hooks
        from ..obs import recorder as _rec
        rec = _rec.get_recorder()
        if rec is not None:
            pos = rec.last_position()
            if pos is not None:
                return f"; flight recorder: {_hooks.render_tail(pos)}"
    except Exception:
        pass
    return ""


def _astype(a: np.ndarray, dt) -> np.ndarray:
    """``a.astype(dt, copy=False)`` where either side may be
    low-precision."""
    return a if a.dtype == np.dtype(dt) else _lowp.cast(a, dt)


def _combine(op: str):
    if op in ("sum", "avg", "mean"):
        return np.add
    if op == "max":
        return np.maximum
    if op == "min":
        return np.minimum
    raise ValueError(f"ring collectives support {sorted(RING_OPS)}, "
                     f"got {op!r}")


def _acc_dtype(dtype: np.dtype, op: str) -> np.dtype:
    """Accumulation dtype: widen sub-32-bit floats (bf16/f16 partial sums
    would lose whole ranks' contributions); integer avg accumulates in
    float64 to match ``np.mean`` semantics; integer sum follows
    ``np.add.reduce``'s platform promotion (int32 sums in int64 on 64-bit,
    exactly like the store path); max/min reduce in place."""
    if op in ("avg", "mean") and dtype.kind in "iub":
        return np.dtype(np.float64)
    if op == "sum" and dtype.kind in "iub":
        return np.add.reduce(np.zeros(1, dtype=dtype)).dtype
    # low-precision floats: numpy 'f2' and bfloat16/float8 (_lowp)
    low_precision_float = dtype.itemsize < 4 and _lowp.is_float(dtype)
    if low_precision_float and op not in ("max", "min"):
        return np.dtype(np.float32)
    return dtype


def _out_dtype(dtype: np.dtype, op: str) -> np.dtype:
    # store-path parity: avg mirrors np.mean's result dtype, sum mirrors
    # np.add.reduce's promotion; max/min never change dtype
    if op in ("avg", "mean"):
        try:
            return np.mean(np.zeros(1, dtype=dtype)).dtype
        except TypeError:
            return dtype
    if op == "sum" and dtype.kind in "iub":
        return np.add.reduce(np.zeros(1, dtype=dtype)).dtype
    return dtype


def _resolve_wire(comm_dtype, acc_dtype: np.dtype, float_only: bool = False):
    """Resolve a ``comm_dtype`` spec (None / dtype / quant-scheme string)
    against the accumulation dtype.  A quant scheme applies only to float
    accumulators (f32/f64) — quantizing integer payloads would silently
    change exact arithmetic.  ``float_only`` extends that gate to cast
    wires too (the gather paths: their payloads may be raw bytes — padded
    pickle frames from the object collectives — that a lossy cast would
    corrupt).  The gate depends only on dtype, so every rank answers
    identically."""
    wire = _Q.resolve_wire(comm_dtype)
    if wire is None:
        return None
    dt = np.dtype(acc_dtype)
    # float = numpy floats and bfloat16/float8 (_lowp), the recognition
    # the bucketer and routing gates use
    is_float = _lowp.is_float(dt)
    if isinstance(wire, _Q.QuantScheme):
        return wire if is_float else None
    return wire if (is_float or not float_only) else None


def _send_span(dp, dst: int, tag: str, flat: np.ndarray, lo: int, hi: int,
               wire_dtype: Optional[np.dtype]) -> int:
    """Send flat[lo:hi] as sub-chunk frames; returns wire bytes sent."""
    if hi <= lo:
        return 0
    step = max(1, _chunk_bytes(dp, dst) // flat.itemsize)
    wb = 0
    for slo in range(lo, hi, step):
        seg = flat[slo:min(slo + step, hi)]
        if isinstance(wire_dtype, _Q.QuantScheme):
            q, s = _Q.quantize(seg, wire_dtype)
            wb += dp.send_quant(dst, tag, _Q.QuantChunk(q, s, wire_dtype))
            continue
        if wire_dtype is not None and seg.dtype != wire_dtype:
            seg = _lowp.cast(seg, wire_dtype)
        wb += dp.send_array(dst, tag, seg)
    return wb


def _fold(flat: np.ndarray, seg, pos: int, hi: int, tag: str,
          combine) -> int:
    """Fold one arriving frame into ``flat[pos:pos+len]``; returns the new
    position.  ``combine`` is a ufunc (reduce-scatter) or None (overwrite,
    all-gather); frames in a narrower wire dtype widen here, quantized
    frames (:class:`~tpu_dist_torch.collectives.quant.QuantChunk`) dequantize
    here."""
    m = seg.size
    if pos + m > hi:
        raise RuntimeError(
            f"ring frame overrun: got {m} elements at {pos} with only "
            f"{hi - pos} expected (tag {tag!r})")
    if isinstance(seg, _Q.QuantChunk):
        part = seg.dequantize(flat.dtype)
    else:
        part = _astype(seg, flat.dtype)
    if combine is None:
        flat[pos:pos + m] = part
    elif _lowp.is_lowp(flat.dtype):
        # max/min over bfloat16/float8: compare the widened values
        flat[pos:pos + m] = _lowp.cast(
            combine(_lowp.cast(flat[pos:pos + m], np.float32),
                    _lowp.cast(part, np.float32)), flat.dtype)
    else:
        combine(flat[pos:pos + m], part, out=flat[pos:pos + m])
    return pos + m


def _recv_span(dp, src: int, tag: str, flat: np.ndarray, lo: int, hi: int,
               combine=None, wd: Optional[_Watchdog] = None) -> None:
    """Receive sub-chunk frames into flat[lo:hi]; each arriving frame is
    processed while the transport thread keeps reading the next one off
    the wire."""
    if wd is None:
        wd = _Watchdog("recv_span")
    pos = lo
    while pos < hi:
        pos = _fold(flat, wd.recv(dp, src, tag, pos, hi), pos, hi, tag,
                    combine)


def _exchange(dp, right: int, left: int, tag: str, flat: np.ndarray,
              send_lo: int, send_hi: int, recv_lo: int, recv_hi: int,
              combine, wire_dtype, residual=None,
              wd: Optional[_Watchdog] = None) -> int:
    """One double-buffered ring step: send ``flat[send_lo:send_hi]`` to
    ``right`` as sub-chunk frames while folding the frames arriving from
    ``left`` into ``flat[recv_lo:recv_hi]``.  Returns wire bytes sent.

    The send of sub-chunk *j+1* overlaps the fold of sub-chunk *i*: after
    every send the loop drains (non-blocking) whatever the transport's
    reader thread already queued, so CPU reduce time hides behind the wire
    and vice versa.  Only frames that genuinely have not arrived when the
    sends are done cost a blocking wait.

    Under a quant scheme the outgoing segments (reduce-scatter partial
    sums) are block-quantized fresh for each hop — their values change as
    contributions fold in, so there is nothing to forward verbatim; the
    verbatim-forwarding discipline belongs to the all-gather phase
    (:func:`_ag_phase_quant`).  ``residual`` (full-payload error-feedback
    buffer, indexed like ``flat``) compensates exactly this per-hop loss:
    each outgoing segment sends ``compress(seg + residual)`` and keeps the
    new loss for the next step."""
    step = max(1, _chunk_bytes(dp, right) // flat.itemsize)
    sp, rp = send_lo, recv_lo
    wb = 0
    while sp < send_hi:
        nxt = min(sp + step, send_hi)
        seg = flat[sp:nxt]
        res = residual[sp:nxt] if residual is not None else None
        sp = nxt
        if res is not None and res.size:
            seg = seg + _astype(np.asarray(res), seg.dtype)
        if isinstance(wire_dtype, _Q.QuantScheme):
            q, s = _Q.quantize(seg, wire_dtype)
            if res is not None and res.size:
                _store_residual(
                    res, seg - _Q.dequantize(q, s, wire_dtype, seg.dtype))
            wb += dp.send_quant(right, tag, _Q.QuantChunk(q, s, wire_dtype))
        else:
            sent = seg
            if wire_dtype is not None and seg.dtype != wire_dtype:
                sent = _lowp.cast(seg, wire_dtype)
            if res is not None and res.size and wire_dtype is not None \
                    and seg.dtype != wire_dtype:
                _store_residual(res, seg - _lowp.cast(sent, seg.dtype))
            wb += dp.send_array(right, tag, sent)
        while rp < recv_hi:
            got = dp.try_recv_array(left, tag)
            if got is None:
                break
            rp = _fold(flat, got, rp, recv_hi, tag, combine)
    if wd is None:
        wd = _Watchdog("exchange")
    while rp < recv_hi:
        rp = _fold(flat, wd.recv(dp, left, tag, rp, recv_hi), rp, recv_hi,
                   tag, combine)
    return wb


def _obs_span(op: str, value):
    """Flight-recorder span for one host ring collective: ring phases are
    where a dead or slow peer shows, so they get their own lockstep span,
    nested under the eager caller's (or standalone, for direct DataPlane
    users)."""
    from ..obs import hooks as _hooks
    return _hooks.collective_span(op, value=value, path="dataplane")


def _prepare(dp, x, op: str):
    x = np.asarray(x)
    op = str(op).lower()
    n, r = dp.num_processes, dp.rank
    acc = _acc_dtype(x.dtype, op)
    flat = _lowp.cast(np.ascontiguousarray(x).reshape(-1), acc)
    return x, op, n, r, flat


def _reduce_scatter_phase(dp, flat, bounds, n, r, op, tag,
                          wire_dtype, residual=None, wd=None) -> int:
    """N-1 double-buffered ring steps; afterwards this rank's own chunk
    ``bounds[r]`` holds the full reduction.  Schedule is the textbook one
    shifted so rank r ends up owning chunk r (send chunk (r-1-step),
    absorb (r-2-step)); within each step send and fold interleave
    (:func:`_exchange`).  Returns wire bytes sent.  ``residual`` is the
    full-payload per-hop error-feedback buffer (each chunk except this
    rank's own is sent exactly once, so every span is used once per
    call)."""
    comb = _combine(op)
    right, left = (r + 1) % n, (r - 1) % n
    rp = (r - 1) % n
    wb = 0
    for step in range(n - 1):
        si = (rp - step) % n
        ri = (rp - step - 1) % n
        wb += _exchange(dp, right, left, tag, flat, *bounds[si],
                        *bounds[ri], combine=comb, wire_dtype=wire_dtype,
                        residual=residual, wd=wd)
    return wb


def _all_gather_phase(dp, flat, bounds, n, r, tag, wire_dtype,
                      wd=None) -> int:
    """N-1 double-buffered ring steps circulating the fully-reduced chunks
    (rank r starts owning chunk r).  Returns wire bytes sent.  Quant
    schemes take :func:`_ag_phase_quant` instead (verbatim frame
    forwarding)."""
    right, left = (r + 1) % n, (r - 1) % n
    wb = 0
    for step in range(n - 1):
        si = (r - step) % n
        ri = (r - step - 1) % n
        wb += _exchange(dp, right, left, tag, flat, *bounds[si],
                        *bounds[ri], combine=None, wire_dtype=wire_dtype,
                        wd=wd)
    return wb


def _store_residual(residual, diff) -> None:
    """Update an error-feedback residual with this step's compression
    loss, dropping non-finite entries: a transient inf/nan gradient
    poisons THIS step's output loudly (the quant NaN-block policy), but
    must not lodge NaN in the residual and re-inject it forever — the
    poison stays one step, the residual restarts from zero there."""
    diff = np.asarray(diff)
    finite = np.isfinite(_astype(diff, np.float32))
    if not finite.all():
        diff = np.where(finite, diff, 0)
    residual[...] = _astype(diff, residual.dtype)


def _compress_owned(chunk: np.ndarray, wire, residual):
    """Round this rank's fully-reduced owned chunk through the wire format
    — the value every peer will receive — optionally folding in and
    updating an error-feedback residual (the owner adds last step's
    compression loss before compressing, then keeps the new loss).

    Returns ``(values, qframes)``: the wire-faithful replacement values in
    the chunk's dtype, plus the exact ``(q, scales)`` pair to forward
    (quant schemes only, else None)."""
    if chunk.size == 0:
        return chunk, None
    if residual is not None and residual.size:
        chunk = chunk + _astype(np.asarray(residual), chunk.dtype)
    if isinstance(wire, _Q.QuantScheme):
        q, s = _Q.quantize(chunk, wire)
        deq = _Q.dequantize(q, s, wire, dtype=chunk.dtype)
        frames = (q, s)
    else:
        deq = _lowp.cast(_lowp.cast(chunk, wire), chunk.dtype)
        frames = None
    if residual is not None and residual.size:
        _store_residual(residual, chunk - deq)
    return deq, frames


def _split_quant(q: np.ndarray, scales: np.ndarray, scheme, dp=None,
                 dst=None):
    """Split one whole-chunk quantization into wire frames at
    block-aligned boundaries, so each frame carries exactly its own
    scales.  Frame size tracks ``TPU_DIST_DP_CHUNK`` (the wire payload is
    ~1 byte per element)."""
    n = q.size
    cb = _chunk_bytes(dp, dst)
    step = max(scheme.block, cb - cb % scheme.block)
    frames = []
    for flo in range(0, n, step):
        fhi = min(flo + step, n)
        frames.append(_Q.QuantChunk(
            q[flo:fhi],
            scales[flo // scheme.block:scheme.scales_for(fhi)], scheme))
    return frames


def _land_quant(flat, got, pos: int, hi: int, tag: str, incoming) -> int:
    """All-gather-phase landing of one quantized frame: dequantize into
    ``flat`` AND keep the frame for verbatim forwarding next step."""
    if not isinstance(got, _Q.QuantChunk):
        raise RuntimeError(
            f"quantized ring expected a q8 frame on tag {tag!r}, got a "
            f"plain {getattr(got, 'dtype', type(got).__name__)} frame — "
            f"ranks disagree on the comm scheme")
    m = got.size
    if pos + m > hi:
        raise RuntimeError(
            f"ring frame overrun: got {m} elements at {pos} with only "
            f"{hi - pos} expected (tag {tag!r})")
    flat[pos:pos + m] = got.dequantize(flat.dtype)
    incoming.append(got)
    return pos + m


def _ag_phase_quant(dp, flat, bounds, n, r, tag, scheme,
                    residual=None, wd=None) -> int:
    """All-gather phase under a quant scheme: the owner compresses its
    chunk ONCE (folding in the error-feedback residual, replacing its own
    span with the dequantized values every peer will hold), then the
    quantized frames circulate **verbatim** — each rank forwards exactly
    the bytes it received, so all N ranks reconstruct every chunk from
    identical frames.  Returns wire bytes sent."""
    if wd is None:
        wd = _Watchdog("ag_phase_quant")
    right, left = (r + 1) % n, (r - 1) % n
    lo, hi = bounds[r]
    chunk = np.array(flat[lo:hi])  # standalone: _compress_owned re-binds
    deq, qs = _compress_owned(chunk, scheme, residual)
    flat[lo:hi] = deq
    frames = _split_quant(*qs, scheme, dp, right) if qs is not None else []
    wb = 0
    for step in range(n - 1):
        ri = (r - step - 1) % n
        rlo, rhi = bounds[ri]
        incoming: list = []
        pos = rlo
        for fr in frames:
            wb += dp.send_quant(right, tag, fr)
            while pos < rhi:
                got = dp.try_recv_array(left, tag)
                if got is None:
                    break
                pos = _land_quant(flat, got, pos, rhi, tag, incoming)
        while pos < rhi:
            pos = _land_quant(flat, wd.recv(dp, left, tag, pos, rhi), pos,
                              rhi, tag, incoming)
        frames = incoming
    return wb


def _note_stats(stats, wire, wire_bytes: int, raw_bytes: int) -> None:
    """Fill the caller's ``stats`` dict and stamp the enclosing obs span
    with the wire quantities: ``wire_bytes`` = what actually crossed the
    wire (compressed), ``raw_wire_bytes`` = what the SAME traffic would
    have cost uncompressed — their ratio is the wire-format compression
    factor, independent of the ring's 2(N-1)/N amplification over the
    logical payload (which the span's ``bytes`` field still shows)."""
    name = _Q.wire_name(wire)
    if stats is not None:
        stats["wire_bytes"] = int(wire_bytes)
        stats["raw_wire_bytes"] = int(raw_bytes)
        stats["comm"] = name
    from ..obs import hooks as _hooks
    _hooks.note_wire(int(wire_bytes), name, raw_bytes=int(raw_bytes))


def ring_all_reduce(dp, x, op: str = "sum", tag: str = "ar",
                    comm_dtype=None, bounds=None, quant_residual=None,
                    stats=None) -> np.ndarray:
    """Bandwidth-optimal ring all-reduce of ``x`` across the group.

    reduce-scatter + all-gather, 2(N-1)/N of the payload on the wire per
    rank (the reference README §1 quantity).  ``op``: sum/avg/max/min
    (avg divides once at the chunk owner, so every rank receives identical
    averaged bytes).  Deterministic accumulation order (ring order from
    each chunk's owner), so repeated runs are bit-identical — the property
    the chaos e2e's resume check depends on.

    ``bounds`` overrides the chunk partition (N contiguous ``(lo, hi)``
    spans covering the flat payload, identical on every rank): the
    bucketer aligns bucket chunks with per-leaf chunks this way so that
    bucketed and per-leaf reductions share fold order bit-for-bit.

    ``comm_dtype`` accepts a dtype (cast wire) or a quant scheme spec
    (``"int8_block256"``); ``quant_residual`` is this rank's
    error-feedback buffer, updated in place with the new compression
    losses — either **full-payload-sized** (per-hop residuals for every
    outgoing partial sum, plus the owner compression: the strong EF the
    bucketer's all-reduce uses) or **owned-chunk-sized** (length
    ``bounds[rank]``, owner compression only: the ZeRO-shard-resident
    form).  ``stats`` (a dict) receives ``wire_bytes`` and ``comm`` — the
    compressed wire quantity, vs. the logical payload."""
    x, op, n, r, flat = _prepare(dp, x, op)
    _combine(op)  # raise on an unsupported op before any traffic
    out_dtype = _out_dtype(x.dtype, op)
    if n <= 1:
        return _lowp.cast(flat, out_dtype).reshape(x.shape)
    wire = _resolve_wire(comm_dtype, flat.dtype)
    if flat.size == 0:
        return _lowp.cast(flat, out_dtype).reshape(x.shape)
    if bounds is None:
        bounds = _bounds(flat.size, n)
    else:
        bounds = _check_bounds(bounds, n, flat.size)
    res_full, res_own = _split_residual(quant_residual, wire, flat.size,
                                        bounds[r])
    utag = f"{tag}/rar"
    wd = _Watchdog(f"ring_all_reduce[{op}]")
    with _obs_span("ring_all_reduce", x):
        wb = _reduce_scatter_phase(dp, flat, bounds, n, r, op, utag, wire,
                                   residual=res_full, wd=wd)
        lo, hi = bounds[r]
        if op in ("avg", "mean"):
            flat[lo:hi] = flat[lo:hi] / n
        if isinstance(wire, _Q.QuantScheme):
            # owner compression + verbatim frame circulation (quant.py's
            # byte-identity discipline)
            wb += _ag_phase_quant(dp, flat, bounds, n, r, utag, wire,
                                  residual=res_own, wd=wd)
        else:
            if wire is not None:
                # re-quantize the owned chunk through the wire dtype so
                # the values this rank keeps match the compressed copies
                # every peer receives
                deq, _ = _compress_owned(np.array(flat[lo:hi]), wire,
                                         res_own)
                flat[lo:hi] = deq
            wb += _all_gather_phase(dp, flat, bounds, n, r, utag, wire,
                                    wd=wd)
        # uncompressed-equivalent of the same traffic: this rank sends
        # every chunk but its own in the RS phase and every chunk but its
        # right neighbor's in the AG phase
        raw = ((2 * flat.size - (hi - lo)
                - _span_len(bounds, (r + 1) % n)) * flat.itemsize)
        _note_stats(stats, wire, wb, raw)
    return _astype(flat, out_dtype).reshape(x.shape)


def _span_len(bounds, i: int) -> int:
    lo, hi = bounds[i]
    return hi - lo


def _split_residual(quant_residual, wire, size: int, own_span):
    """Dispatch an error-feedback buffer by its length: full-payload
    (per-hop + owner residuals; the owner part is a view into it) or
    owned-chunk (owner compression only).  None when no lossy wire is in
    play — the residual must not drift while compression is off."""
    if quant_residual is None or wire is None:
        return None, None
    lo, hi = own_span
    res = quant_residual
    if res.size == size:
        return res, res[lo:hi]
    if res.size == hi - lo:
        return None, res
    raise ValueError(
        f"quant_residual must be full-payload ({size}) or owned-chunk "
        f"({hi - lo}) sized, got {res.size}")


def _check_bounds(bounds, n: int, size: int):
    bounds = [(int(lo), int(hi)) for lo, hi in bounds]
    if (len(bounds) != n or bounds[0][0] != 0 or bounds[-1][1] != size
            or any(bounds[i][1] != bounds[i + 1][0] for i in range(n - 1))):
        raise ValueError(
            f"bounds must be {n} contiguous spans covering [0, {size}), "
            f"got {bounds}")
    return bounds


def ring_reduce_scatter(dp, x, op: str = "sum", tag: str = "rs",
                        comm_dtype=None, bounds=None, quant_residual=None,
                        stats=None) -> np.ndarray:
    """Reduce-scatter phase alone: returns this rank's fully-reduced chunk
    (flat 1-D; its span is :func:`ring_chunk_span`, or ``bounds[rank]`` when
    a custom chunk partition is passed).  Uneven payloads give the first
    ``size % world`` ranks one extra element.

    The returned chunk is **bitwise-identical to the span a full
    :func:`ring_all_reduce` would have folded there** — same chunk owner,
    same accumulation order, same owner-side avg division and (under
    ``comm_dtype``) the same owner re-quantization through the wire dtype
    that the all-gather phase would have distributed.  That identity is
    what lets ZeRO-style sharded optimizers (tpu_dist/parallel/zero.py)
    stop here, update the owned shard, and still match the replicated
    update bit-for-bit."""
    x, op, n, r, flat = _prepare(dp, x, op)
    out_dtype = _out_dtype(x.dtype, op)
    if n <= 1:
        return _lowp.cast(flat, out_dtype)
    wire = _resolve_wire(comm_dtype, flat.dtype)
    if bounds is None:
        bounds = _bounds(flat.size, n)
    else:
        bounds = _check_bounds(bounds, n, flat.size)
    res_full, res_own = _split_residual(quant_residual, wire, flat.size,
                                        bounds[r])
    wb = 0
    if flat.size:
        with _obs_span("ring_reduce_scatter", x):
            wb = _reduce_scatter_phase(dp, flat, bounds, n, r,
                                       op, f"{tag}/rrs", wire,
                                       residual=res_full,
                                       wd=_Watchdog(
                                           f"ring_reduce_scatter[{op}]"))
            _note_stats(stats, wire, wb,
                        (flat.size - _span_len(bounds, r)) * flat.itemsize)
    lo, hi = bounds[r]
    chunk = flat[lo:hi]
    if op in ("avg", "mean"):
        chunk = chunk / n
    if wire is not None:
        # owner compression, exactly as ring_all_reduce performs before
        # its all-gather phase: the shard this rank keeps must equal the
        # compressed bytes every peer would have received (error-feedback
        # residual folded in / updated at the same point)
        chunk, _ = _compress_owned(np.array(chunk), wire, res_own)
    # copy: the slice would otherwise pin the whole widened accumulation
    # buffer alive for the lifetime of the (small) shard
    return np.array(_astype(chunk, out_dtype))


def ring_chunk_all_gather(dp, flat, bounds, tag: str = "cag",
                          comm_dtype=None, stats=None) -> np.ndarray:
    """All-gather of pre-owned chunks — the all-gather phase of the ring
    alone, the inverse of :func:`ring_reduce_scatter`'s stop.

    Every rank passes the same full-size 1-D ``flat`` buffer with its own
    chunk ``bounds[rank]`` filled (the other spans are scratch); after
    N-1 double-buffered ring steps every span holds its owner's bytes —
    identical on every rank.  Fills ``flat`` in place and returns it.
    This is how a ZeRO optimizer redistributes updated parameter shards
    (tpu_dist/parallel/zero.py).

    ``comm_dtype`` (dtype or quant scheme) compresses the gathered chunks
    on the wire — **lossy**: every rank, including the owner, ends up with
    the chunk rounded through the wire format (the owner replaces its own
    span first, so the result stays byte-identical across ranks).  Leave
    it None when the gathered values are parameters that must stay
    exact."""
    flat = np.asarray(flat)
    if flat.ndim != 1:
        raise ValueError(f"ring_chunk_all_gather wants a flat 1-D buffer, "
                         f"got shape {flat.shape}")
    n, r = dp.num_processes, dp.rank
    if n <= 1 or flat.size == 0:
        return flat
    bounds = _check_bounds(bounds, n, flat.size)
    wire = _resolve_wire(comm_dtype, flat.dtype, float_only=True)
    wd = _Watchdog("ring_chunk_all_gather")
    with _obs_span("ring_chunk_all_gather", flat):
        if isinstance(wire, _Q.QuantScheme):
            wb = _ag_phase_quant(dp, flat, bounds, n, r, f"{tag}/rcag",
                                 wire, wd=wd)
        else:
            if wire is not None:
                lo, hi = bounds[r]
                deq, _ = _compress_owned(np.array(flat[lo:hi]), wire, None)
                flat[lo:hi] = deq
            wb = _all_gather_phase(dp, flat, bounds, n, r, f"{tag}/rcag",
                                   wire_dtype=wire, wd=wd)
        _note_stats(stats, wire, wb,
                    (flat.size - _span_len(bounds, (r + 1) % n))
                    * flat.itemsize)
    return flat


def ring_all_gather(dp, x, tag: str = "ag", comm_dtype=None,
                    stats=None) -> np.ndarray:
    """Ring all-gather: every rank contributes ``x`` (same shape/dtype on
    all ranks); returns an array with a leading process axis, blocks in
    rank order — (N-1)/N of the output on the wire per rank.

    ``comm_dtype`` (dtype or quant scheme) compresses the circulated
    blocks — **lossy**: every rank's block, including its own copy in the
    result, is rounded through the wire format at the source, so the
    gathered array stays byte-identical across ranks."""
    x = np.asarray(x)
    n, r = dp.num_processes, dp.rank
    if n <= 1:
        return x[None].copy()
    flat = np.ascontiguousarray(x).reshape(-1)
    out = np.empty((n, flat.size), dtype=x.dtype)
    out[r] = flat
    utag = f"{tag}/rag"
    # the (n, size) block matrix viewed flat so each step's send/recv rows
    # become spans of ONE buffer the double-buffered exchange can walk
    out_flat = out.reshape(-1)
    sz = flat.size
    bounds = [(i * sz, (i + 1) * sz) for i in range(n)]
    wire = _resolve_wire(comm_dtype, out.dtype, float_only=True)
    wd = _Watchdog("ring_all_gather")
    with _obs_span("ring_all_gather", x):
        wb = 0
        if sz:
            if isinstance(wire, _Q.QuantScheme):
                wb = _ag_phase_quant(dp, out_flat, bounds, n, r, utag,
                                     wire, wd=wd)
            else:
                if wire is not None:
                    deq, _ = _compress_owned(np.array(out[r]), wire, None)
                    out[r] = deq
                wb = _all_gather_phase(dp, out_flat, bounds, n, r, utag,
                                       wire_dtype=wire, wd=wd)
        _note_stats(stats, wire, wb, sz * (n - 1) * out.itemsize)
    return out.reshape((n,) + x.shape)


def tree_broadcast(dp, x, src: int = 0, tag: str = "bc") -> np.ndarray:
    """Binomial-tree broadcast of ``src``'s array: log2(N) rounds, each
    holder forwarding to a rank 2^k away, sub-chunked on the wire.  Every
    rank passes an ``x`` of the broadcast shape/dtype (non-src values are
    templates, as in ``broadcast_host``)."""
    x = np.asarray(x)
    n, r = dp.num_processes, dp.rank
    if n <= 1:
        return np.asarray(x)
    rel = (r - src) % n
    if rel == 0:
        # copy, not a view: receivers get fresh arrays off the wire, and the
        # source's return value must have the same no-aliasing property
        flat = np.array(x, copy=True).reshape(-1)
    else:
        flat = np.empty(x.size, dtype=x.dtype)
    utag = f"{tag}/tbc"
    k = 1
    wd = _Watchdog("tree_broadcast")
    with _obs_span("tree_broadcast", x):
        while k < n:
            if rel < k:
                peer_rel = rel + k
                if peer_rel < n:
                    _send_span(dp, (src + peer_rel) % n, utag, flat, 0,
                               flat.size, wire_dtype=None)
            elif rel < 2 * k:
                _recv_span(dp, (src + rel - k) % n, utag, flat, 0,
                           flat.size, combine=None, wd=wd)
            k *= 2
    return flat.reshape(x.shape)
