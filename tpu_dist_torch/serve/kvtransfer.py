"""KV-cache transfer between prefill and decode ranks — counterpart of
``tpu_dist/serve/kvtransfer.py`` (the wire half of disaggregated serving).

A prefill rank computes one request's per-layer KV rows
(``TransformerLM.prefill_rows``, on its card) and ships them to the decode
rank that owns the request as **per-layer contiguous fragments** over the
p2p data plane: the rows come to the host (one copy per fragment), and
every fragment rides one CRC-sealed frame, so a bit flipped on the KV wire
fails the connection with a named ``FrameCorruptError`` instead of decoding
silently wrong tokens.  Only the request's TRUE ``length`` columns travel:
the bucket padding past ``length`` is masked or overwritten before it is
ever attended.  The decode side receives host arrays (bfloat16 as the
host wire's 2-byte patterns, :mod:`~tpu_dist_torch.collectives._lowp`) and
copies them to its card when it admits the request.

Wire layout per request ``rid`` (the JAX package's tags):

- ``kv/{rid}/m`` — int64 meta ``[length, first_tok, prefix_hit,
  prefill_ns, n_frames]``: the prefill rank samples the request's FIRST
  token itself, so the decode rank starts decoding with no round trip;
- ``kv/{rid}/{j}.{key}`` — fragment ``j``: a layer's ``key`` rows
  (``k``/``v``, and an int8 cache's ``k_scale``/``v_scale``), shape ``(1,
  length, ...)``, in (sorted path, sorted key) order on both sides.

``wire="int8_blockN"`` opts each FLOAT fragment into the block-quantized
int8 wire (lossy: token parity with ``generate()`` no longer holds).
Integer fragments — an int8 slot cache's k/v, already quantized, their
scales riding as float fragments — ship exact on either wire.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..collectives import _lowp
from .engine import ServeError

__all__ = ["KVTransfer", "KVTransferError", "kv_template"]

_META_FIELDS = 5   # length, first_tok, prefix_hit, prefill_ns, n_frames


class KVTransferError(ServeError):
    """A KV transfer could not complete (deadline passed, fragment or meta
    drift, wire mismatch) — names the request and the peer so the decode
    side can retry the prefill by name or fail the handle."""


def _np_dtype(dt) -> np.dtype:
    """A tensor's or array's dtype as the host wire's numpy dtype."""
    if isinstance(dt, torch.dtype):
        return _lowp.from_torch(torch.empty(0, dtype=dt)).dtype
    return np.dtype(dt)


def _host(arr) -> np.ndarray:
    return _lowp.from_torch(arr) if torch.is_tensor(arr) else np.asarray(arr)


def kv_template(cache_or_rows) -> Dict[str, Dict[str, Tuple[tuple, np.dtype]]]:
    """``{layer_path: {key: (trailing_shape, dtype)}}`` from a slot-cache
    pool or a batch-1 row tree (tensors or host arrays) — the shape contract
    both endpoints derive from their OWN model, so a fragment that arrives
    with drifted geometry is a named error, not a silent reshape."""
    out: Dict[str, Dict[str, Tuple[tuple, np.dtype]]] = {}
    for path, entry in cache_or_rows.items():
        out[path] = {}
        for key, arr in entry.items():
            if key == "index":
                continue
            shape = tuple(int(d) for d in arr.shape[2:])
            out[path][key] = (shape, _np_dtype(arr.dtype))
    return out


class KVTransfer:
    """Rank-addressed KV-row transfer over a
    :class:`~tpu_dist_torch.collectives.transport.DataPlane`.

    ``template`` (:func:`kv_template`) fixes the per-layer fragment
    geometry; both sides build it from their own model, so the tag order is
    deterministic without negotiation.  ``wire=None`` ships exact dtype
    bytes; ``wire="int8_blockN"`` block-quantizes each float fragment
    (lossy opt-in)."""

    def __init__(self, dp, template, wire=None):
        from ..collectives.quant import parse_scheme

        self.dp = dp
        self.template = {path: dict(entry)
                         for path, entry in template.items()}
        self._frames: List[Tuple[str, str]] = [
            (path, key) for path in sorted(self.template)
            for key in sorted(self.template[path])]
        self.wire = parse_scheme(wire) if isinstance(wire, str) else wire
        if wire is not None and self.wire is None:
            raise KVTransferError(
                f"KV wire spec {wire!r} is not an int8_block{{N}} scheme "
                f"(the exact wire is wire=None)")
        self.sent_bytes = 0
        self.fetched_bytes = 0

    @staticmethod
    def _tag(rid: int, j: Optional[int] = None,
             key: Optional[str] = None) -> str:
        if j is None:
            return f"kv/{rid}/m"
        return f"kv/{rid}/{j}.{key}"

    def _quantized(self, path: str, key: str) -> bool:
        """Whether this fragment rides the int8_block wire: FLOAT fragments
        only (re-quantizing an int8 cache's integer rows would be pure
        loss).  Both endpoints decide off the template's dtype."""
        if self.wire is None:
            return False
        return _lowp.is_float(self.template[path][key][1])

    # -- prefill side ---------------------------------------------------------

    def send(self, dst: int, rid: int, rows, length: int, first_tok: int,
             prefix_hit: int = 0, prefill_ns: int = 0) -> int:
        """Ship ``rows`` (per-layer batch-1 trees, tensors on any device or
        host arrays) truncated to ``length`` columns to rank ``dst``.
        Returns wire payload bytes sent; a dead decode rank raises the data
        plane's named ``PeerGoneError``."""
        length = int(length)
        frags = []
        for path, key in self._frames:
            shape, dtype = self.template[path][key]
            arr = _host(rows[path][key][:, :length])
            if arr.shape[2:] != shape or arr.shape[0] != 1:
                raise KVTransferError(
                    f"kv send {rid}: layer {path!r}[{key}] rows have shape "
                    f"{arr.shape}, template expects (1, {length}, "
                    f"{', '.join(map(str, shape))}) — the two endpoints' "
                    f"models disagree")
            if arr.dtype != dtype:
                arr = _lowp.cast(arr, dtype)
            frags.append(np.ascontiguousarray(arr))
        meta = np.asarray([length, int(first_tok), int(prefix_hit),
                           int(prefill_ns), len(frags)], np.int64)
        sent = self.dp.send_array(dst, self._tag(rid), meta)
        for j, ((path, key), arr) in enumerate(zip(self._frames, frags)):
            if self._quantized(path, key):
                from ..collectives.quant import QuantChunk, quantize
                q, scales = quantize(arr.reshape(-1), self.wire)
                sent += self.dp.send_quant(
                    dst, self._tag(rid, j, key),
                    QuantChunk(q, scales, self.wire))
            else:
                sent += self.dp.send_array(dst, self._tag(rid, j, key), arr)
        self.sent_bytes += int(sent)
        return int(sent)

    # -- decode side ----------------------------------------------------------

    def fetch(self, src: int, rid: int, timeout: float) -> dict:
        """Receive request ``rid``'s rows from rank ``src`` within
        ``timeout`` seconds (the whole transfer shares one deadline).
        Returns ``{"rows", "length", "first_tok", "prefix_hit",
        "prefill_ns", "bytes"}`` with host rows in the template's dtypes.  A
        missed deadline raises :class:`KVTransferError` naming the request
        and the peer; a dead peer surfaces as the data plane's named
        ``PeerGoneError``."""
        deadline = time.monotonic() + float(timeout)

        def recv(tag):
            left = deadline - time.monotonic()
            if left <= 0:
                raise KVTransferError(
                    f"kv fetch {rid}: transfer from rank {src} missed its "
                    f"{float(timeout):.1f}s deadline (TPU_DIST_KV_TIMEOUT "
                    f"tunes it; a dead prefill rank raises PeerGoneError "
                    f"instead)")
            try:
                return self.dp.recv_array(src, tag, left)
            except TimeoutError as e:
                raise KVTransferError(
                    f"kv fetch {rid}: transfer from rank {src} missed its "
                    f"{float(timeout):.1f}s deadline waiting for "
                    f"{tag!r}: {e}") from e

        meta = np.asarray(recv(self._tag(rid)), np.int64).reshape(-1)
        if meta.size != _META_FIELDS:
            raise KVTransferError(
                f"kv fetch {rid}: meta frame has {meta.size} fields, "
                f"expected {_META_FIELDS} — sender/receiver version drift")
        length, first_tok, prefix_hit, prefill_ns, n_frames = (
            int(x) for x in meta)
        if n_frames != len(self._frames):
            raise KVTransferError(
                f"kv fetch {rid}: sender ships {n_frames} fragments, this "
                f"model expects {len(self._frames)} — layer layout drift")
        rows: Dict[str, Dict[str, np.ndarray]] = {}
        nbytes = int(meta.nbytes)
        for j, (path, key) in enumerate(self._frames):
            shape, dtype = self.template[path][key]
            got = recv(self._tag(rid, j, key))
            if self._quantized(path, key):
                nbytes += int(got.nbytes)
                got = _lowp.cast(got.dequantize(np.float32), dtype)
            else:
                nbytes += int(np.asarray(got).nbytes)
            rows.setdefault(path, {})[key] = \
                np.asarray(got).reshape((1, length) + shape)
        self.fetched_bytes += nbytes
        return {"rows": rows, "length": length, "first_tok": first_tok,
                "prefix_hit": prefix_hit, "prefill_ns": prefill_ns,
                "bytes": nbytes}
