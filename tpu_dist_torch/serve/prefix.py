"""Shared prefix cache — counterpart of ``tpu_dist/serve/prefix.py``:
repeated prompt prefixes skip their prefill.

Chat traffic repeats itself: the same system prompt or few-shot preamble
heads thousands of requests, and prefill re-derives the identical KV rows
every time.  :class:`PrefixCache` keys **token-block chains**: a prompt's
first ``j * block_tokens`` tokens hash to a chain key per level ``j``, and
each level's entry holds that block's KV rows (batch-1, computed once by
``TransformerLM.prefill_rows``) plus the FULL prefix tokens for **content
verification** — a hash collision is a verified *miss*, never another
prompt's KV.  A hit at level ``j`` means only the suffix past ``j *
block_tokens`` runs the forward, at positions offset into the restored
rows; the hit is capped at ``len(prompt) - 1`` so at least one real token
prefills (the next-token logits come from the live forward).

Entries hold tensors on the cache's ``device`` (the card unless the caller
names the CPU): a hit is a concatenation on the device and
:meth:`resident_bytes` counts device bytes.  Storage is LINEAR in cached
tokens (each level stores only its own block), and the resident set is
bounded by ``capacity_bytes``: cold entries page out to a spill tier
(``spill_dir``) as **uncompressed npz**, one flat member per entry
(bfloat16 as its 16-bit patterns, the dtype recorded by name), and page
back in through the reshard engine's fragment range-reads
(``resilience/reshard._ShardReader``) — byte-exact, so a paged-then-
restored hit is bitwise the inserted rows.  The spill index persists
(``index.json``), so a restarted cache serves its paged entries without
recomputing them.

Counters (:meth:`stats`): hits, misses, collisions, inserts, evictions,
pages out and in, tokens saved.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..collectives import _lowp
from ..ops._build import resolve_device

__all__ = ["PrefixCache"]


def _dtype_name(t: torch.Tensor) -> str:
    return _lowp.dtype_name(_lowp.from_torch(t[:0].cpu()).dtype)


def _to_disk(t: torch.Tensor) -> np.ndarray:
    """A tensor's flat host bytes as a plain numpy array (bfloat16 as
    uint16 patterns)."""
    a = _lowp.from_torch(t.reshape(-1))
    name = _lowp.lowp_name(a.dtype)
    return a.view(a.dtype[name]) if name is not None else a


def _from_disk(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if _lowp.is_lowp(_lowp.decode_dtype(dtype_name)):
        a = a.view(_lowp.decode_dtype(dtype_name))
    return _lowp.to_torch(a, device)


def _storage_dtype(dtype_name: str) -> np.dtype:
    dt = _lowp.decode_dtype(dtype_name)
    return dt[0] if _lowp.is_lowp(dt) else dt


class _Entry:
    """One chain level: ``tokens`` is the FULL verified prefix (``level *
    block`` ids), ``rows`` this level's OWN block of KV rows (None while
    paged out)."""

    __slots__ = ("key", "level", "tokens", "rows", "nbytes", "last_use",
                 "location", "spans")

    def __init__(self, key, level, tokens, rows, nbytes, location="mem",
                 spans=None):
        self.key = key
        self.level = level
        self.tokens = tokens
        self.rows = rows
        self.nbytes = nbytes
        self.last_use = 0
        self.location = location
        self.spans = spans      # [(path, k, lo, hi, shape, dtype)] on disk


class PrefixCache:
    """Content-verified, byte-capped, spill-backed KV prefix cache.

    Thread-safe (one lock; prefill workers share an instance).  ``rows``
    trees are ``{layer_path: {"k"/"v"/...: (1, T, ...)}}`` of tensors (or
    host arrays, moved to ``device`` on insert)."""

    def __init__(self, block_tokens: int = 16,
                 capacity_bytes: int = 64 << 20,
                 spill_dir: Optional[str] = None, device=None):
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got "
                             f"{block_tokens}")
        self.block = int(block_tokens)
        self.capacity_bytes = int(capacity_bytes)
        self.spill_dir = os.fspath(spill_dir) if spill_dir else None
        self.device = resolve_device(device)
        self._mu = threading.RLock()
        self._entries: Dict[str, _Entry] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.collisions = 0
        self.inserts = 0
        self.evicted = 0
        self.paged_out = 0
        self.paged_in = 0
        self.tokens_saved = 0
        if self.spill_dir:
            os.makedirs(self.spill_dir, exist_ok=True)
            self._load_index()

    # -- keys -----------------------------------------------------------------

    def _key_for(self, tokens: np.ndarray) -> str:
        """Chain key for a FULL prefix (an instance method so tests can
        force collisions and check the verified-miss contract)."""
        return hashlib.sha256(
            np.ascontiguousarray(tokens, np.int32).tobytes()).hexdigest()

    # -- lookup ---------------------------------------------------------------

    def match(self, tokens) -> Tuple[int, Optional[dict]]:
        """Longest cached-and-verified prefix of ``tokens``: ``(hit_len,
        rows)`` with ``rows`` the concatenated ``(1, hit_len, ...)``
        per-layer tree on ``device``, or ``(0, None)``.  Capped at
        ``len(tokens) - 1`` so a suffix always remains to prefill."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        levels = max(0, (len(tokens) - 1) // self.block)
        with self._mu:
            self._clock += 1
            chain: List[_Entry] = []
            for j in range(1, levels + 1):
                prefix = tokens[:j * self.block]
                ent = self._entries.get(self._key_for(prefix))
                if ent is None:
                    break
                if (len(ent.tokens) != len(prefix)
                        or not np.array_equal(ent.tokens, prefix)):
                    # same key, different tokens: a MISS by construction
                    self.collisions += 1
                    break
                chain.append(ent)
            if not chain:
                self.misses += 1
                return 0, None
            for ent in chain:
                if ent.location != "mem":
                    self._page_in(ent)
                ent.last_use = self._clock
            hit_len = chain[-1].level * self.block
            rows = {path: {k: torch.cat([e.rows[path][k] for e in chain],
                                        dim=1)
                           for k in chain[0].rows[path]}
                    for path in chain[0].rows}
            self.hits += 1
            self.tokens_saved += hit_len
            # enforce AFTER assembling the hit: paging in must not page the
            # same chain back out before its rows are read
            self._enforce_capacity()
            return hit_len, rows

    # -- insertion ------------------------------------------------------------

    def insert(self, tokens, rows, length: int) -> int:
        """Cache every complete block of ``tokens[:length]`` whose chain
        level is not already present, slicing its rows out of ``rows``
        (full prefill output, ``(1, >= length, ...)`` per layer).  Returns
        the number of new levels cached."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)[:int(length)]
        levels = len(tokens) // self.block
        added = 0
        with self._mu:
            self._clock += 1
            for j in range(1, levels + 1):
                prefix = tokens[:j * self.block]
                key = self._key_for(prefix)
                got = self._entries.get(key)
                if got is not None:
                    # verified occupancy: a colliding other-prompt entry
                    # keeps its slot (first write wins)
                    got.last_use = self._clock
                    continue
                lo, hi = (j - 1) * self.block, j * self.block
                block_rows = {
                    path: {k: self._tensor(rows[path][k])[:, lo:hi].clone()
                           for k in rows[path] if k != "index"}
                    for path in rows}
                nbytes = sum(t.numel() * t.element_size()
                             for e in block_rows.values()
                             for t in e.values())
                ent = _Entry(key, j, prefix.copy(), block_rows, nbytes)
                ent.last_use = self._clock
                self._entries[key] = ent
                self.inserts += 1
                added += 1
            if added:
                self._enforce_capacity()
        return added

    def _tensor(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device)
        return _lowp.to_torch(np.asarray(a), self.device)

    # -- capacity / spill tier ------------------------------------------------

    def resident_bytes(self) -> int:
        with self._mu:
            return sum(e.nbytes for e in self._entries.values()
                       if e.location == "mem")

    def _enforce_capacity(self) -> None:
        resident = [e for e in self._entries.values()
                    if e.location == "mem"]
        total = sum(e.nbytes for e in resident)
        if total <= self.capacity_bytes:
            return
        for ent in sorted(resident, key=lambda e: e.last_use):
            if total <= self.capacity_bytes:
                break
            total -= ent.nbytes
            if self.spill_dir:
                self._page_out(ent)
            else:
                del self._entries[ent.key]
                self.evicted += 1

    def _entry_dir(self, key: str) -> str:
        return os.path.join(self.spill_dir, key)

    def _page_out(self, ent: _Entry) -> None:
        """Spill one entry: its rows flatten into ONE uncompressed npz
        member, each layer a contiguous element span — the layout
        ``_ShardReader.read_range`` pulls fragments from."""
        spans, parts, off = [], [], 0
        for path in sorted(ent.rows):
            for k in sorted(ent.rows[path]):
                t = ent.rows[path][k]
                n = int(t.numel())
                spans.append((path, k, off, off + n, list(t.shape),
                              _dtype_name(t)))
                parts.append(_to_disk(t))
                off += n
        # one dtype per entry keeps the member a plain range-readable
        # array; KV rows share the cache dtype by construction
        dtypes = {s[5] for s in spans}
        if len(dtypes) != 1:
            raise ValueError(f"prefix entry mixes dtypes {sorted(dtypes)}")
        d = self._entry_dir(ent.key)
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "arrays.npz"), rows=np.concatenate(parts))
        ent.spans = spans
        ent.rows = None
        ent.location = "disk"
        self.paged_out += 1
        self._save_index()

    def _page_in(self, ent: _Entry) -> None:
        from ..resilience.reshard import _ShardReader

        reader = _ShardReader.from_dir(self._entry_dir(ent.key),
                                       label=f"prefix {ent.key[:12]}")
        try:
            rows: Dict[str, Dict[str, torch.Tensor]] = {}
            for path, k, lo, hi, shape, dtype in ent.spans:
                frag = reader.read_range("rows", int(lo), int(hi),
                                         _storage_dtype(dtype))
                rows.setdefault(path, {})[k] = _from_disk(
                    frag, dtype, self.device).reshape(shape)
        finally:
            reader.close()
        ent.rows = rows
        ent.location = "mem"
        self.paged_in += 1

    # -- index persistence ----------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.spill_dir, "index.json")

    def _save_index(self) -> None:
        doc = {}
        for ent in self._entries.values():
            if ent.location == "disk":
                doc[ent.key] = {
                    "level": ent.level,
                    "tokens": np.asarray(ent.tokens, np.int32).tolist(),
                    "nbytes": int(ent.nbytes),
                    "spans": [[p, k, int(lo), int(hi), list(shape), dt]
                              for p, k, lo, hi, shape, dt in ent.spans]}
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "block": self.block,
                       "entries": doc}, f)
        os.replace(tmp, self._index_path())

    def _load_index(self) -> None:
        try:
            with open(self._index_path()) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return
        if doc.get("block") != self.block:
            # a different block size re-keys every chain: stale spill
            return
        for key, spec in doc.get("entries", {}).items():
            spans = [(p, k, lo, hi, shape, dt)
                     for p, k, lo, hi, shape, dt in spec["spans"]]
            self._entries[key] = _Entry(
                key, int(spec["level"]),
                np.asarray(spec["tokens"], np.int32), None,
                int(spec["nbytes"]), location="disk", spans=spans)

    def close(self) -> None:
        """Persist the spill index (paged entries survive a restart)."""
        with self._mu:
            if self.spill_dir:
                self._save_index()

    # -- stats ----------------------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            return {"hits": self.hits, "misses": self.misses,
                    "collisions": self.collisions,
                    "inserts": self.inserts, "evicted": self.evicted,
                    "paged_out": self.paged_out, "paged_in": self.paged_in,
                    "tokens_saved": self.tokens_saved,
                    "entries": len(self._entries),
                    "resident_bytes": self.resident_bytes()}
