"""Elastic world-size resharding — counterpart of
``tpu_dist/resilience/reshard.py``: resume a sharded (ZeRO) checkpoint saved
at world N on a gang of world M.  The manifest, the plan, the range reads
and the digests are the JAX package's, so a sharded checkpoint written by
either package reshards in the other.  A fragment comes from a disk this
rank sees, or is pushed by the rank that sees it over the host data plane
(:func:`execute_plan` with ``dp``), as in the JAX package.

The redistribution discipline is the one from "Memory-efficient array
redistribution through portable collective communication": never
materialize the full replicated state anywhere — each **destination** rank
fetches only the byte spans it will own.  The PR 6 shard layout was built
for exactly this consumption: every rank's checkpointed ZeRO state is, per
dtype group, ONE flat contiguous array that concatenates the member
leaves' owned ring chunks (``ring._bounds(leaf.size, world)[rank]``) in
leaf order.  Both the old and the new partition are therefore pure
functions of ``(leaf sizes, world)`` — the same bounds math the
bucketer/ring run — so the mapping from any new rank's owned spans to
``(old_rank, offset, length)`` source fragments is computable by every
rank independently, with no coordination beyond agreeing on ``(step, N)``.

Three layers:

- **Manifest** (:func:`manifest_from_arrays`, embedded by
  ``checkpoint.save(shard=...)`` into each shard checkpoint's
  ``tree.json``): leaf sizes + dtypes (the partition inputs), which saved
  arrays are sharded along the group axis vs replicated, and a sha256 per
  *fragment* (each member leaf's chunk inside the flat shard) — so an
  N→M restore is self-describing and digest-verified at the granularity
  actually read.
- **Plan** (:class:`ReshardPlan`): for every new rank, the exact
  ``(old_rank, old_offset, length)`` fragments covering its new spans —
  deterministic and identical on every rank, which is what lets the peer
  path run as a pre-agreed push/fetch with no request/response protocol.
- **Execution** (:func:`reshard_restore`): fragments whose old shard
  checkpoint is disk-visible are **range-read** straight out of the
  uncompressed ``arrays.npz`` (no full-file load); the others are pushed
  by their source rank over the data plane.  Peak memory is accounted and
  bounded by ``old_shard + new_shard + one fragment``.

``resilience.TrainState.resume`` drives this automatically (visibility
exchange + step/world agreement through the control-plane store); the
functions here are also directly usable for offline conversion of a
checkpoint tree between world sizes.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

# the flat chunk contract ZeRO shards and the bucketed reduce-scatter cut by
from ..parallel.rules import chunk_bounds

__all__ = ["ReshardError", "ReshardPlan", "ReshardStats",
           "manifest_from_arrays", "local_visibility", "resumable_steps",
           "reshard_restore", "plan_summary"]

_META_SEG = "['meta']"
_MANIFEST_META = ("rank", "world", "leaf_size", "leaf_dtype")


class ReshardError(RuntimeError):
    """Elastic resharding cannot proceed (missing source shard, absent
    manifest, template/manifest structure mismatch, or a dead peer named
    mid-fetch)."""


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def _groups(leaf_dtypes: Sequence[str]) -> List[Tuple[str, List[int]]]:
    """Dtype groups in first-occurrence leaf order — the exact grouping
    ``ZeroOptimizer._build_plan`` uses, reconstructed from the recorded
    per-leaf dtype strings so any world can recompute the layout."""
    groups: List[Tuple[str, List[int]]] = []
    by_key: Dict[str, List[int]] = {}
    for i, key in enumerate(leaf_dtypes):
        if key not in by_key:
            by_key[key] = []
            groups.append((key, by_key[key]))
        by_key[key].append(i)
    return groups


def _span_len(size: int, world: int, rank: int) -> int:
    lo, hi = chunk_bounds(size, world)[rank]
    return hi - lo


def manifest_from_arrays(arrays: Dict[str, np.ndarray]) -> Optional[dict]:
    """Build the reshard manifest for one shard checkpoint's flattened
    array dict, or None when the tree holds no ZeRO-style ``meta``
    (``rank``/``world``/``leaf_size``/``leaf_dtype``) — such a tree is
    world-size-opaque and stays restorable only at its own coordinates.

    One manifest *entry* per subtree that carries a meta block (the
    ``prefix`` is the flattened key path of that subtree, e.g.
    ``"['zero']"``); each entry records the partition inputs, the sharded
    vs replicated array paths, and per-fragment digests.
    """
    entries: Dict[str, dict] = {}
    for key in arrays:
        suffix = f"{_META_SEG}['leaf_size']"
        if not key.endswith(suffix):
            continue
        prefix = key[:-len(suffix)]
        meta_keys = {m: f"{prefix}{_META_SEG}['{m}']" for m in _MANIFEST_META}
        if not all(k in arrays for k in meta_keys.values()):
            continue  # pre-elastic meta (no leaf_dtype): not reshardable
        rank = int(np.asarray(arrays[meta_keys["rank"]]))
        world = int(np.asarray(arrays[meta_keys["world"]]))
        sizes = [int(s) for s in np.asarray(arrays[meta_keys["leaf_size"]])]
        dtypes = [str(d) for d in np.asarray(arrays[meta_keys["leaf_dtype"]])]
        groups = _groups(dtypes)
        shard_len = {g: sum(_span_len(sizes[i], world, rank) for i in idxs)
                     for g, idxs in groups}
        sharded: Dict[str, str] = {}
        replicated: Dict[str, dict] = {}
        frag_sha: Dict[str, List[str]] = {}
        repl_sha: Dict[str, str] = {}
        for path, a in arrays.items():
            if not path.startswith(prefix) \
                    or path.startswith(prefix + _META_SEG):
                continue
            a = np.asarray(a)
            gkey = a.dtype.str
            if a.ndim == 1 and gkey in shard_len \
                    and a.size == shard_len[gkey]:
                sharded[path] = gkey
                digests, pos = [], 0
                for i in dict(groups)[gkey]:
                    ln = _span_len(sizes[i], world, rank)
                    digests.append(hashlib.sha256(
                        np.ascontiguousarray(a[pos:pos + ln])
                        .tobytes()).hexdigest())
                    pos += ln
                frag_sha[path] = digests
            else:
                replicated[path] = {"shape": list(a.shape),
                                    "dtype": a.dtype.str}
                repl_sha[path] = hashlib.sha256(
                    np.ascontiguousarray(a).tobytes()).hexdigest()
        entries[prefix] = {
            "rank": rank, "world": world,
            "leaf_size": sizes, "leaf_dtype": dtypes,
            "sharded": sharded, "replicated": replicated,
            "frag_sha256": frag_sha, "repl_sha256": repl_sha,
        }
    if not entries:
        return None
    return {"version": 1, "entries": entries}


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

class _Frag:
    """One contiguous overlap between a new rank's owned span of a leaf
    and an old rank's: ``length`` elements read at ``old_off`` of the old
    rank's flat array at ``path``, landing at ``new_off`` of the new one.
    ``chunk_off``/``chunk_len`` locate the *whole* old fragment (the old
    rank's full chunk of this leaf — the digest unit) and ``leaf_pos``
    indexes its recorded sha256."""

    __slots__ = ("fid", "path", "dtype", "old_rank", "new_rank", "old_off",
                 "new_off", "length", "chunk_off", "chunk_len", "leaf_pos",
                 "leaf_ord")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    def describe(self) -> str:
        return (f"{self.path}[leaf {self.leaf_ord}] old_rank "
                f"{self.old_rank} [{self.old_off}:{self.old_off + self.length}]"
                f" -> new_rank {self.new_rank}")


class _Repl:
    """A replicated (identical on every old rank) saved array — scalar
    step counters and the like: copied whole from one source old rank to
    every new rank."""

    __slots__ = ("rid", "path", "shape", "dtype", "sha256")

    def __init__(self, rid, path, shape, dtype, sha256):
        self.rid, self.path, self.shape = rid, path, shape
        self.dtype, self.sha256 = dtype, sha256

    def describe(self) -> str:
        return f"replicated array {self.path!r}"


class ReshardStats:
    """What one rank's reshard actually did — surfaced in the restart log
    and asserted by the memory-bound test."""

    def __init__(self):
        self.old_world = 0
        self.new_world = 0
        self.step = -1
        self.frags_total = 0        # fragments this rank assembled
        self.bytes_total = 0
        self.frags_disk = 0
        self.frags_peer = 0
        self.frags_pushed = 0       # fragments this rank served to peers
        self.peak_bytes = 0         # accounted live allocation high-water
        self.new_shard_bytes = 0
        self.frag_bytes_max = 0
        self._live = 0
        self._mu = threading.Lock()

    def _alloc(self, n: int) -> None:
        with self._mu:
            self._live += n
            self.peak_bytes = max(self.peak_bytes, self._live)

    def _free(self, n: int) -> None:
        with self._mu:
            self._live -= n

    def describe(self) -> str:
        return (f"world {self.old_world} -> {self.new_world} @ step "
                f"{self.step}: {self.frags_total} fragments / "
                f"{self.bytes_total} B ({self.frags_disk} disk, "
                f"{self.frags_peer} peer; {self.frags_pushed} pushed), "
                f"peak {self.peak_bytes} B")


class ReshardPlan:
    """The full N→M fragment map — every rank's fetches, not just this
    one's, because the peer path is a pre-agreed push: source ranks must
    know exactly what to send where without a request round-trip."""

    def __init__(self, manifest: dict, new_world: int):
        entries = manifest.get("entries") or {}
        if not entries:
            raise ReshardError(
                "manifest has no reshardable entries (the checkpoint was "
                "saved without ZeRO leaf_dtype meta — re-save it with this "
                "package before resuming at a different world size)")
        worlds = {e["world"] for e in entries.values()}
        if len(worlds) != 1:
            raise ReshardError(f"manifest entries disagree on the saved "
                               f"world size: {sorted(worlds)}")
        self.old_world = worlds.pop()
        self.new_world = int(new_world)
        if self.new_world < 1:
            raise ReshardError(f"new world must be >= 1, got {new_world}")
        self.frags: List[_Frag] = []
        self.repl: List[_Repl] = []
        self.new_len: Dict[str, int] = {}
        self.new_dtype: Dict[str, np.dtype] = {}
        self._build(entries)

    def _build(self, entries: Dict[str, dict]) -> None:
        N, M = self.old_world, self.new_world
        fid = rid = 0
        for prefix in sorted(entries):
            e = entries[prefix]
            sizes = e["leaf_size"]
            groups = _groups(e["leaf_dtype"])
            # element offset of member leaf j's chunk inside each rank's
            # flat group array, old and new partition alike
            off_old = {g: self._frag_offsets(sizes, idxs, N)
                       for g, idxs in groups}
            off_new = {g: self._frag_offsets(sizes, idxs, M)
                       for g, idxs in groups}
            gidx = dict(groups)
            for path in sorted(e["sharded"]):
                gkey = e["sharded"][path]
                if gkey not in gidx:
                    raise ReshardError(
                        f"manifest path {path!r} names unknown dtype group "
                        f"{gkey!r}")
                idxs = gidx[gkey]
                self.new_len[path] = [
                    sum(_span_len(sizes[i], M, d) for i in idxs)
                    for d in range(M)]
                self.new_dtype[path] = np.dtype(gkey)
                for j, i in enumerate(idxs):
                    ob = chunk_bounds(sizes[i], N)
                    nb = chunk_bounds(sizes[i], M)
                    for d in range(M):
                        nlo, nhi = nb[d]
                        if nhi <= nlo:
                            continue
                        for o in range(N):
                            olo, ohi = ob[o]
                            lo, hi = max(nlo, olo), min(nhi, ohi)
                            if hi <= lo:
                                continue
                            self.frags.append(_Frag(
                                fid=fid, path=path,
                                dtype=np.dtype(gkey),
                                old_rank=o, new_rank=d,
                                old_off=off_old[gkey][o][j] + (lo - olo),
                                new_off=off_new[gkey][d][j] + (lo - nlo),
                                length=hi - lo,
                                chunk_off=off_old[gkey][o][j],
                                chunk_len=ohi - olo,
                                leaf_pos=j, leaf_ord=i))
                            fid += 1
            for path in sorted(e.get("replicated", {})):
                info = e["replicated"][path]
                self.repl.append(_Repl(
                    rid, path, tuple(info["shape"]),
                    np.dtype(info["dtype"]),
                    e.get("repl_sha256", {}).get(path)))
                rid += 1
        self.entries = entries

    @staticmethod
    def _frag_offsets(sizes, idxs, world) -> List[List[int]]:
        """``out[rank][j]`` = element offset of member leaf ``idxs[j]``'s
        chunk inside rank's flat group array."""
        out = []
        for r in range(world):
            offs, pos = [], 0
            for i in idxs:
                offs.append(pos)
                pos += _span_len(sizes[i], world, r)
            out.append(offs)
        return out

    # -- queries -------------------------------------------------------------

    def frags_for(self, new_rank: int) -> List[_Frag]:
        return [f for f in self.frags if f.new_rank == new_rank]

    def bytes_for(self, new_rank: int) -> int:
        return sum(f.length * f.dtype.itemsize for f in self.frags
                   if f.new_rank == new_rank)

    def summary_rows(self) -> List[Tuple[int, int, int]]:
        """``(new_rank, n_fragments, bytes)`` per destination rank."""
        return [(d, len(self.frags_for(d)), self.bytes_for(d))
                for d in range(self.new_world)]

    def resolve_sources(self, visibility: Dict[int, Set[int]]
                        ) -> Dict[int, int]:
        """``{fid: serving new rank}``: the destination itself when it can
        see the old shard on disk, else the lowest-ranked peer that can —
        deterministic, so every rank derives the same push schedule.
        ``visibility[r]`` is the set of old ranks whose shard checkpoints
        rank ``r`` reported disk-visible (at the agreed step)."""
        sees: Dict[int, List[int]] = {}
        for r in sorted(visibility):
            for o in visibility[r]:
                sees.setdefault(o, []).append(r)
        out: Dict[int, int] = {}
        needed_old = sorted({f.old_rank for f in self.frags})
        missing = [o for o in needed_old if o not in sees]
        if self.repl and not sees:
            missing = needed_old or [0]
        if missing:
            raise ReshardError(
                f"no rank can see old rank(s) {missing}'s shard "
                f"checkpoint(s); resharding from world {self.old_world} "
                f"needs every old shard disk-visible to at least one "
                f"surviving rank")
        for f in self.frags:
            out[f.fid] = (f.new_rank
                          if f.old_rank in visibility.get(f.new_rank, ())
                          else sees[f.old_rank][0])
        return out

    def repl_source_old_rank(self, visibility: Dict[int, Set[int]]) -> int:
        """The old rank whose copy serves every replicated array: the
        lowest old rank anyone can see (replicated arrays are identical
        across old ranks by construction)."""
        seen = sorted({o for v in visibility.values() for o in v})
        if not seen:
            raise ReshardError("no old shard checkpoint visible to any "
                               "rank; cannot restore replicated arrays")
        return seen[0]


# ---------------------------------------------------------------------------
# npz range reads
# ---------------------------------------------------------------------------

class _ShardReader:
    """Range-reads out of one old shard checkpoint's ``arrays.npz``
    without loading the file: ``np.savez`` writes an uncompressed
    (ZIP_STORED) archive, so each member is a raw ``.npy`` at a computable
    offset — seek to ``data_start + lo * itemsize`` and read exactly the
    fragment.  Falls back to a streamed member read for compressed or
    exotic archives (still never more than one member in memory)."""

    _LOCAL_HEADER = 30  # fixed part of a zip local file header

    def __init__(self, root: str, old_rank: int, step: int):
        from .. import checkpoint
        self._setup(os.path.join(checkpoint.shard_root(root, old_rank),
                                 f"step_{step:08d}"), old_rank)

    def _setup(self, step_dir: str, label) -> None:
        """The ONE init body (both constructors share it, so a field
        added here can never be missing from ``from_dir`` readers).
        ``label`` is the old rank — or a descriptive string for
        non-shard-root readers — used in diagnostics."""
        self.old_rank = label
        self._dir = os.fspath(step_dir)
        self.path = os.path.join(self._dir, "arrays.npz")
        self._zf: Optional[zipfile.ZipFile] = None
        self._raw = None
        self._offsets: Dict[str, Tuple[int, np.dtype, int]] = {}
        self._manifest: Optional[dict] = None
        # one reader may serve BOTH the main thread's fills and the ordered
        # engine's pushes; seeks and reads on the shared file handle must
        # not interleave (RLock: read_range nests _member_layout)
        self._mu = threading.RLock()

    @classmethod
    def from_dir(cls, step_dir: str, label: str = "checkpoint"
                 ) -> "_ShardReader":
        """A reader over an arbitrary checkpoint step directory (not a
        per-rank ZeRO shard root) — the fragment range-read machinery
        applied to full checkpoints."""
        self = cls.__new__(cls)
        self._setup(step_dir, label)
        return self

    def frag_digest(self, path: str, leaf_pos: int) -> Optional[str]:
        """The sha256 THIS old rank's checkpoint recorded for member leaf
        ``leaf_pos``'s chunk of ``path`` — digests are per shard file, so
        verification must consult the source rank's own manifest, not the
        one the plan happened to be built from."""
        with self._mu:
            if self._manifest is None:
                try:
                    with open(os.path.join(self._dir, "tree.json")) as f:
                        self._manifest = (json.load(f).get("metadata", {})
                                          .get("reshard") or {})
                except (OSError, json.JSONDecodeError):
                    self._manifest = {}
            for e in (self._manifest.get("entries") or {}).values():
                digests = (e.get("frag_sha256") or {}).get(path)
                if digests is not None and leaf_pos < len(digests):
                    return digests[leaf_pos]
            return None

    def _open(self):
        if self._zf is None:
            # unbuffered: every fragment read is one read of exactly its
            # bytes (a buffered file would read ahead 8 KiB after each
            # seek — a strided shard's thousands of small fragments would
            # read several times their size)
            self._raw = open(self.path, "rb", buffering=0)
            self._zf = zipfile.ZipFile(self._raw)
        return self._zf

    def _member_layout(self, member: str) -> Tuple[int, np.dtype, int]:
        """``(data_start, dtype, n_elems)`` of an uncompressed member's
        raw array data, parsing the zip local header + npy header once."""
        cached = self._offsets.get(member)
        if cached is not None:
            return cached
        zf = self._open()
        zi = zf.getinfo(member)
        if zi.compress_type != zipfile.ZIP_STORED:
            raise ValueError("compressed member")  # caller falls back
        f = self._raw
        f.seek(zi.header_offset + 26)
        fnlen = int.from_bytes(f.read(2), "little")
        extralen = int.from_bytes(f.read(2), "little")
        npy_start = zi.header_offset + self._LOCAL_HEADER + fnlen + extralen
        f.seek(npy_start)
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if fortran:
            raise ValueError("fortran-order member")
        layout = (f.tell(), dtype, int(np.prod(shape, dtype=np.int64)))
        self._offsets[member] = layout
        return layout

    def read_range(self, path: str, elem_lo: int, elem_hi: int,
                   dtype: np.dtype) -> np.ndarray:
        """``arrays[path][elem_lo:elem_hi]`` (flat), reading only those
        bytes when the archive allows it."""
        member = path + ".npy"
        with self._mu:
            try:
                data_start, mdtype, n = self._member_layout(member)
            except (ValueError, KeyError, OSError) as e:
                if isinstance(e, KeyError):
                    raise ReshardError(
                        f"old rank {self.old_rank}'s shard checkpoint at "
                        f"{self.path!r} has no array {path!r}") from e
                return self._read_full(member, dtype)[elem_lo:elem_hi].copy()
            if mdtype != dtype:
                raise ReshardError(
                    f"old rank {self.old_rank}'s {path!r} has dtype "
                    f"{mdtype}, plan expects {dtype}")
            if elem_hi > n:
                raise ReshardError(
                    f"fragment [{elem_lo}:{elem_hi}) overruns old rank "
                    f"{self.old_rank}'s {path!r} ({n} elements)")
            f = self._raw
            f.seek(data_start + elem_lo * dtype.itemsize)
            nbytes = (elem_hi - elem_lo) * dtype.itemsize
            buf = f.read(nbytes)
        if len(buf) != nbytes:
            raise ReshardError(
                f"truncated read of {path!r} from old rank "
                f"{self.old_rank} ({len(buf)}/{nbytes} bytes)")
        return np.frombuffer(buf, dtype=dtype).copy()

    def _read_full(self, member: str, dtype: np.dtype) -> np.ndarray:
        with self._open().open(member) as m:
            version = np.lib.format.read_magic(m)
            if version == (1, 0):
                shape, _, mdtype = np.lib.format.read_array_header_1_0(m)
            else:
                shape, _, mdtype = np.lib.format.read_array_header_2_0(m)
            data = m.read()
        return np.frombuffer(data, dtype=mdtype).reshape(-1)

    def close(self) -> None:
        with self._mu:
            if self._zf is not None:
                self._zf.close()
                self._raw.close()
                self._zf = self._raw = None


# ---------------------------------------------------------------------------
# visibility + step/world agreement inputs
# ---------------------------------------------------------------------------

# path → (mtime_ns, size, recorded shard_world) for tree.jsons already
# parsed by THIS process, validated by stat on every hit: a resumed
# worker re-executing steps left behind by the previous incarnation
# OVERWRITES step dirs it may have read during its own resume (atomic
# rename ⇒ new mtime), so a never-invalidate cache would serve a stale
# world.  Keeps keep-N pruning (which calls local_visibility on every
# cadence save) at one stat per step instead of a JSON parse.
_WORLD_CACHE: Dict[str, Tuple[int, int, int]] = {}


def local_visibility(root: str) -> dict:
    """What THIS host's disk can serve: replicated steps under ``root``
    plus, per old shard root present, ``{step: recorded shard_world}``.
    The per-step world comes from each shard checkpoint's own metadata, so
    a root holding checkpoints from several incarnations (pre- and
    post-shrink) reports each step at the world it was actually saved."""
    from .. import checkpoint
    vis = {"repl": [int(s) for s in checkpoint.all_steps(root)],
           "shards": {}}
    if not os.path.isdir(root):
        return vis
    for name in sorted(os.listdir(root)):
        if not name.startswith("shard_r"):
            continue
        try:
            old_rank = int(name[len("shard_r"):])
        except ValueError:
            continue
        sroot = os.path.join(root, name)
        steps = {}
        for s in checkpoint.all_steps(sroot):
            tj = os.path.join(sroot, f"step_{s:08d}", "tree.json")
            try:
                st = os.stat(tj)
            except OSError:
                continue
            cached = _WORLD_CACHE.get(tj)
            if cached is not None and cached[:2] == (st.st_mtime_ns,
                                                     st.st_size):
                w = cached[2]
            else:
                try:
                    with open(tj) as f:
                        md = json.load(f).get("metadata", {})
                    w = int(md.get("shard_world", 0))
                except (OSError, ValueError, json.JSONDecodeError):
                    continue
                _WORLD_CACHE[tj] = (st.st_mtime_ns, st.st_size, w)
            if w > 0:
                steps[int(s)] = w
        if steps:
            vis["shards"][old_rank] = steps
    return vis


def resumable_steps(vis_list: Sequence[dict]) -> Dict[int, int]:
    """``{step: old_world}`` of steps the union of the ranks' visibility
    can serve: the replicated checkpoint exists on EVERY rank (each rank
    restores it locally) and, at the world the step's shard 0 records,
    every old shard 0..N-1 is visible *somewhere* with the same recorded
    world.  A step whose shard set records mixed worlds — a kill landed
    between a world transition's overwrites — is not resumable; the
    agreement falls back to an older complete step."""
    if not vis_list:
        return {}
    repl = set(vis_list[0].get("repl", ()))
    for v in vis_list[1:]:
        repl &= set(v.get("repl", ()))
    union: Dict[Tuple[int, int], Optional[int]] = {}
    for v in vis_list:
        for o, steps in (v.get("shards") or {}).items():
            o = int(o)
            for s, w in steps.items():
                s, w = int(s), int(w)
                prev = union.get((o, s))
                union[(o, s)] = w if prev in (None, w) else -1  # conflict
    out: Dict[int, int] = {}
    for s in repl:
        w = union.get((0, s))
        if not w or w < 0:
            continue
        if all(union.get((o, s)) == w for o in range(1, w)):
            out[s] = w
    return out


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _obs_fetch_span(src: int, path_kind: str):
    """A flight-recorder span per fragment or replicated-array fetch (disk
    or data plane): what makes a slow reshard readable in ``obs
    diagnose``."""
    from ..obs import hooks as _hooks
    return _hooks.collective_span(
        "reshard_fetch", kind="p2p", peer=src, path=path_kind)


def _read_fragment(reader: _ShardReader, frag: _Frag,
                   verify: bool, stats: ReshardStats) -> np.ndarray:
    """One fragment off disk.  With ``verify``, the whole containing old
    chunk (the digest unit) is read and checked against the manifest's
    per-fragment sha256 before slicing — the load-time defense against a
    shard corrupted after commit, at fragment granularity so an N→M
    restore never has to hash a whole shard it mostly does not want."""
    if verify:
        recorded = reader.frag_digest(frag.path, frag.leaf_pos)
        chunk = reader.read_range(frag.path, frag.chunk_off,
                                  frag.chunk_off + frag.chunk_len,
                                  frag.dtype)
        stats._alloc(chunk.nbytes)
        try:
            if recorded is None:
                raise _digest_error(
                    f"shard checkpoint of old rank {frag.old_rank} records "
                    f"no fragment digest for {frag.path!r} (leaf "
                    f"{frag.leaf_ord}); re-save with this package or pass "
                    f"verify=False")
            actual = hashlib.sha256(chunk.tobytes()).hexdigest()
            if actual != recorded:
                raise _digest_error(
                    f"fragment digest mismatch on {frag.describe()} "
                    f"(recorded sha256 {recorded[:12]}…, actual "
                    f"{actual[:12]}…) — corrupted shard fragment; refusing "
                    f"to resume divergent")
            lo = frag.old_off - frag.chunk_off
            return chunk[lo:lo + frag.length].copy()
        finally:
            stats._free(chunk.nbytes)
    a = reader.read_range(frag.path, frag.old_off,
                          frag.old_off + frag.length, frag.dtype)
    return a


def _digest_error(msg: str):
    from .. import checkpoint
    return checkpoint.DigestError(msg)


def _frag_timeout() -> float:
    try:
        return float(os.environ.get("TPU_DIST_RESHARD_TIMEOUT", "120"))
    except ValueError:
        return 120.0


def execute_plan(plan: ReshardPlan, *, rank: int, root: str, step: int,
                 visibility: Dict[int, Set[int]], dp=None,
                 verify: bool = False, timeout: Optional[float] = None
                 ) -> Tuple[Dict[str, np.ndarray], ReshardStats]:
    """Run this rank's share of the redistribution; returns the assembled
    ``{path: flat array}`` for every sharded and replicated path, and the
    stats.  A fragment is read from a disk this rank sees, or pushed by the
    rank the plan names as its source over the host data plane ``dp``
    (every source pushes what it serves, on ``dp``'s ordered engine, so disk
    reads overlap the wire; there is no request protocol).  So EVERY new
    rank must call this together whenever a fragment needs a peer.  A peer
    that does not deliver within ``timeout`` (``TPU_DIST_RESHARD_TIMEOUT``,
    120 s), or dies, raises :class:`ReshardError` naming it; without ``dp``
    such a fragment raises at once."""
    import time as _time

    from ..collectives.work import engine_for, wait_all

    timeout = _frag_timeout() if timeout is None else float(timeout)
    deadline = _time.monotonic() + timeout
    stats = ReshardStats()
    stats.old_world, stats.new_world = plan.old_world, plan.new_world
    stats.step = step
    sources = plan.resolve_sources(visibility)
    my_old = visibility.get(rank, set())
    readers: Dict[int, _ShardReader] = {}

    def reader_for(o: int) -> _ShardReader:
        r = readers.get(o)
        if r is None:
            r = readers[o] = _ShardReader(root, o, step)
        return r

    out: Dict[str, np.ndarray] = {}
    for path, lens in plan.new_len.items():
        a = np.zeros(lens[rank], dtype=plan.new_dtype[path])
        stats._alloc(a.nbytes)
        out[path] = a
    stats.new_shard_bytes = sum(a.nbytes for a in out.values())

    # replicated arrays: one source old rank, served like a whole-array
    # fragment by the lowest rank that sees it
    repl_src_old = plan.repl_source_old_rank(visibility) if plan.repl \
        else None
    repl_server = None
    if plan.repl:
        repl_server = min(r for r in sorted(visibility)
                          if repl_src_old in visibility[r])

    push_handles = []
    if dp is not None:
        engine = engine_for(dp)
        for f in plan.frags:
            if sources[f.fid] != rank or f.new_rank == rank:
                continue

            def push(f=f):
                a = _read_fragment(reader_for(f.old_rank), f, verify, stats)
                stats._alloc(a.nbytes)
                try:
                    dp.send_array(f.new_rank, _frag_tag(step, f.fid), a)
                finally:
                    stats._free(a.nbytes)
                stats.frags_pushed += 1

            push_handles.append(engine.submit(push,
                                              label=f"reshard_push/{f.fid}"))
        if repl_server == rank:
            for rp in plan.repl:
                for d in sorted(visibility):
                    if d == rank or repl_src_old in visibility.get(d, ()):
                        continue

                    def push_repl(rp=rp, d=d):
                        a = reader_for(repl_src_old).read_range(
                            rp.path, 0,
                            int(np.prod(rp.shape, dtype=np.int64)),
                            rp.dtype)
                        dp.send_array(d, _repl_tag(step, rp.rid), a)

                    push_handles.append(engine.submit(
                        push_repl, label=f"reshard_push_repl/{rp.rid}"))
    try:
        # fills: this rank's owned fragments, disk or peer
        for f in plan.frags_for(rank):
            src = sources[f.fid]
            if src == rank:
                with _obs_fetch_span(rank, "disk"):
                    a = _read_fragment(reader_for(f.old_rank), f, verify,
                                       stats)
                stats.frags_disk += 1
            else:
                a = _recv_fragment(dp, src, _frag_tag(step, f.fid), f,
                                   deadline)
                stats.frags_peer += 1
            stats._alloc(a.nbytes)
            stats.frag_bytes_max = max(stats.frag_bytes_max, a.nbytes)
            if a.size != f.length or a.dtype != f.dtype:
                raise ReshardError(
                    f"fragment {f.describe()} arrived as {a.size} x "
                    f"{a.dtype}, expected {f.length} x {f.dtype}")
            out[f.path][f.new_off:f.new_off + f.length] = a
            stats._free(a.nbytes)
            stats.frags_total += 1
            stats.bytes_total += a.nbytes
        for rp in plan.repl:
            n = int(np.prod(rp.shape, dtype=np.int64))
            if repl_src_old in my_old:
                with _obs_fetch_span(rank, "disk"):
                    a = reader_for(repl_src_old).read_range(rp.path, 0, n,
                                                            rp.dtype)
                if verify and rp.sha256:
                    actual = hashlib.sha256(
                        np.ascontiguousarray(a).tobytes()).hexdigest()
                    if actual != rp.sha256:
                        raise _digest_error(
                            f"replicated array {rp.path!r} digest mismatch "
                            f"(recorded {rp.sha256[:12]}…, actual "
                            f"{actual[:12]}…)")
            else:
                a = _recv_repl(dp, repl_server, _repl_tag(step, rp.rid), rp,
                               deadline)
            out[rp.path] = np.asarray(a, dtype=rp.dtype).reshape(rp.shape)
        if push_handles:
            wait_all(push_handles, max(0.1, deadline - _time.monotonic()))
    finally:
        for r in readers.values():
            r.close()
    return out, stats


def _frag_tag(step: int, fid: int) -> str:
    return f"rshd/s{step}/f{fid}"


def _repl_tag(step: int, rid: int) -> str:
    return f"rshd/s{step}/r{rid}"


def _recv_fragment(dp, src: int, tag: str, f: _Frag, deadline: float):
    import time as _time
    if dp is None:
        raise ReshardError(
            f"fragment {f.describe()} lives only on rank {src}'s disk and "
            f"no data plane is available for the peer fetch")
    left = max(0.1, deadline - _time.monotonic())
    try:
        with _obs_fetch_span(src, "dataplane"):
            return dp.recv_array(src, tag, timeout=left)
    except TimeoutError as e:
        raise ReshardError(
            f"peer rank {src} did not deliver fragment {f.describe()} "
            f"within {left:.0f}s — peer dead or its disk read stalled"
        ) from e
    except ConnectionError as e:  # PeerGoneError names the peer
        raise ReshardError(
            f"peer rank {src} died while serving fragment "
            f"{f.describe()}: {e}") from e


def _recv_repl(dp, src: int, tag: str, rp: _Repl, deadline: float):
    import time as _time
    if dp is None:
        raise ReshardError(
            f"replicated array {rp.path!r} lives only on rank {src}'s "
            f"disk and no data plane is available for the peer fetch")
    left = max(0.1, deadline - _time.monotonic())
    try:
        with _obs_fetch_span(src, "dataplane"):
            return dp.recv_array(src, tag, timeout=left)
    except TimeoutError as e:
        raise ReshardError(
            f"peer rank {src} did not deliver replicated array "
            f"{rp.path!r} within {left:.0f}s") from e
    except ConnectionError as e:
        raise ReshardError(
            f"peer rank {src} died while serving replicated array "
            f"{rp.path!r}: {e}") from e


# ---------------------------------------------------------------------------
# template-driven restore (the TrainState entry point)
# ---------------------------------------------------------------------------

def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def load_manifest(root: str, step: int, old_rank: int) -> Optional[dict]:
    """The reshard manifest recorded in old ``old_rank``'s shard
    checkpoint at ``step`` (None when absent/unreadable)."""
    from .. import checkpoint
    p = os.path.join(checkpoint.shard_root(root, old_rank),
                     f"step_{step:08d}", "tree.json")
    try:
        with open(p) as f:
            return json.load(f).get("metadata", {}).get("reshard")
    except (OSError, json.JSONDecodeError):
        return None


def reshard_restore(root: str, template: Any, step: int,
                    shard: Tuple[int, int], *, manifest: Optional[dict] = None,
                    visibility: Optional[Dict[int, Set[int]]] = None,
                    dp=None, verify: bool = False,
                    timeout: Optional[float] = None):
    """Restore ``template``'s structure at ``shard=(rank, new_world)``
    from shard checkpoints saved at a *different* world size, fetching
    only the fragments this rank will own.  Returns ``(tree, stats)``.

    ``template`` must be the new-world state (e.g. a fresh
    ``ZeroOptimizer.init`` at world M): its ``meta`` subtrees — the new
    layout pins — are kept verbatim; every other path is assembled from
    old-shard fragments (sharded paths) or copied from one old rank
    (replicated paths), each leaf returned as the template's kind (a
    tensor on the template leaf's device, or numpy).  ``visibility`` maps
    each new rank to the old shard roots it can read (default: everything
    locally visible, the shared-filesystem case).
    """
    from .. import checkpoint
    rank, new_world = int(shard[0]), int(shard[1])
    if manifest is None:
        vis_here = local_visibility(root)
        for o in sorted(vis_here["shards"]):
            if step in vis_here["shards"][o]:
                manifest = load_manifest(root, step, o)
                if manifest is not None:
                    break
    if manifest is None:
        raise ReshardError(
            f"no reshard manifest for step {step} under {root!r}: the "
            f"shard checkpoints predate elastic resharding (or none are "
            f"visible here) — re-save with this package, or resume at "
            f"the original world size")
    plan = ReshardPlan(manifest, new_world)
    if visibility is None:
        here = {o for o, steps in local_visibility(root)["shards"].items()
                if steps.get(step) == plan.old_world}
        visibility = {r: set(here) for r in range(new_world)}

    flat_t = checkpoint._flatten(template)
    known = set(plan.new_len) | {rp.path for rp in plan.repl}
    meta_paths = {p for p in flat_t
                  if any(p.startswith(prefix + _META_SEG)
                         for prefix in plan.entries)}
    missing = sorted(set(flat_t) - known - meta_paths)
    extra = sorted(known - set(flat_t))
    if missing or extra:
        raise ReshardError(
            f"template does not match the shard manifest: template-only="
            f"{missing[:4]}{'…' if len(missing) > 4 else ''} manifest-only="
            f"{extra[:4]}{'…' if len(extra) > 4 else ''} — the parameter "
            f"structure changed since the checkpoint was saved")
    for path, lens in plan.new_len.items():
        t = flat_t[path]
        tshape = _shape(t)
        if tshape != (lens[rank],):
            raise ReshardError(
                f"template path {path!r} has shape {tshape}, the world-"
                f"{new_world} plan owns {lens[rank]} elements — template "
                f"built at the wrong world or from different parameters")

    from ..obs import hooks as _hooks
    with _hooks.collective_span("reshard", path="dataplane"
                                if dp is not None else "disk"):
        arrays, stats = execute_plan(plan, rank=rank, root=root, step=step,
                                     visibility=visibility, dp=dp,
                                     verify=verify, timeout=timeout)

    out = {}
    for path, tleaf in flat_t.items():
        if path in meta_paths:
            out[path] = tleaf
            continue
        a = arrays[path]
        tname = checkpoint._dtype_name(tleaf)
        if str(a.dtype) != tname:
            raise ReshardError(
                f"resharded {path!r} has dtype {a.dtype}, template wants "
                f"{tname}")
        out[path] = checkpoint._from_host(
            a.reshape(_shape(tleaf)), tname, tleaf,
            tleaf.device if hasattr(tleaf, "device") else None)
    return checkpoint._unflatten(template, out), stats


# ---------------------------------------------------------------------------
# supervisor-facing summary
# ---------------------------------------------------------------------------

def plan_summary(manifest: dict, new_world: int) -> str:
    """Multi-line human summary of an N→``new_world`` plan — the
    supervisor prints this next to the last-known-positions table when it
    re-forms an elastic world, so the operator sees the redistribution
    before the new gang starts fetching."""
    plan = ReshardPlan(manifest, new_world)
    lines = [f"reshard plan: world {plan.old_world} -> {plan.new_world} "
             f"({len(plan.frags)} fragments, "
             f"{sum(f.length * f.dtype.itemsize for f in plan.frags)} B "
             f"+ {len(plan.repl)} replicated arrays)"]
    for d, n, b in plan.summary_rows():
        lines.append(f"  new rank {d}: {n} fragments, {b} B "
                     f"(disk when the old shard roots are visible, "
                     f"else peer fetch)")
    return "\n".join(lines)
