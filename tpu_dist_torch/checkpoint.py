"""Checkpoint / resume — counterpart of ``tpu_dist/checkpoint.py``, in the JAX
package's format.

Each checkpoint is a directory ``<root>/step_{step:08d}`` holding

- ``tree.json`` — ``step``, ``leaves`` (each key path's shape and dtype),
  the user ``metadata``, ``arrays_sha256`` (the digest of ``arrays.npz``)
  and ``format_version: 1``;
- ``arrays.npz`` — the leaf arrays, keyed by flattened path.

Key paths are spelled as ``jax.tree_util.keystr`` spells them: ``['k']`` for
a dict key (dicts flatten in sorted key order, as in JAX), ``[i]`` for a
list or tuple index and ``.name`` for a NamedTuple field — a
:class:`~tpu_dist_torch.parallel.TrainState` gives ``.params['fc.weight']``,
``.opt_state['m']['fc.weight']``, ``.step`` and ``.rng``.  So a directory
written by either package restores in the other for a tree of the same
structure and dtypes.  Leaves are tensors, numpy arrays or Python scalars
(``None`` is an empty subtree).  numpy has no bfloat16: a bfloat16 leaf is
written as 2-byte voids with ``"bfloat16"`` in ``tree.json``, as the JAX
package writes it (its ``.npy`` header reads ``<V2``, the port's ``|V2``;
numpy loads both as ``V2``), and read back by the dtype ``tree.json``
records.

Writes are atomic (a temporary directory, every file and the directory
fsync'd, then renamed, and the parent fsync'd) and step-numbered; only rank
0 of the default group writes, every rank restores.  ``shard=(rank,
world)`` writes rank-sharded state: every rank its own tree under
:func:`shard_root`, its coordinates in the metadata and, when the tree
holds ZeRO layout metadata, the JAX package's **reshard manifest**
(``tree.json``'s ``metadata.reshard``: leaf sizes and dtypes, which arrays
are sharded, a sha256 per fragment), so a sharded checkpoint of either
package restores at another world size in either
(``resilience/reshard.py``).  :func:`prune_sharded` prunes such a tree on
completeness.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "all_steps", "shard_root",
           "prune_sharded", "devices", "DigestError", "AsyncCheckpointer",
           "GracefulShutdown"]

_STEP_DIR = re.compile(r"^step_(\d{8})$")
_BF16 = "bfloat16"
_VOID2 = np.dtype("V2")


class DigestError(ValueError):
    """A checkpoint failed sha256 verification against the digest recorded
    at save time: truncated, bit-rotted, or tampered — refusing to load is
    always better than resuming divergent."""


# ---------------------------------------------------------------------------
# trees: key paths in jax.tree_util.keystr's spelling
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    """``[(key entry, child), ...]`` of a container, or ``None`` for a
    leaf."""
    if isinstance(x, dict):
        return [(f"[{k!r}]", x[k]) for k in sorted(x)]
    if _is_namedtuple(x):
        return [(f".{f}", getattr(x, f)) for f in x._fields]
    if isinstance(x, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(x)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{key path: leaf}`` in JAX's flatten order."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, child in kids:
        out.update(_flatten(child, prefix + key))
    return out


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf replaced by ``leaves[path]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves,
                                           f"{prefix}.{f}")
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return leaves[prefix]


def devices(tree):
    """Each tensor leaf's device (the CPU for other leaves) in ``tree``'s
    structure: ``restore(root, state, device=devices(state))`` puts every
    restored leaf where the template's lives (the port's counterpart of the
    JAX package's ``ddp.state_shardings(state)``)."""
    cpu = torch.device("cpu")
    return _unflatten(tree, {k: v.device if isinstance(v, torch.Tensor)
                             else cpu for k, v in _flatten(tree).items()})


# ---------------------------------------------------------------------------
# leaves on the host
# ---------------------------------------------------------------------------

def _dtype_name(leaf) -> str:
    """The dtype ``tree.json`` records for a leaf (numpy's name, or
    ``bfloat16``)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _to_host(leaf, own: bool = False) -> np.ndarray:
    """A leaf as a numpy array (a bfloat16 tensor as 2-byte voids).  With
    ``own`` the array owns its memory: a CPU tensor's ``.numpy()`` and a
    numpy leaf would otherwise share it with the caller, who may update it
    in place while an asynchronous write still reads it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()  # a copy nobody else holds
        elif own:
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_VOID2)
        return t.numpy()
    a = np.asarray(leaf)
    return a.copy() if own and (a is leaf or not a.flags.owndata) else a


def _from_host(a: np.ndarray, dtype_name: str, tleaf, device):
    """A stored array as the template leaf's kind: a tensor (on ``device``,
    else the CPU; requiring grad where the template's does), a numpy array,
    or a Python scalar."""
    a = np.require(a, requirements="C")  # keeps a 0-d array 0-d
    if dtype_name == _BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif isinstance(tleaf, torch.Tensor):
        t = torch.from_numpy(a)
    elif isinstance(tleaf, (bool, int, float)):
        return type(tleaf)(a.item())
    else:
        return a
    if device is not None:
        t = t.to(device)
    # a parameter's leaf comes back as a leaf that autograd differentiates
    return t.requires_grad_(isinstance(tleaf, torch.Tensor)
                            and tleaf.requires_grad)


def _is_rank0() -> bool:
    return (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def shard_root(root: str, rank: int) -> str:
    """The per-rank checkpoint root for rank-sharded state:
    ``<root>/shard_r{rank:03d}``.  Each rank owns its directory outright, so
    the atomic tmp+rename machinery applies unchanged and ranks never race
    on one ``arrays.npz``."""
    return os.path.join(root, f"shard_r{int(rank):03d}")


def _host_arrays(tree, own: bool = False):
    flat = _flatten(tree)
    return ({k: _to_host(v, own) for k, v in flat.items()},
            {k: _dtype_name(v) for k, v in flat.items()})


def save(root: str, tree: Any, step: int, metadata: Optional[Dict] = None,
         keep: Optional[int] = None,
         shard: Optional[tuple] = None) -> str:
    """Write checkpoint ``root/step_{step:08d}``; returns its path.

    ``keep=N`` prunes to the newest N step directories after a successful
    write.  Only rank 0 of the default process group writes; the other
    ranks return the path without touching the disk.  ``shard=(rank,
    world)`` writes rank-sharded state: EVERY rank writes its own tree
    under :func:`shard_root`, with the shard coordinates recorded in the
    metadata (:func:`restore` refuses a mismatch)."""
    if shard is not None:
        rank, world = int(shard[0]), int(shard[1])
        sroot = shard_root(root, rank)
        path = os.path.join(sroot, f"step_{step:08d}")
        meta = dict(metadata or {})
        meta["shard_rank"], meta["shard_world"] = rank, world
        arrays, dtypes = _host_arrays(tree)
        from .resilience.reshard import manifest_from_arrays
        manifest = manifest_from_arrays(arrays)
        if manifest is not None:
            meta["reshard"] = manifest
        _write(sroot, path, arrays, dtypes, step, meta, keep)
        return path
    path = os.path.join(root, f"step_{step:08d}")
    if not _is_rank0():
        return path
    _write(root, path, *_host_arrays(tree), step, metadata, keep)
    return path


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write(root: str, path: str, arrays: Dict[str, np.ndarray],
           dtypes: Dict[str, str], step: int, metadata: Optional[Dict],
           keep: Optional[int]) -> None:
    """Serialize host arrays to ``path`` (atomic tmp+rename), then prune to
    the newest ``keep`` step directories.  Pure host I/O — safe to run
    off-thread (the AsyncCheckpointer's worker).

    Durability: both files and the tmp dir are fsync'd before the rename,
    and the parent dir after — without that, a host crash can surface a
    "committed" (renamed) checkpoint whose data blocks never hit disk.  The
    npz's sha256 rides in tree.json so :func:`restore` can verify."""
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_ckpt_")
    try:
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **arrays)
        meta = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                       for k, a in arrays.items()},
            "metadata": metadata or {},
            "arrays_sha256": _sha256_file(npz_path),
            "format_version": 1,
        }
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(npz_path)
        _fsync_path(tmp)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        _fsync_path(root)  # persist the rename itself
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep is not None:
        for s in all_steps(root)[:-keep]:
            shutil.rmtree(os.path.join(root, f"step_{s:08d}"),
                          ignore_errors=True)


class AsyncCheckpointer:
    """Background checkpoint writer — the step loop never blocks on disk.

    ``save()`` copies the tree to host memory it owns in the caller (a
    card tensor's copy to the host; a CPU tensor or numpy leaf cloned,
    since the port's ``train_step`` updates its state in place while the
    write may still be reading it), then serialization, the atomic rename
    and pruning run on one worker thread.

    One write in flight at a time: a new ``save`` first joins the previous
    one (at most two host copies of the state alive), and a worker
    exception re-raises there, in ``wait()``, or in ``close()``.  Use as a
    context manager so the last write lands::

        with AsyncCheckpointer(root, keep=3) as ckpt:
            for step in range(n):
                state, _ = ddp.train_step(state, x, y)
                if step % 100 == 0:
                    ckpt.save(state, step=step)

    The directories are :func:`save`'s (restore with :func:`restore`)."""

    def __init__(self, root: str, keep: Optional[int] = None):
        from concurrent.futures import ThreadPoolExecutor
        self.root = root
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="tpu_dist-ckpt")
        self._inflight = None

    def save(self, tree: Any, step: int,
             metadata: Optional[Dict] = None) -> str:
        """Queue ``root/step_{step:08d}``; returns its (future) path.

        Blocks only for (a) the previous write, if still running, and (b)
        the copy of ``tree`` to host memory.  Ranks other than 0 return
        without queuing I/O, like :func:`save`."""
        path = os.path.join(self.root, f"step_{step:08d}")
        if self._pool is None:
            raise RuntimeError("AsyncCheckpointer is closed")
        # tpudlint: disable=TD004  # local async-write join, no remote peer
        self.wait()  # one in-flight write; surfaces previous write errors
        if not _is_rank0():
            return path
        arrays, dtypes = _host_arrays(tree, own=True)
        self._inflight = self._pool.submit(
            _write, self.root, path, arrays, dtypes, step, metadata,
            self.keep)
        return path

    def wait(self) -> None:
        """Join the in-flight write; re-raises its exception if it failed."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def close(self) -> None:
        """Finish the in-flight write and shut the worker down."""
        if self._pool is not None:
            try:
                # tpudlint: disable=TD004  # local async-write join
                self.wait()
            finally:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def all_steps(root: str):
    """Sorted list of checkpointed step numbers under ``root``."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = _STEP_DIR.match(name)
        if m and os.path.exists(os.path.join(root, name, "tree.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = all_steps(root)
    return steps[-1] if steps else None


def prune_sharded(root: str, keep: int) -> list:
    """Prune a sharded checkpoint tree (the replicated root and every
    ``shard_r*`` root) to the newest ``keep`` **complete** steps; returns
    the pruned step numbers.  A step is complete when the replicated
    checkpoint and, at the world its own shard metadata records, every
    shard 0..world-1 are present (``reshard.resumable_steps``); every step
    older than the ``keep``-th newest complete one goes, complete or not,
    and newer incomplete steps stay for their writers to finish.  Per-root
    pruning could delete the one older step still complete everywhere, the
    step the resume agreement would pick.  With private per-host disks the
    local view never proves a step complete, so nothing is pruned."""
    from .resilience.reshard import local_visibility, resumable_steps
    complete = sorted(resumable_steps([local_visibility(root)]))
    if keep is None or len(complete) <= max(int(keep), 0):
        return []
    cutoff = complete[-int(keep)]
    roots = [root]
    if os.path.isdir(root):
        roots += [os.path.join(root, name)
                  for name in sorted(os.listdir(root))
                  if name.startswith("shard_r")
                  and os.path.isdir(os.path.join(root, name))]
    pruned = set()
    for r in roots:
        for s in all_steps(r):
            if s < cutoff:
                shutil.rmtree(os.path.join(r, f"step_{s:08d}"),
                              ignore_errors=True)
                pruned.add(s)
    return sorted(pruned)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def restore(root: str, template: Any, step: Optional[int] = None,
            device=None, verify: bool = False,
            shard: Optional[tuple] = None) -> Any:
    """Load a checkpoint into the structure of ``template``.

    ``step=None`` loads the latest.  Each leaf comes back as the template
    leaf's kind — a tensor (requiring grad where the template's does, so a
    restored state's parameters train), a numpy array or a Python scalar —
    with the dtype ``tree.json`` records, which must be the template's.  ``device``
    places the tensor leaves (it takes the place of the JAX package's
    ``sharding=``): one device for every leaf, or a tree of devices with
    the template's structure for per-leaf placement (:func:`devices` of
    the template puts each where the template's lives).  The default leaves
    them on the CPU.  The leaves are new tensors; the template is
    only read.  ``verify=True`` recomputes ``arrays.npz``'s sha256 against
    the digest recorded at save time before deserializing.

    ``shard=(rank, world)`` loads this rank's rank-sharded state (see
    :func:`save`): the recorded shard coordinates must match exactly.

    Raises with a precise message when the tree structure or a leaf
    shape/dtype does not match the template — resuming into a changed model
    must fail loudly, not load garbage."""
    if shard is not None:
        root = shard_root(root, int(shard[0]))
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root!r}")
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    if shard is not None:
        rank, world = int(shard[0]), int(shard[1])
        rec = meta.get("metadata", {})
        got = (rec.get("shard_rank"), rec.get("shard_world"))
        if got != (rank, world):
            raise ValueError(
                f"sharded checkpoint at {path!r} was saved as rank "
                f"{got[0]} of world {got[1]}, but this process is rank "
                f"{rank} of world {world}.  Direct restore is exact-match "
                f"only; a different world size resumes through elastic "
                f"resharding (resilience.TrainState.resume, or "
                f"resilience.reshard.reshard_restore).")
    npz_path = os.path.join(path, "arrays.npz")
    if verify:
        recorded = meta.get("arrays_sha256")
        if recorded is None:
            raise ValueError(
                f"checkpoint at {path!r} records no arrays digest; re-save "
                f"it or pass verify=False")
        actual = _sha256_file(npz_path)
        if actual != recorded:
            raise DigestError(
                f"checkpoint at {path!r} failed digest verification "
                f"(recorded sha256 {recorded[:12]}…, actual {actual[:12]}…) "
                f"— truncated or corrupted; refusing to load")
    with np.load(npz_path) as npz:
        arrays = {k: npz[k] for k in npz.files}

    flat_t = _flatten(template)
    missing = sorted(set(flat_t) - set(arrays))
    extra = sorted(set(arrays) - set(flat_t))
    if missing or extra:
        raise ValueError(
            f"checkpoint at {path!r} does not match template: "
            f"missing={missing[:5]}{'…' if len(missing) > 5 else ''} "
            f"extra={extra[:5]}{'…' if len(extra) > 5 else ''}")
    recorded = meta["leaves"]
    for k, tleaf in flat_t.items():
        tshape = tuple(tleaf.shape) if hasattr(tleaf, "shape") else ()
        if tuple(arrays[k].shape) != tshape:
            raise ValueError(
                f"checkpoint leaf {k!r} shape {arrays[k].shape} != template "
                f"{tshape}")
        tdtype = _dtype_name(tleaf)
        got = recorded[k]["dtype"]
        stored = _VOID2 if got == _BF16 else np.dtype(got)
        if arrays[k].dtype != stored:
            raise ValueError(
                f"checkpoint leaf {k!r} is stored as {arrays[k].dtype}, "
                f"but tree.json records {got}")
        if got != tdtype:
            raise ValueError(
                f"checkpoint leaf {k!r} dtype {got} != template "
                f"{tdtype}; cast the template (or re-save) explicitly "
                f"rather than loading silently converted values")

    if device is None or isinstance(device, (str, torch.device)):
        flat_d = {k: device for k in flat_t}
    else:
        # a tree of devices, or of the DDP's state_shardings placements
        flat_d = {k: getattr(d, "device", d)
                  for k, d in _flatten(device).items()}
        missing = sorted(set(flat_t) - set(flat_d))
        if missing:
            raise ValueError(f"device tree does not match template: "
                             f"missing={missing[:5]}")
    return _unflatten(template, {
        k: _from_host(arrays[k], recorded[k]["dtype"], tleaf, flat_d[k])
        for k, tleaf in flat_t.items()})


class GracefulShutdown:
    """Preemption-safe training: save on SIGTERM, exit cleanly, resume.

    A handler cannot safely copy device state from signal context, so this
    follows the flag pattern: the handler only records the request, the
    step loop checks it at the next iteration boundary and saves::

        with GracefulShutdown() as stop, \\
             AsyncCheckpointer(root, keep=3) as ckpt:
            for step in range(start, n):
                state, _ = ddp.train_step(state, x, y)
                if stop.requested:
                    ckpt.save(state, step=step)
                    break          # the restarted job restores the latest

    Installed handlers are restored on exit; entering from a non-main
    thread raises (Python only delivers signals to the main thread)."""

    def __init__(self, signals=None):
        import signal as _signal
        self._signal = _signal
        # SIGTERM only by default: capturing SIGINT would make Ctrl-C
        # unable to break out of a step hung inside a collective (the flag
        # is only read at loop boundaries).  Opt in explicitly with
        # ``signals=(SIGTERM, SIGINT)`` for non-interactive jobs.
        self.signals = tuple(signals) if signals is not None else (
            _signal.SIGTERM,)
        self._previous = {}
        self.requested = False
        self.signum = None

    def _handler(self, signum, frame):
        self.requested = True
        self.signum = signum

    def __enter__(self):
        try:
            for s in self.signals:
                self._previous[s] = self._signal.signal(s, self._handler)
        except BaseException:
            self.__exit__()  # restore the handlers already installed
            raise
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            self._signal.signal(s, prev)
        self._previous.clear()
        return False
