"""Auto-resume — counterpart of ``tpu_dist/resilience/state.py``: the
two-call hook that makes a training loop restartable.

:class:`TrainState` here is the *manager* of a state tree (a dict of
tensors, or a :class:`tpu_dist_torch.parallel.TrainState`), not the tree
itself: it owns the checkpoint cadence over :mod:`tpu_dist_torch.
checkpoint`, restores ``latest`` after a supervised restart (each tensor
back on the device its template leaf lives on), publishes heartbeat
progress, and runs any installed chaos faults at step boundaries.  The
store keys, checkpoint layout and resume rules are the JAX package's.  A
loop becomes elastic with::

    with resilience.TrainState(ckpt_root, save_every=100) as ts:
        state, start = ts.resume(state)          # fresh run -> (state, 0)
        for step in range(start, num_steps):
            state, metrics = ddp.train_step(state, *batch(step))
            ts.end_step(state, step)             # beat + periodic save

Run it under ``python -m tpu_dist_torch.launch --max_restarts=N
--heartbeat_timeout=T`` and a killed/preempted/hung rank tears the gang
down, the supervisor re-rendezvouses the next generation, and every rank
resumes from the last checkpoint — with a loss trajectory identical to an
uninterrupted run as long as the data pipeline is keyed on ``step``
(deterministic resume is asserted bit-for-bit by the chaos e2e tests).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

from . import chaos as _chaos
from .heartbeat import Heartbeat, HeartbeatMonitor, RankLostError

__all__ = ["TrainState"]

RANK_LOST_EXIT_CODE = 113  # worker self-aborted on a peer's lost heartbeat


def _shards_at(vis: dict, step: int, world: int) -> set:
    """Old ranks whose shard checkpoint at ``step`` (recorded at exactly
    ``world``) one rank's visibility dict can serve.  Keys arrive as ints
    locally and as strings after the store's JSON round-trip — normalize
    both."""
    out = set()
    for o, steps in (vis.get("shards") or {}).items():
        for s, w in steps.items():
            if int(s) == step and int(w) == world:
                out.add(int(o))
    return out


def _strip_leaf_dtype(tree):
    """``(copy, found)`` with every ``meta['leaf_dtype']`` pin removed —
    the restore template shape of a PRE-elastic shard checkpoint (saved
    before the dtype pin existed)."""
    if isinstance(tree, dict):
        out, found = {}, False
        for k, v in tree.items():
            if k == "meta" and isinstance(v, dict) and "leaf_dtype" in v:
                out[k] = {m: x for m, x in v.items() if m != "leaf_dtype"}
                found = True
            else:
                out[k], f = _strip_leaf_dtype(v)
                found = found or f
        return out, found
    return tree, False


def _reinsert_leaf_dtype(got, tmpl):
    """Graft the template's freshly computed ``meta['leaf_dtype']`` back
    into a tree restored without it (the pin is a pure function of the
    params at this world, so the template's value IS the right one)."""
    if isinstance(got, dict) and isinstance(tmpl, dict):
        out = {}
        for k, v in got.items():
            t = tmpl.get(k)
            if (k == "meta" and isinstance(v, dict)
                    and isinstance(t, dict) and "leaf_dtype" in t
                    and "leaf_dtype" not in v):
                v = dict(v)
                v["leaf_dtype"] = t["leaf_dtype"]
                out[k] = v
            else:
                out[k] = _reinsert_leaf_dtype(v, t)
        return out
    return got


class TrainState:
    """Checkpoint + heartbeat + chaos lifecycle for one training run.

    Args:
        root: checkpoint directory (shared across ranks on multi-host —
            only process 0 writes; see :func:`tpu_dist_torch.checkpoint.
            save`).
        save_every: checkpoint every N steps (steps where
            ``step % save_every == 0``); 0 disables periodic saves.
        keep: prune to the newest N checkpoints (None keeps all).
        verify: digest-check ``arrays.npz`` on restore (detects a
            truncated/corrupt checkpoint from a crash mid-write).
        heartbeat: publish liveness/progress when the control-plane store
            is reachable (``TPU_DIST_STORE_ADDR``); harmless no-op without.
        monitor: also watch the *other* ranks and abort this process with
            a named :class:`RankLostError` when one goes silent.  Default
            (None): enabled on rank 0 when the launcher exported
            ``TPU_DIST_HEARTBEAT_TIMEOUT`` (``--heartbeat_timeout``).
        metadata: extra dict stored in every checkpoint's ``tree.json``.
        shard: ``(rank, world)`` of this process — required with
            ``sharded_keys``.
        sharded_keys: top-level keys of the state dict that hold
            **rank-sharded** state (ZeRO optimizer shards,
            tpu_dist_torch/parallel/zero.py).  Those subtrees differ per rank by
            design: each rank checkpoints its own copy under
            ``checkpoint.shard_root(root, rank)`` while the rest of the
            state stays in the shared replicated checkpoint; ``resume``
            restores both at one agreed step (ranks exchange what their
            disks can serve through the control-plane store and settle on
            the newest step the union can serve everywhere).  Sharded
            checkpoints are **world-size-portable**: when the agreed
            step was saved at a different world size — an elastic
            shrink/grow restart — ``resume`` reshards it through
            :mod:`~tpu_dist_torch.resilience.reshard` (each rank fetches only
            the fragments it will own, from disk) into the fresh state the
            caller built at the new world.
    """

    def __init__(self, root: str, save_every: int = 100,
                 keep: Optional[int] = 3, verify: bool = False,
                 heartbeat: bool = True,
                 heartbeat_interval: float = 1.0,
                 monitor: Optional[bool] = None,
                 metadata: Optional[Dict] = None,
                 shard: Optional[Tuple[int, int]] = None,
                 sharded_keys: Sequence[str] = ()):
        _chaos.install_from_env()
        self.root = root
        self.save_every = save_every
        self.keep = keep
        self.verify = verify
        self.metadata = metadata
        self.shard = (int(shard[0]), int(shard[1])) if shard else None
        self.sharded_keys = tuple(sharded_keys)
        if self.sharded_keys and self.shard is None:
            raise ValueError("sharded_keys needs shard=(rank, world)")
        self._hb: Optional[Heartbeat] = None
        self._prune_stall_warned = False
        self._monitor: Optional[HeartbeatMonitor] = None
        self._monitor_store = None  # dedicated client; closed in close()
        if heartbeat:
            try:
                self._hb = Heartbeat(interval=heartbeat_interval).start()
            except Exception:
                self._hb = None
        self._maybe_start_monitor(monitor)
        self._publish_ckpt_root()

    def _publish_ckpt_root(self) -> None:
        """Tell the supervisor where the checkpoints live (best-effort):
        on an elastic world change it reads this back to print the
        resharding plan summary next to the restart log — pure
        diagnostics, never load-bearing."""
        try:
            from .heartbeat import _store_from_env
            store = _store_from_env()
            if store is None:
                return
            try:
                store.set("tpu_dist/elastic/ckpt_root",
                          os.path.abspath(self.root).encode())
            finally:
                store.close()
        except Exception:
            pass

    def _maybe_start_monitor(self, monitor: Optional[bool]) -> None:
        timeout = float(os.environ.get("TPU_DIST_HEARTBEAT_TIMEOUT", "0")
                        or 0)
        rank = int(os.environ.get("RANK", "0") or 0)
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if monitor is None:
            monitor = timeout > 0 and rank == 0
        if not monitor or world <= 1:
            return
        if timeout <= 0:
            timeout = 30.0
        try:
            from .heartbeat import _store_from_env
            store = _store_from_env()
            if store is None:
                return
            peers = [r for r in range(world) if r != rank]
            self._monitor_store = store
            self._monitor = HeartbeatMonitor(
                store, world, timeout=timeout, ranks=peers)
            self._monitor.watch(self._on_lost)
        except Exception:
            self._monitor = None

    def _on_lost(self, err: RankLostError) -> None:
        # Another thread cannot raise into a main thread stuck in an eager
        # collective; the actionable conversion of the hang is a named
        # abort — the supervisor reaps it and (with --max_restarts) the
        # next generation resumes from `latest`.
        from ..dist import abort
        from ..utils.logging import log_event
        log_event("rank-lost", error=str(err))
        abort(RANK_LOST_EXIT_CODE, reason=str(err))

    # -- checkpoint lifecycle ------------------------------------------------
    def resume(self, state: Any) -> Tuple[Any, int]:
        """``(state, start_step)``: restore the latest checkpoint if one
        exists (returning its step + 1), else pass ``state`` through with
        start 0.

        With ``sharded_keys``, ranks exchange their local disk visibility
        through the control-plane store and settle on the newest step the
        union can serve (replicated checkpoint on every rank + every old
        shard visible somewhere, at one consistent recorded world).  When
        that step was saved at this very (rank, world) and this rank's own
        shard is local, it restores directly; otherwise — an elastic
        shrink/grow restart, or shards living on a peer's disk — the
        sharded subtrees are **resharded** into ``state``'s fresh
        new-world layout, each rank fetching only the fragments it will
        own (:func:`~tpu_dist_torch.resilience.reshard.reshard_restore`)."""
        from .. import checkpoint
        from ..dist.rendezvous import generation
        from ..utils.logging import log_event
        if not self.sharded_keys:
            last = checkpoint.latest_step(self.root)
            if last is None:
                return state, 0
            restored = checkpoint.restore(self.root, state, step=last,
                                          verify=self.verify,
                                          device=checkpoint.devices(state))
            log_event("auto-resume", step=last, generation=generation())
            return restored, last + 1

        if not isinstance(state, dict):
            raise TypeError("sharded_keys needs a dict state at top level")
        from . import reshard
        rank, world = self.shard
        vis = reshard.local_visibility(self.root)
        all_vis, exchanged = self._exchange_visibility(vis)
        steps = reshard.resumable_steps(all_vis)
        if not steps and not exchanged:
            # storeless rig whose disks are NOT shared: the assumed-shared
            # view found nothing, but this rank's own pieces (replicated +
            # its shard at this very world) may still be here — the
            # pre-elastic local rule.  Elastic changes need the store;
            # fixed-world resume must keep working without it.
            repl = set(vis.get("repl", ()))
            steps = {s: world
                     for s, w in (vis.get("shards") or {})
                     .get(rank, {}).items()
                     if int(w) == world and int(s) in repl}
        if not steps:
            return state, 0
        last = max(steps)
        old_world = steps[last]
        repl_tmpl = {k: v for k, v in state.items()
                     if k not in self.sharded_keys}
        shard_tmpl = {k: state[k] for k in self.sharded_keys}
        restored = dict(checkpoint.restore(
            self.root, repl_tmpl, step=last, verify=self.verify,
            device=checkpoint.devices(repl_tmpl)))
        # The exact-match shortcut must be a GLOBAL decision when the
        # views were exchanged: execute_plan requires every rank to run
        # it together whenever any fragment needs the peer path, so one
        # rank may only skip the reshard when EVERY rank's own shard is
        # on its own disk — decided from the exchanged views, which all
        # ranks hold identically.  Deciding per-rank from local
        # visibility would let the lucky ranks return early while a rank
        # missing its shard blocks on pushes that never come, then
        # blames a live peer for the timeout.  Storeless (no exchange,
        # all_vis is this rank's view replicated) the decision stays
        # local as before — no peer fetch is possible there anyway.
        if exchanged:
            exact = (old_world == world
                     and all(r in _shards_at(all_vis[r], last, old_world)
                             for r in range(world)))
        else:
            exact = (old_world == world
                     and rank in _shards_at(vis, last, old_world))
        if exact:
            # same world, own shard restorable in place: the exact-match
            # path
            try:
                restored.update(checkpoint.restore(
                    self.root, shard_tmpl, step=last, verify=self.verify,
                    shard=self.shard,
                    device=checkpoint.devices(shard_tmpl)))
            except ValueError as e:
                stripped, found = _strip_leaf_dtype(shard_tmpl)
                if not found or "leaf_dtype" not in str(e):
                    raise
                # pre-elastic shard checkpoint: saved before the
                # meta['leaf_dtype'] pin existed.  Same-world resume must
                # keep working — restore without the pin and graft the
                # template's freshly computed one back in, so the next
                # save upgrades the checkpoint in place (elastic restores
                # of such checkpoints still raise the named re-save error:
                # they have no manifest).
                restored.update(_reinsert_leaf_dtype(
                    checkpoint.restore(self.root, stripped, step=last,
                                       verify=self.verify,
                                       shard=self.shard,
                                       device=checkpoint.devices(stripped)),
                    shard_tmpl))
            log_event("auto-resume", step=last, generation=generation(),
                      shard=f"r{rank}/w{world}")
            return restored, last + 1

        visibility = {r: _shards_at(all_vis[r], last, old_world)
                      for r in range(world)}
        manifest = self._fetch_manifest(last, old_world, vis, all_vis)
        dp = None
        if any(set(range(old_world)) - visibility[r]
               for r in range(world)):
            dp = self._data_plane(world)
        tree, stats = reshard.reshard_restore(
            self.root, shard_tmpl, last, shard=self.shard,
            manifest=manifest, visibility=visibility, dp=dp,
            verify=self.verify)
        restored.update(tree)
        log_event("elastic-reshard", step=last, generation=generation(),
                  shard=f"r{rank}/w{world}", detail=stats.describe())
        return restored, last + 1

    def _exchange_visibility(self, vis: dict) -> Tuple[list, bool]:
        """``(per-rank visibility list, exchanged)``: every rank's
        :func:`~tpu_dist_torch.resilience.reshard.local_visibility`, exchanged
        through the control-plane store (JSON payloads under the
        generation namespace).  Without a store (single-rank jobs,
        storeless rigs) every rank is assumed to share this host's view —
        the shared-filesystem case — and ``exchanged`` is False so the
        caller can degrade to local-only rules if that assumption finds
        nothing.  With a store, a peer failing to report within the
        deadline raises: resuming on divergent views would split the
        gang silently."""
        rank, world = self.shard
        if world <= 1:
            return [vis], True   # a gang of one IS the full view
        payloads = self._store_all_ranks("reshard/vis",
                                         json.dumps(vis).encode())
        if payloads is None:
            return [vis] * world, False
        return [vis if r == rank else json.loads(payloads[r].decode())
                for r in range(world)], True

    def _store_all_ranks(self, subkey: str, payload: bytes,
                         timeout: float = 60.0) -> Optional[list]:
        """One symmetric store exchange: publish this rank's ``payload``
        under ``tpu_dist/g{gen}/{subkey}/{rank}``, wait for every peer's,
        return all ranks' payloads — or None when no store is reachable
        (the caller picks its degraded behavior)."""
        rank, world = self.shard
        from .heartbeat import _store_from_env
        from ..utils.logging import log_event
        try:
            store = _store_from_env()
        except Exception as e:
            store = None
            log_event("store-exchange-skipped", key=subkey, error=repr(e))
        if store is None:
            return None
        try:
            from ..dist.rendezvous import generation
            base = f"tpu_dist/g{generation()}/{subkey}"
            store.set(f"{base}/{rank}", payload)
            peers = [r for r in range(world) if r != rank]
            store.wait([f"{base}/{r}" for r in peers], timeout=timeout)
            return [payload if r == rank else store.get(f"{base}/{r}")
                    for r in range(world)]
        finally:
            try:
                store.close()
            except Exception:
                pass

    def _fetch_manifest(self, step: int, old_world: int, vis: dict,
                        all_vis: list) -> Optional[dict]:
        """The reshard manifest for ``step``: read locally when any old
        shard is on this disk, else relayed through the store by the
        lowest rank that can see one.  Every rank derives the same poster
        from the exchanged visibility, and the poster posts WHENEVER any
        rank lacks local visibility — even though it can read its own
        copy locally — because a zero-visibility peer is blocked on the
        relay key (one set + one bounded wait, no request round)."""
        from . import reshard
        local = None
        for o in sorted(_shards_at(vis, step, old_world)):
            local = reshard.load_manifest(self.root, step, o)
            if local is not None:
                break
        rank, world = self.shard
        havers = [r for r in range(world)
                  if _shards_at(all_vis[r], step, old_world)]
        if not havers or len(havers) == world:
            # nobody can post, or nobody needs the relay (all-local is
            # the shared-filesystem fast path); a None here surfaces as
            # reshard_restore's named error
            return local
        from .heartbeat import _store_from_env
        try:
            store = _store_from_env()
        except Exception:
            store = None
        if store is None:
            return local
        try:
            from ..dist.rendezvous import generation
            key = f"tpu_dist/g{generation()}/reshard/manifest/{step}"
            if rank == havers[0]:
                store.set(key, json.dumps(local).encode())
                return local
            if local is not None:
                return local
            store.wait([key], timeout=60.0)
            return json.loads(store.get(key).decode())
        finally:
            try:
                store.close()
            except Exception:
                pass

    def _data_plane(self, world: int):
        """This incarnation's host data plane for peer fragment pushes
        (None when unavailable: the reshard then raises its named error if
        a fragment truly needs a peer)."""
        try:
            from ..collectives.eager import _coll_store
            from ..collectives.transport import get_data_plane
            return get_data_plane(_coll_store(), self.shard[0], world)
        except Exception:
            return None

    def _agree_resume_step(self, steps) -> int:
        """Fixed-world step agreement: all ranks settle on the newest step
        EVERY rank has complete — max of the intersection of the per-rank
        complete-step sets (not min of per-rank maxes: keep-N pruning
        means a peer's older step may no longer exist here, and a mid-save
        kill means this rank's newest may not exist there).  Rides the
        control-plane store; when none is configured (single-rank jobs,
        storeless rigs) the local newest stands.  Once the store IS
        reachable, a peer failing to report within the deadline raises —
        ranks resuming at different steps would diverge the gang silently,
        which is strictly worse than a loud restart.

        ``resume`` itself now agrees through the richer visibility
        exchange (which also carries each step's recorded world, the
        elastic-reshard input); this narrower protocol remains for callers
        that only need a step number among fixed-world peers."""
        steps = set(steps)
        local = max(steps) if steps else -1
        rank, world = self.shard
        if world <= 1:
            return local
        payloads = self._store_all_ranks(
            "zero/resume", ",".join(str(s) for s in sorted(steps)).encode())
        if payloads is None:
            return local
        agreed = steps
        for r in range(world):
            if r != rank:
                agreed &= {int(s) for s in payloads[r].decode().split(",")
                           if s}
        return max(agreed) if agreed else -1

    def save(self, state: Any, step: int) -> str:
        from .. import checkpoint
        if not self.sharded_keys:
            return checkpoint.save(self.root, state, step,
                                   metadata=self.metadata, keep=self.keep)
        if not isinstance(state, dict):
            raise TypeError("sharded_keys needs a dict state at top level")
        repl = {k: v for k, v in state.items()
                if k not in self.sharded_keys}
        shardpart = {k: state[k] for k in self.sharded_keys}
        # keep-N over a sharded tree must be a TREE decision, not per-root:
        # per-root pruning under skewed save cadence can delete the one
        # step that is still complete everywhere — the very step the
        # resume agreement would pick — so both saves run unpruned and
        # checkpoint.prune_sharded prunes on completeness afterwards
        path = checkpoint.save(self.root, repl, step,
                               metadata=self.metadata, keep=None)
        checkpoint.save(self.root, shardpart, step, metadata=self.metadata,
                        keep=None, shard=self.shard)
        if self.keep is not None:
            pruned = checkpoint.prune_sharded(self.root, self.keep)
            # prune_sharded deliberately prunes NOTHING when the local
            # view can't prove tree completeness (per-host private
            # disks).  That is safe but unbounded — the pre-elastic
            # per-root keep= at least capped growth — so surface the
            # stall once instead of silently filling the disk.
            if (not pruned and not self._prune_stall_warned
                    and len(checkpoint.all_steps(self.root))
                    > 2 * max(self.keep, 1) + 2):
                self._prune_stall_warned = True
                from ..utils.logging import log_event
                log_event(
                    "keep-n-stalled", step=step, keep=self.keep,
                    detail="keep-N pruning cannot prove any step complete"
                           " across all shard roots from this host's view"
                           " (private per-host disks?); checkpoints will"
                           " accumulate until pruned externally")
        return path

    def end_step(self, state: Any, step: int) -> None:
        """Call at the end of every optimizer step: publish progress, save
        on the cadence, then run injected step faults (after the save, so a
        ``kill`` at step *k* leaves *k*'s checkpoint behind — the scenario
        the chaos e2e replays)."""
        if self._hb is not None:
            self._hb.set_step(step)
        if self.save_every and step % self.save_every == 0:
            self.save(state, step)
        c = _chaos.active()
        if c is not None:
            c.on_step(step)

    def close(self) -> None:
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None
        if self._monitor_store is not None:
            try:
                self._monitor_store.close()
            except Exception:
                pass
            self._monitor_store = None
        if self._hb is not None:
            self._hb.stop()
            self._hb = None

    def __enter__(self) -> "TrainState":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
