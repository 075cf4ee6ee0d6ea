"""The per-role stage runtime: schedule ops over typed channels —
counterpart of ``tpu_dist/pipeline/stage.py``.

A :class:`PipelineStage` owns one stage's channel endpoints and executes
:func:`~tpu_dist_torch.pipeline.schedule.schedule_ops` for one optimizer
step: ``F k`` claims microbatch *k*'s activations from the inbound act
channel (stage 0 takes them from the local batch), runs the stage forward,
puts the result downstream, and stashes the *input*; ``B k`` claims the
gradient from downstream (the last stage seeds it from the loss),
recomputes the forward under autograd over the stashed input (detached and
made to require grad) and takes the parameter gradients and ``dx`` with
``torch.autograd.grad`` — so the stash holds one input per outstanding
microbatch, not the whole forward tape — and puts ``dx`` upstream.

Memory accounting is live and *asserted*: the stash byte/count watermarks
are tracked per step and a stash exceeding the schedule's bound
(:func:`~tpu_dist_torch.pipeline.schedule.stash_bound`) raises
:class:`PipelineScheduleError`.

Sends go through a single per-stage sender thread
(:meth:`PipelineStage.send_async` returns a :class:`PendingSend` handle;
channel endpoints are single-thread objects, and only the sender thread
touches the outbound endpoints), overlapping a put that hits channel
backpressure with the claim/compute the schedule orders next.  The stage
waits all of a step's handles before handing gradients back.  A CUDA
activation goes to the host explicitly on the sender thread: the compute
stream's event is waited on a side stream, the copy made there; a claimed
activation goes back to the stage's device.

Activations optionally ride the wire block-quantized (``compress=
"int8_blockN"``, :mod:`tpu_dist_torch.collectives.quant`): float leaves
become int8 payload + float32 per-block scales, the JAX package's bytes.
Lossy: parity gates run uncompressed.

Every claim/compute is an obs event of kind ``"pipeline"`` (stage, mb,
phase, stash bytes) — blocking claims are *pending spans*, so a stalled
stage is visible in a crash dump and ``obs diagnose`` names it.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..collectives import _tree
from ..obs.recorder import get_recorder, safe_record
from .schedule import schedule_ops, stash_bound

__all__ = ["PipelineStage", "StageFns", "StageResult", "PendingSend",
           "PipelineScheduleError"]


class PipelineScheduleError(RuntimeError):
    """The stage runtime violated the schedule's memory bound (or was
    driven outside its contract)."""


@dataclass
class StageFns:
    """The stage's compute, built by the trainer:

    - ``fwd(params, x) -> h`` — absent on the last stage
    - ``fwd_loss(params, x, y) -> loss`` — last stage only
    - ``bwd(params, x, g) -> (dparams, dx_or_None)`` — recompute-based
      backward over the stashed input (``dx`` is None on stage 0)
    - ``bwd_loss(params, x, y) -> (dparams, dx)`` — last stage only
    """
    fwd: Optional[Callable] = None
    fwd_loss: Optional[Callable] = None
    bwd: Optional[Callable] = None
    bwd_loss: Optional[Callable] = None


@dataclass
class StageResult:
    """One step's outcome on this stage: accumulated (already /M)
    gradients, per-microbatch losses (last stage only, schedule order),
    and the stash watermarks."""
    grads: Any
    losses: Dict[int, Any] = field(default_factory=dict)
    stash_peak_bytes: int = 0
    stash_peak_count: int = 0


class PendingSend:
    """Handle for one async channel put; ``wait()`` re-raises the send
    error (``ChannelClosedError``, peer-gone, ...) on the caller."""

    __slots__ = ("_done", "_err", "label")

    def __init__(self, label: str):
        self._done = threading.Event()
        self._err: Optional[BaseException] = None
        self.label = label

    def _finish(self, err: Optional[BaseException] = None) -> None:
        self._err = err
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._done.wait(timeout):
            raise TimeoutError(f"pipeline send {self.label} still pending "
                               f"after {timeout}s")
        if self._err is not None:
            raise self._err


def _host(tree, ready):
    """``tree`` with every CUDA tensor leaf copied to the host, on a side
    stream that waits for ``ready`` (the producing stream's event)."""
    leaves, treedef = _tree.flatten(tree)
    if not any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        return tree
    dev = next(t.device for t in leaves
               if isinstance(t, torch.Tensor) and t.is_cuda)
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        if ready is not None:
            side.wait_event(ready)
        out = [t.detach().to("cpu") if isinstance(t, torch.Tensor)
               and t.is_cuda else t for t in leaves]
    side.synchronize()
    return _tree.unflatten(treedef, out)


class _Sender(threading.Thread):
    """The stage's single outbound thread: FIFO over all of the stage's
    puts, so per-channel message order equals submission order."""

    def __init__(self, name: str, encode):
        super().__init__(name=name, daemon=True)
        self.q: "queue.Queue" = queue.Queue()
        self._encode = encode

    def run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            chan, tree, ready, timeout, handle = item
            try:
                chan.put(self._encode(_host(tree, ready)), timeout=timeout)
            except BaseException as e:  # delivered to wait(), not lost
                handle._finish(e)
            else:
                handle._finish()


def _nbytes(tree) -> int:
    """Bytes of a stashed input: tensors, or a first stage's host arrays
    (the host tp engine's token ids)."""
    return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
               else int(np.asarray(t).nbytes)
               for t in _tree.flatten(tree)[0])


class PipelineStage:
    """One stage role's runtime — see the module docstring.

    ``in_act``/``out_act``/``in_grad``/``out_grad`` are this stage's
    channel endpoints (None where the stage is an end of the pipe).
    ``device``: where claimed activations and gradients go (default: the
    device of the parameters a step runs with).
    """

    def __init__(self, fns: StageFns, stage: int, num_stages: int,
                 num_microbatches: int, schedule: str = "gpipe",
                 in_act=None, out_act=None, in_grad=None, out_grad=None,
                 compress=None, timeout: float = 120.0, device=None):
        from ..collectives.quant import parse_scheme
        self.fns = fns
        self.stage = stage
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.in_act, self.out_act = in_act, out_act
        self.in_grad, self.out_grad = in_grad, out_grad
        self.timeout = timeout
        self.device = None if device is None else torch.device(device)
        self.scheme = parse_scheme(compress) if compress else None
        if compress and self.scheme is None:
            raise ValueError(f"compress={compress!r} is not an int8_blockN "
                             f"scheme")
        self.first = stage == 0
        self.last = stage == num_stages - 1
        self.ops = schedule_ops(schedule, stage, num_stages,
                                num_microbatches)
        self.bound = stash_bound(schedule, stage, num_stages,
                                 num_microbatches)
        self._sender: Optional[_Sender] = None

    # -- wire codec -----------------------------------------------------------

    def _encode(self, tree):
        """Host leaves of ``tree`` quantized (float tensors and arrays)."""
        if self.scheme is None:
            return tree
        from ..collectives import _lowp
        from ..collectives.quant import quantize

        def enc(leaf):
            arr = (_lowp.from_torch(leaf) if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf))
            if arr.dtype.kind != "f" and not _lowp.is_lowp(arr.dtype):
                return leaf
            q, scales = quantize(arr, self.scheme)
            return {"__pipeq__": True, "q": q, "s": scales,
                    "shape": list(arr.shape),
                    "dtype": _lowp.dtype_name(arr.dtype),
                    "block": self.scheme.block}

        leaves, treedef = _tree.flatten(tree)
        return _tree.unflatten(treedef, [enc(x) for x in leaves])

    def _decode(self, tree):
        if self.scheme is None:
            return tree
        from ..collectives import _lowp
        from ..collectives.quant import QuantScheme, dequantize

        def dec(leaf):
            if not (isinstance(leaf, dict) and leaf.get("__pipeq__") is True):
                return leaf
            scheme = QuantScheme(int(leaf["block"]))
            flat = dequantize(np.asarray(leaf["q"]), np.asarray(leaf["s"]),
                              scheme,
                              dtype=_lowp.decode_dtype(str(leaf["dtype"])))
            return _lowp.to_torch(np.require(
                flat.reshape([int(d) for d in leaf["shape"]]),
                requirements="CW"))

        if isinstance(tree, dict) and tree.get("__pipeq__") is True:
            return dec(tree)
        if isinstance(tree, dict):
            return {k: self._decode(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._decode(v) for v in tree)
        return tree

    # -- channel IO -----------------------------------------------------------

    def send_async(self, chan, tree, label: str) -> PendingSend:
        """Queue one put on the stage's sender thread; returns the
        :class:`PendingSend` — the caller must ``wait()`` it (dropping it
        loses backpressure errors)."""
        if self._sender is None:
            self._sender = _Sender(f"pipe-stage{self.stage}-send",
                                   self._encode)
            self._sender.start()
        handle = PendingSend(label)
        ready = None
        leaves = _tree.flatten(tree)[0]
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
            ready = torch.cuda.Event()
            ready.record()
        self._sender.q.put((chan, tree, ready, self.timeout, handle))
        return handle

    @staticmethod
    def _to_device(tree, device):
        """A claimed tree's tensors (the channel's host tensors) on the
        stage's device."""
        leaves, treedef = _tree.flatten(tree)
        return _tree.unflatten(treedef, [
            t.to(device) if isinstance(t, torch.Tensor) else t
            for t in leaves])

    def _recv(self, chan, op: str, mb: int, phase: str, device):
        rec = get_recorder()
        ev = rec.begin("pipeline", op, stage=self.stage, mb=mb,
                       phase=phase) if rec else None
        try:
            tree = chan.get(timeout=self.timeout)
        except BaseException:
            if ev is not None:
                rec.end(ev, outcome="error")
            raise
        if ev is not None:
            rec.end(ev)
        return self._to_device(self._decode(tree), device)

    # -- the step -------------------------------------------------------------

    def run_step(self, params, x_mb=None, y_mb=None) -> StageResult:
        """Execute this stage's op sequence for one optimizer step.

        ``x_mb``: list of ``num_microbatches`` input microbatches (stage
        0 only); ``y_mb``: target microbatches (last stage only).
        Returns the accumulated, /M-normalized gradient tree plus the
        per-microbatch losses and stash watermarks."""
        if self.first and (x_mb is None
                           or len(x_mb) != self.num_microbatches):
            raise PipelineScheduleError(
                f"stage 0 wants {self.num_microbatches} input "
                f"microbatches, got "
                f"{None if x_mb is None else len(x_mb)}")
        if self.last and (y_mb is None
                          or len(y_mb) != self.num_microbatches):
            raise PipelineScheduleError(
                f"last stage wants {self.num_microbatches} target "
                f"microbatches, got "
                f"{None if y_mb is None else len(y_mb)}")
        device = self.device
        if device is None:
            leaves = [t for t in _tree.flatten(params)[0]
                      if isinstance(t, torch.Tensor)]
            device = leaves[0].device if leaves else torch.device("cpu")

        stash: Dict[int, Any] = {}
        stash_nbytes: Dict[int, int] = {}
        cur_bytes = 0
        res = StageResult(grads=None)
        handles: List[PendingSend] = []
        acc = None

        def account(mb, x):
            nonlocal cur_bytes
            nb = _nbytes(x)
            stash[mb] = x
            stash_nbytes[mb] = nb
            cur_bytes += nb
            res.stash_peak_bytes = max(res.stash_peak_bytes, cur_bytes)
            res.stash_peak_count = max(res.stash_peak_count, len(stash))
            if len(stash) > self.bound:
                raise PipelineScheduleError(
                    f"stage {self.stage} stashed {len(stash)} microbatch "
                    f"inputs, over the {self.schedule} bound "
                    f"{self.bound} — claim ordering violated the "
                    f"schedule's flow control")

        for op in self.ops:
            if op.phase == "F":
                x = x_mb[op.mb] if self.first else \
                    self._recv(self.in_act, "claim-act", op.mb, "fwd",
                               device)
                t0 = time.monotonic_ns()
                if self.last:
                    res.losses[op.mb] = self.fns.fwd_loss(
                        params, x, y_mb[op.mb])
                    h = None
                else:
                    h = self.fns.fwd(params, x)
                account(op.mb, x)
                safe_record("pipeline", "fwd", t0=t0, stage=self.stage,
                            mb=op.mb, phase="fwd",
                            stash_bytes=cur_bytes)
                if not self.last:
                    handles.append(self.send_async(
                        self.out_act, h,
                        f"act mb{op.mb} stage{self.stage}"))
            else:
                x = stash.pop(op.mb)
                cur_bytes -= stash_nbytes.pop(op.mb)
                if self.last:
                    t0 = time.monotonic_ns()
                    dparams, dx = self.fns.bwd_loss(params, x, y_mb[op.mb])
                else:
                    g = self._recv(self.in_grad, "claim-grad", op.mb,
                                   "bwd", device)
                    t0 = time.monotonic_ns()
                    dparams, dx = self.fns.bwd(params, x, g)
                acc = dparams if acc is None else _tree_add(acc, dparams)
                safe_record("pipeline", "bwd", t0=t0, stage=self.stage,
                            mb=op.mb, phase="bwd",
                            stash_bytes=cur_bytes)
                if not self.first:
                    handles.append(self.send_async(
                        self.out_grad, dx,
                        f"grad mb{op.mb} stage{self.stage}"))

        for handle in handles:
            handle.wait(self.timeout)
        res.grads = _tree_div(acc, float(self.num_microbatches))
        return res

    def close(self) -> None:
        """Stop the sender thread (channels belong to the caller)."""
        if self._sender is not None:
            self._sender.q.put(None)
            self._sender.join(timeout=5.0)
            self._sender = None


@torch.no_grad()
def _tree_add(a, b):
    leaves_a, treedef = _tree.flatten(a)
    return _tree.unflatten(treedef, [x + y for x, y in
                                     zip(leaves_a, _tree.flatten(b)[0])])


@torch.no_grad()
def _tree_div(a, m: float):
    """``a / m`` leaf by leaf, the divisor a 0-d tensor on the leaf's device
    (the card divides by a host scalar as a multiply by its reciprocal)."""
    leaves, treedef = _tree.flatten(a)
    return _tree.unflatten(treedef, [x / x.new_tensor(m) for x in leaves])
