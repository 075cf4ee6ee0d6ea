"""Fused softmax cross-entropy — hand-written Triton kernels with autograd.

Counterpart of ``tpu_dist/ops/cross_entropy.py``.  The forward kernel (K1f)
returns each row's nll and logsumexp; the backward kernel (K1b) recomputes
``(softmax − onehot)·g`` from the saved lse, so no (N, V) tensor is kept
besides the logits themselves.  The kernels are in
``_cross_entropy_triton.py``, imported at first launch.  Beside each wrapper
sits its plain PyTorch version: the CPU takes it, and the kernels are held
against it on the card.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["fused_cross_entropy", "cross_entropy_fwd", "cross_entropy_bwd",
           "cross_entropy_fwd_plain", "cross_entropy_bwd_plain"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_LABEL_DTYPES = (torch.int32, torch.int64)
_BLOCK_V = 4096
_NUM_WARPS = 8


def _block(v: int) -> int:
    return min(_BLOCK_V, 1 << max(v - 1, 1).bit_length())


def _check(logits, labels):
    _build.check_cuda_tensor("logits", logits, _DTYPES, 2)
    _build.check_cuda_tensor("labels", labels, _LABEL_DTYPES, 1)
    if not logits.is_contiguous() or not labels.is_contiguous():
        raise ValueError("logits and labels must be contiguous")
    if labels.shape[0] != logits.shape[0] or labels.device != logits.device:
        raise ValueError(f"labels {tuple(labels.shape)} on {labels.device} do "
                         f"not match logits {tuple(logits.shape)} on "
                         f"{logits.device}")


def cross_entropy_fwd_plain(logits, labels):
    """Plain version of K1f: ``(nll, lse)``, float32 (N,)."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    ok = (labels >= 0) & (labels < x.shape[-1])
    safe = torch.where(ok, labels, torch.zeros_like(labels)).long()
    picked = x.gather(1, safe[:, None])[:, 0]
    return lse - torch.where(ok, picked, torch.zeros_like(picked)), lse


def cross_entropy_bwd_plain(logits, labels, lse, g):
    """Plain version of K1b: ``(softmax − onehot)·g`` in the logits dtype."""
    p = torch.exp(logits.float() - lse[:, None])
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols[None, :] == labels[:, None]).float()
    return ((p - onehot) * g[:, None]).to(logits.dtype)


def cross_entropy_fwd(logits, labels):
    """K1f: per-row ``(nll, lse)`` of logits (N, V) and integer labels (N,).
    A CPU tensor takes :func:`cross_entropy_fwd_plain`."""
    if logits.device.type == "cpu":
        return cross_entropy_fwd_plain(logits, labels)
    _check(logits, labels)
    n, v = logits.shape
    nll = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    if n == 0:
        return nll, lse
    from . import _cross_entropy_triton as k
    with torch.cuda.device(logits.device):
        k.cross_entropy_fwd_kernel[(n,)](logits, labels, nll, lse, v,
                                         logits.stride(0), BLOCK_V=_block(v),
                                         num_warps=_NUM_WARPS)
    cross_entropy_fwd.launches += 1
    return nll, lse


cross_entropy_fwd.launches = 0


def cross_entropy_bwd(logits, labels, lse, g):
    """K1b: dlogits (N, V) in the logits dtype from the saved lse and the
    per-row cotangent ``g`` (N,).  A CPU tensor takes
    :func:`cross_entropy_bwd_plain`."""
    if logits.device.type == "cpu":
        return cross_entropy_bwd_plain(logits, labels, lse, g)
    _check(logits, labels)
    n, v = logits.shape
    for name, t in (("lse", lse), ("g", g)):
        _build.check_cuda_tensor(name, t, (torch.float32,), 1)
        if t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous ({n},), got "
                             f"{tuple(t.shape)}")
    dlogits = torch.empty_like(logits)
    if n == 0:
        return dlogits
    from . import _cross_entropy_triton as k
    block = _block(v)
    with torch.cuda.device(logits.device):
        k.cross_entropy_bwd_kernel[(n, -(-v // block))](
            logits, labels, lse, g, dlogits, v, logits.stride(0),
            BLOCK_V=block, num_warps=_NUM_WARPS)
    cross_entropy_bwd.launches += 1
    return dlogits


cross_entropy_bwd.launches = 0


class _FusedNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        nll, lse = cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return cross_entropy_bwd(logits, labels, lse,
                                 g.float().contiguous()), None


def fused_cross_entropy(logits, labels, reduction: str = "mean"):
    """Drop-in for :func:`tpu_dist_torch.nn.functional.cross_entropy`
    computed by the kernels.  ``logits``: (..., V); ``labels``: integer
    (...), each in [0, V) — mask ``ignore_index`` rows outside, as
    :class:`tpu_dist_torch.nn.CrossEntropyLoss` does."""
    v = logits.shape[-1]
    nll = _FusedNLL.apply(logits.reshape(-1, v), labels.reshape(-1))
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll.reshape(labels.shape)
    raise ValueError(f"Unknown reduction {reduction!r}")
