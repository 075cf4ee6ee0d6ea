"""Flash attention — hand-written CUDA kernels for Hopper, with autograd.

Counterpart of ``tpu_dist/ops/flash_attention.py``.  The kernels live in
``tpu_dist_torch/csrc/flash_attention.cu`` (forward; backward as a dQ kernel
and a dK/dV kernel) and are built for ``sm_90a`` at first use.  Beside each
wrapper sits its plain PyTorch version: the CPU takes it, and the kernels are
held against it on the card.

Public layout as in the JAX package: ``q`` (..., Tq, H, D), ``k``/``v``
(..., Tk, H, D); ``sm_scale=None`` means ``1/sqrt(D)``; rows that see no key
get lse ≈ -1e30 and output 0.  ``causal`` is ``True``, ``False`` or
``"offdiag"``: query row q sees the keys of the key blocks strictly left of
its query block, k < floor((q // bq) * bq / bk) * bk, where ``bq, bk`` are
``block_q, block_k`` after the JAX package's clamp (:func:`clamp_blocks`);
the blocks change no result in the other two modes.  ``split_diag=True``
computes causal self-attention as one offdiag call and one batched causal
call over the diagonal bands, merged by their lse (:class:`_SplitLse`).

:func:`flash_design` picks one of the source's three designs from the dtype,
the head dim and the strides alone: ``"wgmma"`` (the Hopper kernels: TMA
rings, warp-specialized, wgmma) for bf16 with D = 64, the training path's
shapes; ``"mma_sync"`` (the first port's kernels) for any other bf16 head
dim; ``"fma"`` for float32.  Each wrapper counts its launches per design.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_with_lse", "flash_fwd",
           "flash_bwd", "flash_fwd_plain", "flash_bwd_plain", "flash_design",
           "clamp_blocks", "merge_lse", "DESIGNS", "MODES"]

_NEG_INF = -1e30  # finite, as in the TPU kernel: masked rows stay NaN-free
_DTYPES = (torch.float32, torch.bfloat16)
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}
_LIB = "flash_attention"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse | B, H, Tq, Tk, D | q/k/v strides | scale, mode, bq,
    # bk, dtype, design, stream
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_F] + [_I] * 5 + [_P],
    # q, k, v, dO, lse, delta, dQ, dK, dV | ... as above
    "flash_bwd": [_P] * 9 + [_I] * 5 + [_L] * 9 + [_F] + [_I] * 5 + [_P],
}
# the kernel designs of csrc/flash_attention.cu, by the index its entry
# points take
DESIGNS = ("fma", "mma_sync", "wgmma")
# the masking modes, by the index the entry points take: causal=False,
# True, "offdiag"
MODES = ("none", "causal", "offdiag")
_WGMMA_D = 64  # the wgmma kernels' head dim: one 128-byte swizzled row
_LANE = 128


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def clamp_blocks(dtype, tq: int, tk: int, block_q: int, block_k: int):
    """The block sizes the JAX package's kernels take for ``block_q,
    block_k`` (its ``_clamp_blocks``): at most 512 for 4-byte dtypes, then
    at most T rounded up to 128.  They define the offdiag mode's blocks."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q, block_k must be >= 1, got "
                         f"{block_q}, {block_k}")
    if dtype.itemsize >= 4:
        block_q, block_k = min(block_q, 512), min(block_k, 512)
    return (min(block_q, _ceil_to(tq, _LANE)),
            min(block_k, _ceil_to(tk, _LANE)))


def _mode(causal) -> str:
    """The masking mode of ``causal`` (True, False or "offdiag")."""
    if isinstance(causal, str):
        if causal != "offdiag":
            raise ValueError(f"causal={causal!r}: use True, False or "
                             f"'offdiag'")
        return "offdiag"
    return "causal" if causal else "none"


def _mode_args(causal, dtype, tq, tk, block_q, block_k):
    """(mode index, bq, bk) as the kernels take them."""
    mode = _mode(causal)
    if mode != "offdiag":
        return MODES.index(mode), 0, 0
    return (MODES.index(mode),
            *clamp_blocks(dtype, tq, tk, block_q, block_k))


def flash_design(dtype, tq: int, tk: int, d: int, strides,
                 aligned: bool = True) -> str:
    """The kernel design a CUDA call of :func:`flash_fwd` or
    :func:`flash_bwd` takes, from its shapes and strides alone (never on
    failure).  ``strides``: the (B, T, H, D) element strides of q, k and v.
    Every design reads 16-byte row vectors, so a call whose D stride is not
    1, whose other strides are not multiples of 16 bytes, or whose bases are
    not all 16-byte ``aligned`` is refused here (ValueError): no design
    takes it.  Otherwise ``"fma"`` for float32; ``"wgmma"`` for bf16 with
    D = 64 and Tq, Tk >= 1 (its TMA boxes hold 64 rows of one head, 128 bytes
    each; the training path's shapes); ``"mma_sync"`` for every other bf16
    call."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}: the kernels take "
                        f"{', '.join(str(t) for t in _DTYPES)}")
    vec = 16 // _ELEMENT_SIZE[dtype]
    for st in strides:
        if st[-1] != 1 or any(x % vec for x in st[:-1]) or not aligned:
            raise ValueError(
                f"the kernels read 16-byte row vectors; they need unit "
                f"stride in D, strides that are multiples of {vec} and "
                f"16-byte aligned bases (strides {tuple(st)}, aligned "
                f"{aligned})")
    if dtype == torch.float32:
        return "fma"
    if d == _WGMMA_D and tq >= 1 and tk >= 1:
        return "wgmma"
    return "mma_sync"


def _pick_design(older: bool, q, k, v, *more) -> str:
    """:func:`flash_design` for the call's tensors (``more``: other inputs
    the kernels read in 16-byte vectors, such as a contiguous dO, whose bases
    must be aligned too); ``older`` (the private ``_older=True`` of a
    same-call comparison, which nothing on the training path passes) runs
    the ``mma_sync`` design on a shape that takes ``wgmma``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, *more))
    design = flash_design(q.dtype, q.shape[1], k.shape[1], q.shape[3],
                          [t.stride() for t in (q, k, v)], aligned)
    if not older:
        return design
    if design != "wgmma":
        raise ValueError(f"_older=True compares the older design on a shape "
                         f"that takes 'wgmma'; this call takes {design!r}")
    return "mma_sync"


def _check_operands(q, k, v):
    # the common case in a few attribute reads (this runs on every launch);
    # anything else gets the checks that name the fault
    if not (q.is_cuda and q.dtype in _DTYPES and q.dim() == 4
            and k.dtype is q.dtype and v.dtype is q.dtype
            and k.dim() == 4 and v.dim() == 4
            and k.device == q.device and v.device == q.device):
        for name, t in (("q", q), ("k", k), ("v", v)):
            _build.check_cuda_tensor(name, t, _DTYPES, 4)
            if t.dtype != q.dtype or t.device != q.device:
                raise TypeError(f"{name}: {t.dtype} on {t.device} does not "
                                f"match q ({q.dtype} on {q.device})")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:]) != (h, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, T, H, D) with equal "
                         f"B, H, D and equal k/v shapes")
    if d % 8 or not 0 < d <= 128:
        raise ValueError(f"head dim {d}: the kernel takes D % 8 == 0, D <= 128")
    if max(tq, k.shape[1]) > 65535 * 32:
        raise ValueError(f"sequence length {max(tq, k.shape[1])} exceeds the "
                         f"kernel's grid")


def _lib():
    return _build.load_library(_LIB, _SIGNATURES)


def _stream(t):
    # the raw handle, without building a torch.cuda.Stream on every launch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _keep_mask(tq, tk, causal, dtype, device, block_q=1024, block_k=1024):
    """(Tq, Tk) True = visible, or None when everything is: ``k <= q``
    (causal), ``k < floor((q // bq) * bq / bk) * bk`` (offdiag, with the
    clamped blocks)."""
    mode = _mode(causal)
    if mode == "none":
        return None
    qpos = torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(tk, device=device)[None, :]
    if mode == "causal":
        return kpos <= qpos
    bq, bk = clamp_blocks(dtype, tq, tk, block_q, block_k)
    return kpos < (qpos // bq) * bq // bk * bk


def flash_fwd_plain(q, k, v, causal, sm_scale: float, block_q: int = 1024,
                    block_k: int = 1024):
    """Plain version of K2f: ``(o, lse)`` with lse (B, H, Tq) float32.
    Scores and softmax in float32; the probabilities are rounded to the
    input dtype before the PV product, as the kernel rounds them."""
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    keep = _keep_mask(tq, tk, causal, q.dtype, q.device, block_q, block_k)
    if keep is not None:
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float()) / l
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale: float,
                    block_q: int = 1024, block_k: int = 1024):
    """Plain version of K2b: ``(dq, dk, dv)`` from the saved lse and
    ``delta = rowsum(dO·O) − dlse`` (both (B, H, Tq) float32).  The
    probabilities and dS are rounded to the input dtype before their
    products, as the kernels round them."""
    tq, tk = q.shape[1], k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    keep = _keep_mask(tq, tk, causal, q.dtype, q.device, block_q, block_k)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd(q, k, v, causal, sm_scale: float, block_q: int = 1024,
              block_k: int = 1024, _older=False):
    """K2f: flash-attention forward on (B, T, H, D) tensors → ``(o, lse)``
    with o (B, Tq, H, D) contiguous and lse (B, H, Tq) float32.  ``causal``:
    True, False or "offdiag" (whose blocks ``block_q, block_k`` are clamped
    by :func:`clamp_blocks`).  A CPU tensor takes :func:`flash_fwd_plain`; a
    CUDA tensor launches the kernel that :func:`flash_design` picks."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, sm_scale, block_q, block_k)
    _check_operands(q, k, v)
    design = _pick_design(_older, q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    mode, bq, bk = _mode_args(causal, q.dtype, tq, tk, block_q, block_k)
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _lib()
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), b, h, tq, tk, d,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        float(sm_scale), mode, bq, bk,
                        int(q.dtype == torch.bfloat16),
                        DESIGNS.index(design), _stream(q))
    _build.check(lib, _LIB, err, "flash_fwd")
    flash_fwd.launches += 1
    flash_fwd.launches_by_design[design] += 1
    flash_fwd.launches_by_mode[MODES[mode]] += 1
    return o, lse


flash_fwd.launches = 0
flash_fwd.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_fwd.launches_by_mode = dict.fromkeys(MODES, 0)


def flash_bwd(q, k, v, do, lse, delta, causal, sm_scale: float,
              block_q: int = 1024, block_k: int = 1024, _older=False):
    """K2b: flash-attention backward → ``(dq, dk, dv)``, contiguous
    (B, T, H, D).  One call launches two kernels of the design
    :func:`flash_design` picks, dQ then dK/dV; it counts once.  ``causal``
    and the blocks as in :func:`flash_fwd`.  A CPU tensor takes
    :func:`flash_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale,
                               block_q, block_k)
    _check_operands(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    mode, bq, bk = _mode_args(causal, q.dtype, tq, tk, block_q, block_k)
    if tuple(do.shape) != (b, tq, h, d) or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        _build.check_cuda_tensor(name, t, (torch.float32,), 3)
        if tuple(t.shape) != (b, h, tq) or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous (B, H, Tq) = "
                             f"{(b, h, tq)}, got {tuple(t.shape)}")
    do = do.contiguous()
    design = _pick_design(_older, q, k, v, do)
    dq = torch.empty_like(do)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _lib()
    err = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, d,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        float(sm_scale), mode, bq, bk,
                        int(q.dtype == torch.bfloat16),
                        DESIGNS.index(design), _stream(q))
    _build.check(lib, _LIB, err, "flash_bwd")
    flash_bwd.launches += 1
    flash_bwd.launches_by_design[design] += 1
    flash_bwd.launches_by_mode[MODES[mode]] += 1
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.launches_by_design = dict.fromkeys(DESIGNS, 0)
flash_bwd.launches_by_mode = dict.fromkeys(MODES, 0)


class _FlashLse(torch.autograd.Function):
    """Differentiable in both outputs: the lse cotangent folds into
    ``delta`` (``_bwd_call`` in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_q, block_k):
        o, lse = flash_fwd(q, k, v, causal, sm_scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = causal, sm_scale, block_q, block_k
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) - dlse
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta.contiguous(),
                               *ctx.args)
        return dq, dk, dv, None, None, None, None


def merge_lse(o_a, lse_a, o_b, lse_b):
    """The exact merge of two partial attentions over disjoint key sets (the
    JAX package's ``_merge_lse``), in float32: o (B, T, H, D), lse (B, H, T)
    → ``(o float32, lse)``.  A row no key of either part reaches keeps lse ≈
    -1e30 and o 0."""
    m = torch.maximum(lse_a, lse_b)
    w_a, w_b = torch.exp(lse_a - m), torch.exp(lse_b - m)
    den = w_a + w_b

    def rows(w):  # (B, H, T) → (B, T, H, 1)
        return w.transpose(1, 2)[..., None]

    o = (o_a.float() * rows(w_a) + o_b.float() * rows(w_b)) / rows(den)
    return o, m + torch.log(den)


def _to_bands(x, band):
    """(B, T, H, D) → (B · T/band, band, H, D), a view where x's strides
    allow it (contiguous T, or the fused projection's views)."""
    b, t, h, d = x.shape
    return x.reshape(b * (t // band), band, h, d)


def _rows_to_bands(x, band):
    """(B, H, T) row statistics → (B · T/band, H, band), contiguous."""
    b, h, t = x.shape
    return (x.reshape(b, h, t // band, band).transpose(1, 2)
            .reshape(b * (t // band), h, band).contiguous())


def _rows_from_bands(x, b):
    """The inverse of :func:`_rows_to_bands`."""
    nb_b, h, band = x.shape
    return (x.reshape(b, nb_b // b, h, band).transpose(1, 2)
            .reshape(b, h, nb_b // b * band))


class _SplitLse(torch.autograd.Function):
    """Causal self-attention as two calls a pass (``_split_lse`` in the JAX
    package): one offdiag call over the key blocks strictly left of each
    query block, and one causal call over the diagonal bands batched as
    (B · T/bq, bq, H, D) sequences, merged by their lse in float32.  The
    backward recomputes from the merged ``(o, lse)`` with one ``delta =
    rowsum(dO·O) − dlse`` that both K2b calls share, so the residuals are
    those of a single call."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, bq, bk):
        b, t, h, d = q.shape
        o_d, lse_d = flash_fwd(_to_bands(q, bq), _to_bands(k, bq),
                               _to_bands(v, bq), True, sm_scale,
                               bq // 2, bq // 2)
        o_off, lse_off = flash_fwd(q, k, v, "offdiag", sm_scale, bq, bk)
        o, lse = merge_lse(o_off, lse_off, o_d.reshape(b, t, h, d),
                           _rows_from_bands(lse_d, b))
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = sm_scale, bq, bk
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        sm_scale, bq, bk = ctx.args
        b, t, h, d = q.shape
        do = do.contiguous()
        delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
                 - dlse).contiguous()
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, "offdiag", sm_scale,
                               bq, bk)
        diag = flash_bwd(_to_bands(q, bq), _to_bands(k, bq),
                         _to_bands(v, bq), _to_bands(do, bq),
                         _rows_to_bands(lse, bq), _rows_to_bands(delta, bq),
                         True, sm_scale, bq // 2, bq // 2)
        dq, dk, dv = (g + gd.reshape(b, t, h, d)
                      for g, gd in zip((dq, dk, dv), diag))
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None,
                             block_q: int = 1024, block_k: int = 1024,
                             split_diag=None):
    """Flash attention returning ``(out, lse)``: out (..., Tq, H, D), lse
    (..., Tq, H) float32, differentiable in both.  ``causal``: True, False
    or "offdiag" (with ``block_q, block_k``); ``split_diag=True`` takes
    causal self-attention (``causal=True``, Tq = Tk, the clamped block_q
    dividing T) through :class:`_SplitLse` with square blocks, as the JAX
    package does; the default runs one call."""
    if q.dim() < 3:
        raise ValueError(f"expected (..., T, H, D), got {tuple(q.shape)}")
    *lead, tq, h, d = q.shape
    tk = k.shape[-3]
    if not (q.shape[:-3] == k.shape[:-3] == v.shape[:-3]
            and k.shape[-2:] == v.shape[-2:] == (h, d)
            and v.shape[-3] == tk):
        raise ValueError(
            f"flash_attention needs identical batch/head dims for q, k, v; "
            f"got q={tuple(q.shape)}, k={tuple(k.shape)}, v={tuple(v.shape)}")
    if not isinstance(causal, str):
        causal = bool(causal)
    _mode(causal)  # refuses an unknown mode
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    args = (q.reshape(-1, tq, h, d), k.reshape(-1, tk, h, d),
            v.reshape(-1, tk, h, d))
    if split_diag:
        bq, _ = clamp_blocks(q.dtype, tq, tk, int(block_q), int(block_k))
        # the split is causal self-attention by construction, and its
        # offdiag part skips key columns if key blocks are coarser than the
        # query bands: square blocks only, as in the JAX package
        if causal is not True or tq != tk or tq % bq:
            raise ValueError(
                f"split_diag=True requires causal=True self-attention "
                f"(tq == tk) with block_q dividing tq; got causal={causal}, "
                f"tq={tq}, tk={tk}, effective block_q={bq}")
        o, lse = _SplitLse.apply(*args, float(sm_scale), bq, bq)
    else:
        o, lse = _FlashLse.apply(*args, causal, float(sm_scale),
                                 int(block_q), int(block_k))
    return (o.reshape(*lead, tq, h, d),
            lse.transpose(1, 2).reshape(*lead, tq, h))


def flash_attention(q, k, v, causal=False, sm_scale=None,
                    block_q: int = 1024, block_k: int = 1024,
                    split_diag=None):
    """Flash attention.  ``q``: (..., Tq, H, D); ``k, v``: (..., Tk, H, D).
    Drop-in for :func:`tpu_dist_torch.nn.attention.scaled_dot_product_attention`
    with no mask; differentiable; O(T) memory.  Arguments as in
    :func:`flash_attention_with_lse`."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale, block_q=block_q,
                                    block_k=block_k,
                                    split_diag=split_diag)[0]
