"""Grouped matrix multiply — the dropless-MoE kernel pair, hand-written CUDA
kernels for Hopper, with autograd.

Counterpart of ``tpu_dist/ops/gmm.py``.  Rows are sorted by group (expert)
into block-aligned segments; every row block belongs to one group:

    x (M, D) sorted by group, M a multiple of ``block_rows``
    w (E, D, H) stacked per-group weights
    out[block i] = x[block i] @ w[block_groups[i]]   (K3, :func:`gmm`)
    out[block i] = act(x[block i] @ w[...] + bias)   (B2, ``activation=``)
    dw[e] = sum over e's blocks of x_blkᵀ @ dy_blk   (K4, :func:`tgmm`)

The kernels live in ``tpu_dist_torch/csrc/gmm.cu`` and are built for
``sm_90a`` at first use.  :func:`gmm_design` picks one of their three
designs from the shapes alone (the MoE path's bf16 shapes take the Hopper
``wgmma`` kernels; other bf16 shapes ``mma.sync``, float32 FMA), and each
wrapper counts its launches per design.  Each block of a launch reads its
group id and the live-block count from device memory (the TPU kernels'
scalar prefetch), so no step waits on the host.  Beside each wrapper sits
its plain PyTorch version,
built from per-block float32 products: the CPU takes it, the kernels are held
against it on the card, and :func:`gmm_impl` selects it explicitly for a
comparison run.

``gmm(activation=f)`` applies ``f`` to the float32 sum (after the bias,
before the output is rounded) inside the kernel, in every design, as the TPU
kernel does: no extra trip of the (M, H) output through device memory.  The
kernels know the element-wise functions of :data:`ACTIVATIONS`, recognised by
identity; on a CPU tensor any callable works, as in the JAX package.  Mind the
GELU: ``jax.nn.gelu`` defaults to the tanh form (:func:`gelu_tanh`), torch's
``F.gelu`` to the exact erf form.

:func:`grouped_linear` is the differentiable grouped linear of the JAX
package: its three backward passes are grouped products over the same block
map (dx through :func:`gmm` against ``wᵀ``, dw/db through :func:`tgmm`), with
no scatter and no atomics.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["gmm", "tgmm", "grouped_linear", "gmm_plain", "tgmm_plain",
           "gmm_impl", "gmm_design", "group_offsets", "ceil_to", "DESIGNS",
           "ACTIVATIONS", "activation_name", "gelu_tanh"]

_DTYPES = (torch.float32, torch.bfloat16)
_LIB = "gmm"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, bias, block_groups, n_live, out | M, K, N, E, block_rows, w_nk,
    # dtype, out_f32, design, act, stream
    "gmm_launch": [_P] * 6 + [_I] * 10 + [_P],
    # x, dy, block_groups, n_live, offsets, dw, db | M, E, D, H, block_rows,
    # dtype, out_f32, design, stream
    "tgmm_launch": [_P] * 7 + [_I] * 8 + [_P],
}
# the kernel designs of csrc/gmm.cu, by the index its entry points take
DESIGNS = ("fma", "mma_sync", "wgmma")
_WGMMA_ROWS = 128   # the wgmma kernels' row tile
_WGMMA_COLS = 64    # their TMA boxes' width along D and H
_IMPL: list = []


def gelu_tanh(x):
    """GELU in its tanh form, ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715
    x^3)))``: ``jax.nn.gelu``'s default (``approximate=True``) and the MoE
    experts' activation.  Not ``F.gelu``, whose default is the exact erf
    form: the counterpart of the JAX package's ``activation=jax.nn.gelu`` is
    this function."""
    return F.gelu(x, approximate="tanh")


# the activation epilogues of csrc/gmm.cu: name -> the code its apply_act
# takes (enum Act; 0 is none)
ACTIVATIONS = {"gelu_tanh": 1, "gelu": 2, "relu": 3, "silu": 4, "sigmoid": 5,
               "tanh": 6}
# the callables a caller passes for each, recognised by identity
_ACTIVATION_FNS = {
    "gelu_tanh": {"gelu_tanh": gelu_tanh},
    "gelu": {"F.gelu": F.gelu},
    "relu": {"F.relu": F.relu, "torch.relu": torch.relu},
    "silu": {"F.silu": F.silu},
    "sigmoid": {"torch.sigmoid": torch.sigmoid, "F.sigmoid": F.sigmoid},
    "tanh": {"torch.tanh": torch.tanh, "F.tanh": F.tanh},
}


def activation_name(activation) -> str:
    """The name in :data:`ACTIVATIONS` of the kernel epilogue that computes
    ``activation`` (a callable, by identity).  ValueError for any other: a
    CUDA call does not fall back to the plain version."""
    for name, fns in _ACTIVATION_FNS.items():
        if any(activation is fn for fn in fns.values()):
            return name
    known = "; ".join(f"{name}: {', '.join(fns)}"
                      for name, fns in _ACTIVATION_FNS.items())
    raise ValueError(f"gmm: the kernel has no epilogue for activation "
                     f"{activation!r}; it knows {known} (jax.nn.gelu is "
                     f"gelu_tanh, not F.gelu)")


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return (x + m - 1) // m * m


def gmm_design(dtype, block_rows: int, d: int, h: int,
               aligned: bool = True) -> str:
    """The kernel design a CUDA call of :func:`gmm` or :func:`tgmm` takes,
    from its shapes alone (never on failure): ``"wgmma"`` for bf16 whose
    128-row tiles lie inside one row block (``block_rows % 128 == 0``) and
    whose 64-wide TMA boxes tile both feature widths (``d`` and ``h``, the
    contraction and output widths of ``gmm`` or the two of ``tgmm``,
    multiples of 64); ``"mma_sync"`` for every other bf16 call; ``"fma"``
    for float32.  Both bf16 designs move 16-byte vectors, so a bf16 call
    whose bases are not all 16-byte ``aligned`` is refused here
    (ValueError): no design takes it."""
    if dtype == torch.float32:
        return "fma"
    if not aligned:
        raise ValueError("the bf16 kernels need 16-byte aligned bases")
    if (block_rows % _WGMMA_ROWS == 0 and d % _WGMMA_COLS == 0
            and h % _WGMMA_COLS == 0):
        return "wgmma"
    return "mma_sync"


def _pick_design(older: bool, dtype, block_rows, d, h, *tensors) -> str:
    """:func:`gmm_design` for the call's tensors; ``older`` (the private
    ``_older=True`` of a same-call comparison, which nothing on the training
    path passes) runs the ``mma_sync`` design on a shape that takes
    ``wgmma``."""
    design = gmm_design(dtype, block_rows, d, h,
                        all(t.data_ptr() % 16 == 0 for t in tensors))
    if not older:
        return design
    if design != "wgmma":
        raise ValueError(f"_older=True compares the older design on a shape "
                         f"that takes 'wgmma'; this call takes {design!r}")
    return "mma_sync"


@contextlib.contextmanager
def gmm_impl(impl: str):
    """Scoped choice for :func:`grouped_linear`: ``"kernel"`` (the default:
    :func:`gmm`/:func:`tgmm`) or ``"plain"`` (:func:`gmm_plain`/
    :func:`tgmm_plain` on any device) — the plain composition a kernel run
    is compared with."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"gmm_impl: expected 'kernel' or 'plain', got "
                         f"{impl!r}")
    _IMPL.append(impl)
    try:
        yield
    finally:
        _IMPL.pop()


def _plain_selected() -> bool:
    return bool(_IMPL) and _IMPL[-1] == "plain"


def _lib():
    return _build.load_library(_LIB, _SIGNATURES)


def _stream(t):
    # the raw handle, without building a torch.cuda.Stream on every launch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check_layout(m: int, block_rows: int, n_blocks: int) -> None:
    if block_rows < 8 or block_rows % 8:
        raise ValueError(f"block_rows={block_rows}: the kernels take a "
                         f"positive multiple of 8")
    if m % block_rows:
        raise ValueError(f"M={m} not a multiple of block_rows={block_rows}")
    if n_blocks != m // block_rows:
        raise ValueError(f"block_groups has {n_blocks} entries, M / "
                         f"block_rows = {m // block_rows}")


def _live_blocks(n_live, nb: int, device) -> torch.Tensor:
    """(nb,) bool: block i is live (i < n_live), computed on the device."""
    n_live = torch.as_tensor(n_live, device=device).reshape(())
    return torch.arange(nb, device=device) < n_live


def group_offsets(block_groups, n_groups: int, block_rows: int,
                  n_live_blocks=None) -> torch.Tensor:
    """(E+1,) int32 row offsets of each group's rows — what :func:`tgmm`'s
    kernel loops over — from the non-decreasing block map, on its device
    (no host sync).  Blocks from ``n_live_blocks`` on are moved past every
    group, so they belong to none.  The plain version of the offsets a CUDA
    :func:`tgmm` call has its library write before the kernel
    (``group_offsets_kernel`` in ``csrc/gmm.cu``)."""
    bg = block_groups.to(torch.int32)
    if n_live_blocks is not None:
        live = _live_blocks(n_live_blocks, bg.shape[0], bg.device)
        bg = torch.where(live, bg, torch.full_like(bg, n_groups))
    bounds = torch.arange(n_groups + 1, dtype=torch.int32, device=bg.device)
    return (torch.searchsorted(bg, bounds, out_int32=True)
            * block_rows).contiguous()


def _group_onehot(block_groups, n_groups: int, live=None) -> torch.Tensor:
    """(E, nb) float32 one-hot of each block's group (zero for a block that
    is not live): a segment sum over blocks as one deterministic product."""
    groups = torch.arange(n_groups, device=block_groups.device)
    oh = (block_groups.long()[None, :] == groups[:, None]).float()
    return oh if live is None else oh * live[None, :].float()


def gmm_plain(x, w, block_groups, n_live_blocks, *, bias=None,
              block_rows: int, out_dtype=None, activation=None):
    """Plain version of K3: each row block's float32 product with its
    group's weights (+ bias), passed through ``activation`` (any callable)
    in float32 and rounded to ``out_dtype``; blocks at index
    ``n_live_blocks`` or beyond are zeros, not ``activation(0)``."""
    m, d = x.shape
    nb = m // block_rows
    wb = w.float()[block_groups.long()]                       # (nb, D, H)
    out = torch.bmm(x.float().reshape(nb, block_rows, d), wb)
    if bias is not None:
        out = out + bias.float()[block_groups.long()][:, None, :]
    if activation is not None:
        out = activation(out)
    live = _live_blocks(n_live_blocks, nb, x.device)
    out = torch.where(live[:, None, None], out, torch.zeros_like(out))
    return out.reshape(m, -1).to(out_dtype or x.dtype)


def tgmm_plain(x, dy, block_groups, n_groups: int, *, block_rows: int,
               with_rowsum: bool = False, out_dtype=None,
               n_live_blocks=None):
    """Plain version of K4: float32 products ``x_blkᵀ @ dy_blk`` per row
    block, summed per group; a group with no blocks gets zeros.  With
    ``n_live_blocks``, blocks from that index on are left out."""
    m, d = x.shape
    h = dy.shape[1]
    nb = m // block_rows
    live = (None if n_live_blocks is None
            else _live_blocks(n_live_blocks, nb, x.device))
    oh = _group_onehot(block_groups, n_groups, live)           # (E, nb)
    xb = x.float().reshape(nb, block_rows, d)
    dyb = dy.float().reshape(nb, block_rows, h)
    per_block = torch.bmm(xb.transpose(1, 2), dyb)             # (nb, D, H)
    out_dtype = out_dtype or x.dtype
    dw = (oh @ per_block.reshape(nb, d * h)).reshape(n_groups, d, h)
    if not with_rowsum:
        return dw.to(out_dtype)
    return dw.to(out_dtype), (oh @ dyb.sum(1)).to(out_dtype)


def _check_common(x, other, name, block_groups, out_dtype):
    """Checks shared by both kernels: ``x`` and ``other`` CUDA tensors of
    one kernel dtype on one device, x contiguous, an int32 block map there,
    and an output dtype the kernel writes."""
    _build.check_cuda_tensor("x", x, _DTYPES, 2)
    _build.check_cuda_tensor(name, other, _DTYPES, other.dim())
    _build.check_cuda_tensor("block_groups", block_groups, (torch.int32,), 1)
    if other.dtype != x.dtype or other.device != x.device:
        raise TypeError(f"{name}: {other.dtype} on {other.device} does not "
                        f"match x ({x.dtype} on {x.device})")
    if block_groups.device != x.device or not block_groups.is_contiguous():
        raise ValueError("block_groups must be a contiguous int32 tensor on "
                         "x's device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes "
                        f"{x.dtype} or float32")


def _check_bf16_vectors(d, h):
    """The bf16 kernels move 16-byte vectors along D and H (their bases'
    alignment is :func:`gmm_design`'s to check)."""
    if d % 8 or h % 8:
        raise ValueError(f"bf16 kernel reads 16-byte vectors: D={d} and "
                         f"H={h} must be multiples of 8")


def _check_tgmm_operands(x, dy, block_groups, out_dtype):
    _check_common(x, dy, "dy", block_groups, out_dtype)
    if dy.dim() != 2 or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous (M, H) tensor, got "
                         f"{tuple(dy.shape)}")
    if x.dtype == torch.bfloat16:
        _check_bf16_vectors(x.shape[1], dy.shape[1])


def _check_operands(x, w, block_groups, bias, out_dtype):
    _check_common(x, w, "w", block_groups, out_dtype)
    if w.dim() != 3:
        raise ValueError(f"w: expected (E, D, H), got {tuple(w.shape)}")
    e, d, h = w.shape
    if w.is_contiguous():
        w_nk = False
    elif w.transpose(1, 2).is_contiguous():
        w_nk = True  # the transpose view of a contiguous (E, H, D) tensor
    else:
        raise ValueError(f"w: need a contiguous (E, D, H) tensor or the "
                         f"transpose of a contiguous (E, H, D) one (strides "
                         f"{w.stride()})")
    if bias is not None:
        _build.check_cuda_tensor("bias", bias, (x.dtype,), 2)
        if tuple(bias.shape) != (e, h) or not bias.is_contiguous():
            raise ValueError(f"bias: need contiguous {(e, h)}, got "
                             f"{tuple(bias.shape)}")
    if x.dtype == torch.bfloat16:
        _check_bf16_vectors(d, h)
    return w_nk


def gmm(x, w, block_groups, n_live_blocks, *, bias=None,
        block_rows: int = 512, out_dtype=None, activation=None,
        _older=False):
    """K3: block-diagonal grouped matmul ``out[i*B:(i+1)*B] = x[i*B:(i+1)*B]
    @ w[block_groups[i]] (+ bias[block_groups[i]])``, B = ``block_rows``.

    Args:
        x: (M, D) rows sorted by group, M a multiple of ``block_rows``.
        w: (E, D, H), contiguous or the transpose view of a contiguous
            (E, H, D) tensor (the dx pass reads ``wᵀ`` with no copy).
        block_groups: (M // block_rows,) int32 group id per row block, each
            in [0, E) (a device tensor: not range-checked, which would
            cost a host sync).
        n_live_blocks: int32 device scalar (or an int); blocks at index >=
            this are written as zeros and issue no product.
        bias: optional (E, H), added in float32 before rounding.
        block_rows: any positive multiple of 8.
        activation: optional element-wise callable applied in the kernel to
            the float32 ``acc + bias`` before rounding (dead blocks stay
            zeros).  On a CUDA tensor one of :data:`ACTIVATIONS`'s callables
            (:func:`activation_name`; else ValueError); on a CPU tensor any.
            ``jax.nn.gelu`` is :func:`gelu_tanh`, not ``F.gelu``.
    Returns:
        (M, H) in ``out_dtype`` (default ``x.dtype``; float32 also taken).
    A CPU tensor takes :func:`gmm_plain`; a CUDA tensor launches the kernel
    that :func:`gmm_design` picks.  A launch with an activation also counts
    in ``gmm.launches_by_activation``.
    """
    out_dtype = out_dtype or x.dtype
    _check_layout(x.shape[0], block_rows, block_groups.shape[0])
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"w contraction dim {w.shape[1]} != x dim "
                         f"{x.shape[1]}")
    if x.device.type == "cpu":
        return gmm_plain(x, w, block_groups, n_live_blocks, bias=bias,
                         block_rows=block_rows, out_dtype=out_dtype,
                         activation=activation)
    act = None if activation is None else activation_name(activation)
    w_nk = _check_operands(x, w, block_groups, bias, out_dtype)
    m, d = x.shape
    e, _, h = w.shape
    n_live = torch.as_tensor(n_live_blocks, dtype=torch.int32,
                             device=x.device).reshape(1)
    design = _pick_design(_older, x.dtype, block_rows, d, h, x, w)
    out = torch.empty((m, h), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    err = lib.gmm_launch(x.data_ptr(), w.data_ptr(),
                         bias.data_ptr() if bias is not None else None,
                         block_groups.data_ptr(), n_live.data_ptr(),
                         out.data_ptr(), m, d, h, e, block_rows, int(w_nk),
                         int(x.dtype == torch.bfloat16),
                         int(out_dtype == torch.float32),
                         DESIGNS.index(design), ACTIVATIONS.get(act, 0),
                         _stream(x))
    _build.check(lib, _LIB, err, "gmm")
    gmm.launches += 1
    gmm.launches_by_design[design] += 1
    if act is not None:
        gmm.launches_by_activation[act] += 1
    return out


gmm.launches = 0
gmm.launches_by_design = dict.fromkeys(DESIGNS, 0)
gmm.launches_by_activation = dict.fromkeys(ACTIVATIONS, 0)


def tgmm(x, dy, block_groups, n_groups: int, *, block_rows: int = 512,
         with_rowsum: bool = False, out_dtype=None, n_live_blocks=None,
         _older=False):
    """K4: transposed grouped matmul ``dw[e] = sum over e's row blocks of
    x_blkᵀ @ dy_blk`` (+ ``db[e]``, the row sums of e's ``dy``, with
    ``with_rowsum``).

    ``block_groups`` must be non-decreasing (rows sorted by group).  With
    ``n_live_blocks``, blocks from that index on (the all-zero tail the MoE
    layer allocates) are left out.  A group with no rows gets zeros —
    unlike the TPU kernel, which leaves it unwritten.  Each output tile is
    summed by one CUDA block looping over its group's own rows: no split
    over rows, no atomics, deterministic.  The kernel is the one
    :func:`gmm_design` picks for (block_rows, D, H).

    Returns ``dw`` (E, D, H) [, ``db`` (E, H)] in ``out_dtype`` (default
    ``x.dtype``).  A CPU tensor takes :func:`tgmm_plain`."""
    out_dtype = out_dtype or x.dtype
    m, d = x.shape
    _check_layout(m, block_rows, block_groups.shape[0])
    if dy.shape[0] != m:
        raise ValueError(f"x rows {m} != dy rows {dy.shape[0]}")
    if x.device.type == "cpu":
        return tgmm_plain(x, dy, block_groups, n_groups,
                          block_rows=block_rows, with_rowsum=with_rowsum,
                          out_dtype=out_dtype, n_live_blocks=n_live_blocks)
    _check_tgmm_operands(x, dy, block_groups, out_dtype)
    h = dy.shape[1]
    design = _pick_design(_older, x.dtype, block_rows, d, h, x, dy)
    n_live = (None if n_live_blocks is None else torch.as_tensor(
        n_live_blocks, dtype=torch.int32, device=x.device).reshape(1))
    # the kernel's row offsets (group_offsets), written by the library on
    # the launch's stream just before the kernel
    offsets = torch.empty(n_groups + 1, dtype=torch.int32, device=x.device)
    dw = torch.empty((n_groups, d, h), dtype=out_dtype, device=x.device)
    db = (torch.empty((n_groups, h), dtype=out_dtype, device=x.device)
          if with_rowsum else None)
    if dw.numel() == 0:
        return (dw, db) if with_rowsum else dw
    lib = _lib()
    err = lib.tgmm_launch(x.data_ptr(), dy.data_ptr(), block_groups.data_ptr(),
                          n_live.data_ptr() if n_live is not None else None,
                          offsets.data_ptr(), dw.data_ptr(),
                          db.data_ptr() if db is not None else None,
                          m, n_groups, d, h, block_rows,
                          int(x.dtype == torch.bfloat16),
                          int(out_dtype == torch.float32),
                          DESIGNS.index(design), _stream(x))
    _build.check(lib, _LIB, err, "tgmm")
    tgmm.launches += 1
    tgmm.launches_by_design[design] += 1
    return (dw, db) if with_rowsum else dw


tgmm.launches = 0
tgmm.launches_by_design = dict.fromkeys(DESIGNS, 0)


def _pair():
    return (gmm_plain, tgmm_plain) if _plain_selected() else (gmm, tgmm)


class _GroupedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, block_groups, n_live_blocks, block_rows):
        fwd, _ = _pair()
        ctx.save_for_backward(x, w, block_groups, n_live_blocks)
        ctx.block_rows = block_rows
        ctx.has_bias = bias is not None
        return fwd(x, w, block_groups, n_live_blocks, bias=bias,
                   block_rows=block_rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, bg, n_live = ctx.saved_tensors
        b = ctx.block_rows
        e, d, h = w.shape
        fwd, bwd = _pair()
        dy = dy.contiguous()
        dx = fwd(dy, w.transpose(1, 2), bg, n_live, block_rows=b,
                 out_dtype=x.dtype)
        db = None
        if d <= h:
            dw, db = bwd(x, dy, bg, e, block_rows=b, with_rowsum=True,
                         out_dtype=w.dtype, n_live_blocks=n_live)
        else:
            # x wider than dy (the down-projection w2): the transposed
            # product with the narrow operand as x, swapped back — the JAX
            # package's VJP, kept so both compute the same products
            dw = bwd(dy, x, bg, e, block_rows=b, out_dtype=w.dtype,
                     n_live_blocks=n_live).transpose(1, 2)
            if ctx.has_bias:
                # per-group row sums of dy: block sums, then a segment sum
                # over the sorted blocks as one product (no atomics)
                nb = dy.shape[0] // b
                blk = dy.float().reshape(nb, b, h).sum(1)
                db = (_group_onehot(bg, e) @ blk).to(w.dtype)
        return dx, dw, db if ctx.has_bias else None, None, None, None


def grouped_linear(x, w, bias, block_groups, n_live_blocks,
                   block_rows: int = 512):
    """Differentiable grouped linear: :func:`gmm` ``(x, w) + bias[group]``.

    Backward: dx is :func:`gmm` of dy against ``wᵀ``; dw and db are
    :func:`tgmm` with the row sum when D <= H, and when D > H dw is
    ``tgmm(dy, x)`` swapped and db a segment sum of dy over the sorted
    blocks.  Rows must be sorted by group into block-aligned segments with
    all-zero padding rows; a group with no rows gets zero gradients (the
    kernel writes zeros, where the JAX package masks them).  Integer
    arguments take no gradient.  ``bias`` may be None."""
    n_live = torch.as_tensor(n_live_blocks, dtype=torch.int32,
                             device=x.device).reshape(1)
    return _GroupedLinear.apply(x, w, bias, block_groups, n_live,
                                block_rows)
