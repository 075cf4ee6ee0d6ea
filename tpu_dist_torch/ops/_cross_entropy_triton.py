"""Triton kernels K1f/K1b of :mod:`tpu_dist_torch.ops.cross_entropy`.

Imported only by the launch functions there, at first launch: the CPU has no
Triton, and the rest of the port must import without it.

Replaces ``_fwd_kernel``/``_call_fwd`` and ``_bwd_kernel``/``_call_bwd`` of
``tpu_dist/ops/cross_entropy.py``.  What bounds them on an H100: memory.  The
forward reads the (N, V) logits once (1.07 GB in bf16 at N = 16384,
V = 32768: ≈ 0.32 ms at 3.35 TB/s) and does a handful of operations per
element; the backward reads them once more and writes dlogits once (≈ 0.64
ms).  What the design does about it: the TPU kernel holds a whole padded
vocab row in VMEM, which does not fit a GPU block at LM vocab sizes, so here
one program sweeps its row in ``BLOCK_V`` chunks with an online max and sum
(one exp per element), reads ``logit[label]`` directly, and masks the
ragged tail, with no padding copy.  The backward is one program per (row,
chunk) and writes dlogits in the logits dtype.
"""

import triton
import triton.language as tl


@triton.jit
def cross_entropy_fwd_kernel(logits_ptr, labels_ptr, nll_ptr, lse_ptr, V,
                             stride, BLOCK_V: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    base = logits_ptr + row * stride
    cols = tl.arange(0, BLOCK_V)
    x = tl.load(base + cols, mask=cols < V, other=float("-inf")).to(tl.float32)
    m = tl.max(x, axis=0)
    s = tl.sum(tl.exp(x - m), axis=0)
    for start in range(BLOCK_V, V, BLOCK_V):
        idx = start + cols
        x = tl.load(base + idx, mask=idx < V,
                    other=float("-inf")).to(tl.float32)
        m_new = tl.maximum(m, tl.max(x, axis=0))
        s = s * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new), axis=0)
        m = m_new
    lse = m + tl.log(s)
    label = tl.load(labels_ptr + row)
    # a label outside [0, V) picks nothing (nll = lse), as in the TPU kernel
    ok = (label >= 0) & (label < V)
    picked = tl.load(base + tl.where(ok, label, 0)).to(tl.float32)
    tl.store(nll_ptr + row, lse - tl.where(ok, picked, 0.0))
    tl.store(lse_ptr + row, lse)


@triton.jit
def cross_entropy_bwd_kernel(logits_ptr, labels_ptr, lse_ptr, g_ptr,
                             dlogits_ptr, V, stride, BLOCK_V: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
    mask = cols < V
    x = tl.load(logits_ptr + row * stride + cols, mask=mask,
                other=0.0).to(tl.float32)
    lse = tl.load(lse_ptr + row)
    g = tl.load(g_ptr + row)
    label = tl.load(labels_ptr + row)
    p = tl.exp(x - lse)
    p = tl.where(cols == label, p - 1.0, p)
    tl.store(dlogits_ptr + row * stride + cols,
             (p * g).to(dlogits_ptr.dtype.element_ty), mask=mask)
