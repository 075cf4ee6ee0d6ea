"""Mixture-of-Experts layer — counterpart of ``tpu_dist/nn/moe.py``
(``dispatch="dropless"``).

Top-k routing over stacked expert FFNs, MegaBlocks-style: the (choice,
token) rows are sorted by expert into segments padded to a row-block size,
and each expert runs over its exact segment through the grouped-matmul
kernels (:mod:`tpu_dist_torch.ops.gmm`).  No capacity, no dropped tokens, and
a token's output never depends on the other tokens in the call.

- Parameters keep the JAX package's layout, which is the layout the kernels
  take: ``router`` (d, E), ``w1`` (E, d, h), ``b1`` (E, h), ``w2`` (E, h, d),
  ``b2`` (E, d).
- Routing: softmax router, top-k by a stable descending sort (``lax.top_k``
  puts the lower expert first on ties; under bf16, router probabilities tie
  often, and ``torch.topk`` on CUDA promises no order), optional gate
  renormalization, and each row's rank at its expert from an integer cumsum
  (a bf16 cumsum would mis-slot rows past 256).
- Every shape is static — the row count is the bound ``(ceil(kN/b) + E)·b``
  — and the kernels read the block→expert map from device memory, so no step
  waits on the host.
- Dispatch and combine are row gathers whose backward passes are gathers by
  the opposite map: no scatter-add, so the backward is deterministic.
- The expert FFN is ``gelu`` in its tanh form between two grouped linears,
  as ``jax.nn.gelu`` is by default (the dense MLP uses the exact erf form).
- The Switch load-balancing loss ``E · Σ_e f_e · p_e`` over first choices is
  kept, in PyTorch's idiom, as the layer's ``aux_loss`` attribute after each
  forward, differentiable through the router; the DDP wrapper collects it
  into ``TrainState.model_state`` and does not add it to the objective, as
  in the JAX package.

The ``"einsum"`` and ``"gather"`` (capacity) dispatches come with a later
slice of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from . import init as init_lib
from ..ops._build import resolve_device
from ..ops.gmm import ceil_to, grouped_linear

__all__ = ["MoELayer"]


class _DispatchRows(torch.autograd.Function):
    """xt (N, d) → rows (M, d): row ``token_for_row[r]`` of xt, zeros where
    it is N (padding).  Backward: ``grad_xt[i] = Σ_j g[slot[j, i]]``, a
    gather by the forward map."""

    @staticmethod
    def forward(ctx, xt, token_for_row, slot):
        ctx.save_for_backward(slot)
        pad = torch.cat([xt, xt.new_zeros(1, xt.shape[1])])
        return pad.index_select(0, token_for_row)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        gx = g.index_select(0, slot.reshape(-1)).reshape(*slot.shape,
                                                          g.shape[1])
        return gx.sum(0), None, None


class _CombineRows(torch.autograd.Function):
    """y (N, d) = Σ_j w[j, i] · out[slot[j, i]].  ``choice_for_row`` (M,)
    is the inverse of ``slot``: the flat (choice-major) index in each row,
    kN for padding — the backward inverts the gy and w lookups with it, as
    gathers."""

    @staticmethod
    def forward(ctx, out, w, choice_for_row, slot):
        k, n = slot.shape
        ctx.save_for_backward(out, w, choice_for_row, slot)
        g = out.index_select(0, slot.reshape(-1)).reshape(k, n, out.shape[1])
        return (g * w[:, :, None].to(g.dtype)).sum(0)

    @staticmethod
    def backward(ctx, gy):
        out, w, choice_for_row, slot = ctx.saved_tensors
        k, n = slot.shape
        d = out.shape[1]
        # grad_out[r] = w[choice(r)] · gy[token(r)]; padding rows hit the
        # appended zero rows of both lookups
        token_for_row = torch.where(choice_for_row == k * n, n,
                                    choice_for_row % n)
        gy_pad = torch.cat([gy, gy.new_zeros(1, d)])
        w_pad = torch.cat([w.reshape(-1), w.new_zeros(1)])
        g_out = (w_pad[choice_for_row][:, None].to(gy.dtype)
                 * gy_pad.index_select(0, token_for_row))
        # grad_w[j, i] = <gy[i], out[slot[j, i]]>
        rows = out.index_select(0, slot.reshape(-1)).reshape(k, n, d)
        g_w = (rows * gy[None].to(rows.dtype)).sum(-1)
        return g_out, g_w.to(w.dtype), None, None


def _one_hot(idx, n: int):
    """int64 one-hot of ``idx`` by comparison: ``F.one_hot`` on CUDA reads
    the indices' range back to the host, which would stall every step."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _top_k(probs, k: int):
    """Top ``k`` values and indices, the lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class MoELayer(torch.nn.Module):
    """Top-k routed mixture of expert FFNs (drop-in for a transformer MLP).

    Args:
        dim: model width.
        num_experts: E.
        hidden: expert FFN hidden width (default ``4 * dim``).
        top_k: experts consulted per token.
        capacity_factor: kept for the JAX signature; the dropless dispatch
            has no capacity and ignores it.
        normalize_gates: renormalize the k selected gates to sum to 1.
        dispatch: ``"dropless"``; ``"einsum"`` and ``"gather"`` raise
            ``NotImplementedError`` until their slice is ported.

    After each forward, ``aux_loss`` holds the Switch load-balancing loss
    and ``routing`` the last call's ``gate_idx`` (N, k), ``counts`` (E,),
    ``block_groups`` and ``n_live_blocks`` (the kernels' block map)."""

    def __init__(self, dim: int, num_experts: int, hidden: int = 0,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 normalize_gates: bool = True, dispatch: str = "einsum",
                 device=None):
        super().__init__()
        if num_experts < 2:
            raise ValueError(f"num_experts must be >= 2, got {num_experts}")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} not in [1, {num_experts}]")
        if dispatch in ("einsum", "gather"):
            raise NotImplementedError(
                f"dispatch={dispatch!r} (the capacity formulation) comes with "
                f"a later slice of the port (ROADMAP A7); use "
                f"dispatch='dropless'")
        if dispatch != "dropless":
            raise ValueError(f"dispatch must be 'einsum', 'gather', or "
                             f"'dropless', got {dispatch!r}")
        device = resolve_device(device)
        self.dim = dim
        self.num_experts = num_experts
        self.hidden = hidden or 4 * dim
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.normalize_gates = normalize_gates
        self.dispatch = dispatch
        e, d, h = num_experts, dim, self.hidden

        def param(*shape):
            return torch.nn.Parameter(torch.empty(*shape, device=device))

        self.router = param(d, e)
        self.w1, self.b1 = param(e, d, h), param(e, h)
        self.w2, self.b2 = param(e, h, d), param(e, d)
        self.aux_loss = None
        self.routing = None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # kaiming_uniform per expert: a stacked (E, in, out) weight gets the
        # bound an (in, out) Linear would
        init_lib.kaiming_uniform(self.router, self.dim, generator=generator)
        for w, fan_in in ((self.w1, self.dim), (self.w2, self.hidden)):
            bound = math.sqrt(6.0 / fan_in)
            init_lib.uniform(w, -bound, bound, generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x):
        e, k = self.num_experts, self.top_k
        lead, d = x.shape[:-1], x.shape[-1]
        xt = x.reshape(-1, d)
        n = xt.shape[0]

        probs = torch.softmax(xt @ self.router, dim=-1)          # (N, E)
        gate_vals, gate_idx = _top_k(probs, k)                   # (N, k)
        if self.normalize_gates and k > 1:
            gate_vals = gate_vals / gate_vals.sum(
                -1, keepdim=True).clamp_min(1e-9)

        # each (choice, token) row's arrival rank at its expert, choices in
        # priority order (all first choices, then all second ...): the
        # cumsum of the one-hots, in int32.  Expert-major (E, kN), so the
        # scan runs along the contiguous axis: a scan down the 8 columns of
        # a (kN, E) tensor measured 5.7 ms a layer on an H100
        experts = torch.arange(e, device=xt.device)[:, None]
        oh = (gate_idx.T.reshape(1, -1) == experts).to(torch.int32)  # (E, kN)
        rank = ((torch.cumsum(oh, 1, dtype=torch.int32) - oh) * oh).sum(
            0, dtype=torch.int32).reshape(k, n)
        counts = oh.sum(1, dtype=torch.int32)                    # (E,)
        y = self._forward_dropless(xt, gate_vals, gate_idx, rank, counts)

        # Switch load-balance loss on first-choice assignments
        frac = _one_hot(gate_idx[:, 0], e).to(xt.dtype).mean(0)
        self.aux_loss = e * (frac * probs.mean(0)).sum()
        return y.reshape(*lead, d)

    def _forward_dropless(self, xt, gate_vals, gate_idx, rank, counts):
        e, k = self.num_experts, self.top_k
        n = xt.shape[0]
        kn = k * n
        # row-block size and the static row bound, as in the JAX package
        b = min(512, ceil_to(max(kn // e, 1), 8))
        m_rows = (-(-kn // b) + e) * b
        nb = m_rows // b

        # destination row of each (choice, token): its expert's
        # block-aligned segment start plus its rank there
        padded = (counts + b - 1) // b * b
        cum = padded.cumsum(0)
        slot = (cum - padded)[gate_idx.T] + rank                 # (k, N)
        pos = slot.reshape(-1)
        flat_choice = torch.arange(kn, device=xt.device)
        token_for_row = torch.full((m_rows,), n, device=xt.device).scatter_(
            0, pos, flat_choice % n)
        choice_for_row = torch.full((m_rows,), kn,
                                    device=xt.device).scatter_(
            0, pos, flat_choice)
        n_live = (cum[-1:] // b).to(torch.int32)
        # block → expert; the tail past the live blocks is clamped to E-1
        # (zero rows that extend the last segment)
        bg = torch.searchsorted(cum, torch.arange(nb, device=xt.device) * b,
                                right=True).clamp_max(e - 1).to(torch.int32)
        self.routing = {"gate_idx": gate_idx.detach(), "counts": counts,
                        "block_groups": bg, "n_live_blocks": n_live}

        xs = _DispatchRows.apply(xt, token_for_row, slot)        # (M, d)
        hdn = grouped_linear(xs, self.w1, self.b1, bg, n_live, b)
        hdn = _F.gelu(hdn, approximate="tanh")
        out = grouped_linear(hdn, self.w2, self.b2, bg, n_live, b)
        return _CombineRows.apply(out, gate_vals.T, choice_for_row, slot)

    def extra_repr(self):
        return (f"{self.dim}, num_experts={self.num_experts}, "
                f"hidden={self.hidden}, top_k={self.top_k}, "
                f"dispatch={self.dispatch!r}")
