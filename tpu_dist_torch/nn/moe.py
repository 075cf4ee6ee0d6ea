"""Mixture-of-Experts layer — counterpart of ``tpu_dist/nn/moe.py``.

Top-k routing over stacked expert FFNs, with the JAX package's three
dispatches (``dispatch=``):

- ``"einsum"`` (the default in both packages) and ``"gather"``: the
  GShard/Switch capacity formulation.  Each (choice, token) gets its
  arrival rank at its expert; ranks at or past the capacity ``C = max(1,
  min(ceil(k·N/E · capacity_factor), N))`` are dropped (combine weight 0,
  so the surrounding residual carries the token).  ``"einsum"`` builds the
  dense ``(N, E, C)`` dispatch and combine tensors from one-hots in the
  compute dtype and contracts them with plain products; ``"gather"``
  moves rows by the slot maps, both backward passes gathers by the
  opposite map.  The two give the same outputs but for the rounding of
  the combine.  The expert FFNs are batched products over the padded
  ``(E, C, d)`` rows.
- ``"dropless"``: MegaBlocks-style, the (choice, token) rows sorted by
  expert into segments padded to a row-block size, each expert run over
  its exact segment through the grouped-matmul kernels
  (:mod:`tpu_dist_torch.ops.gmm`).  No capacity, no dropped tokens, and a
  token's output never depends on the other tokens in the call.

Shared by all three:

- Parameters keep the JAX package's layout, which is the layout the kernels
  take: ``router`` (d, E), ``w1`` (E, d, h), ``b1`` (E, h), ``w2`` (E, h, d),
  ``b2`` (E, d).
- Routing: softmax router, top-k by a stable descending sort (``lax.top_k``
  puts the lower expert first on ties; under bf16, router probabilities tie
  often, and ``torch.topk`` on CUDA promises no order), optional gate
  renormalization, and each row's rank at its expert from an integer cumsum
  (a bf16 cumsum would mis-slot rows past 256).
- Every shape is static, and no step waits on the host.
- The expert FFN is ``gelu`` in its tanh form between two linears, as
  ``jax.nn.gelu`` is by default (the dense MLP uses the exact erf form).
- The Switch load-balancing loss ``E · Σ_e f_e · p_e`` over first choices is
  kept, in PyTorch's idiom, as the layer's ``aux_loss`` attribute after each
  forward, differentiable through the router; the DDP wrapper collects it
  into ``TrainState.model_state`` and does not add it to the objective, as
  in the JAX package.

**Under an expert axis** (``expert_axis=``: a mesh axis of the default
process group, ``"expert"`` of ``parallel/gspmd.py``'s ``("data",
"expert")`` mesh; the global batch is split over its ``"data"`` axis).
The JAX package runs this layer as one global program that XLA
partitions: the batch is split over ``data`` only, so the ranks of an
expert line hold the same rows, and routing, capacity and the aux loss
span the global batch.  The port keeps that function:

- the layer holds only its rank's E/ep experts (``w1`` … ``b2`` have a
  leading dim of E/ep; the router is replicated);
- each (choice, token)'s arrival rank is the global choice-major cumsum's:
  every shard's (k, E) choice counts are gathered over the ``data`` line
  and shift this shard's own ranks, and ``C = _capacity(dp · N_local)``.
  So a token of shard 1 drops when shard 0 filled its expert;
- the rank runs its experts over its kept rows (either capacity dispatch)
  and the partial outputs are summed over the ``expert`` line;
- autograd: that sum has an identity backward; the layer input that feeds
  the dispatch and the router's gates have an identity forward and a
  backward summed over the ``expert`` line; the aux loss takes the router
  probabilities apart from the gates, so the objective counts it once.
  With the step's gradient average (``gspmd.py``) every gradient is the
  global step's;
- ``aux_loss`` is the global one (first-choice shares and mean
  probabilities averaged over the ``data`` line; its gradient is this
  shard's share); the capacity dispatches' ``routing["counts"]`` and
  ``["dropped"]`` are global;
- ``dispatch="dropless"`` with more than one expert rank raises
  :class:`ExpertAxisError`: the JAX package has no such path (its Pallas
  grouped matmul cannot be partitioned).

At an expert axis of size 1 and a data axis of size 1 the layer computes
what it computes with no mesh.  Every collective is an all-reduce or an
all-gather (``tpu_dist_torch/collectives/ops.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as _F

from . import init as init_lib
from ..collectives import ops as _ops
from ..ops._build import resolve_device
from ..ops.gmm import ceil_to, grouped_linear
from .tensor_parallel import SumGradOverLine, SumOverLine

__all__ = ["MoELayer", "ExpertAxisError"]


class ExpertAxisError(ValueError):
    """A layer that an expert axis cannot split: the dropless dispatch over
    more than one expert rank, or an expert count that the axis does not
    divide."""


def _mesh_lines(expert_axis):
    """``(expert line, data line)`` of this rank for ``expert_axis`` of the
    default process group (the data line of size 1 on a mesh without a
    ``"data"`` axis), else ``(None, None)``."""
    if expert_axis is None:
        return None, None
    from .. import dist
    expert = dist.axis_group(expert_axis)
    if (dist.is_initialized()
            and dist.DATA_AXIS in dist.get_default_group().axis_names):
        return expert, dist.axis_group(dist.DATA_AXIS)
    return expert, dist.AxisGroup(dist.DATA_AXIS, 1, 0,
                                   (expert.ranks[expert.index],))


class _DispatchRows(torch.autograd.Function):
    """xt (N, d) → rows (M, d): row ``token_for_row[r]`` of xt, zeros where
    it is N (padding).  Backward: ``grad_xt[i] = Σ_j g[slot[j, i]]``, a
    gather by the forward map (the capacity dispatch's last row is the
    zero row that dropped choices point at)."""

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
        dispatch: ``"einsum"`` (dense dispatch and combine tensors),
            ``"gather"`` (row gathers by the slot maps) or ``"dropless"``
            (the grouped-matmul kernels; ``capacity_factor`` is ignored).
        expert_axis: a mesh axis of the default process group that splits
            the experts (see the module docstring), or None.

    After each forward, ``aux_loss`` holds the Switch load-balancing loss
    and ``routing`` the last call's ``gate_idx`` (N, k) and ``counts``
    (E,), the choices routed to each expert; the capacity dispatches add
    ``capacity`` and ``dropped`` (choices past it, an int64 0-d tensor),
    the dropless one ``block_groups`` and ``n_live_blocks`` (the kernels'
    block map).  Both attributes are what :func:`~tpu_dist_torch.nn.
    checkpoint` keeps from the first forward (``forward_state``).
    ``local_experts`` and ``first_expert`` are the experts this rank holds
    (all E and 0 without an expert axis); ``data_line`` is the mesh line
    its expert banks' gradients are averaged over (``parallel/gspmd.py``)."""

    forward_state = ("aux_loss", "routing")

    def __init__(self, dim: int, num_experts: int, hidden: int = 0,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 normalize_gates: bool = True, dispatch: str = "einsum",
                 device=None, expert_axis: Optional[str] = None):
        super().__init__()
        if num_experts < 2:
            raise ValueError(f"num_experts must be >= 2, got {num_experts}")
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} not in [1, {num_experts}]")
        if dispatch not in ("einsum", "gather", "dropless"):
            raise ValueError(f"dispatch must be 'einsum', 'gather', or "
                             f"'dropless', got {dispatch!r}")
        self.expert_line, self.data_line = _mesh_lines(expert_axis)
        ep = 1 if self.expert_line is None else self.expert_line.size
        self._dp = 1 if self.data_line is None else self.data_line.size
        if num_experts % ep:
            raise ExpertAxisError(f"{num_experts} experts do not split over "
                                  f"an expert axis of {ep}")
        if dispatch == "dropless" and ep > 1:
            raise ExpertAxisError(
                "dispatch='dropless' under an expert axis of size "
                f"{ep}: the JAX package has no such path (its grouped "
                "matmul cannot be partitioned); use 'gather' or 'einsum'")
        device = resolve_device(device)
        self.dim = dim
        self.num_experts = num_experts
        self.hidden = hidden or 4 * dim
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.normalize_gates = normalize_gates
        self.dispatch = dispatch
        self.local_experts = num_experts // ep
        self.first_expert = (0 if ep == 1 else
                             self.expert_line.index * self.local_experts)
        e, el, d, h = num_experts, self.local_experts, dim, self.hidden

        def param(*shape):
            return torch.nn.Parameter(torch.empty(*shape, device=device))

        self.router = param(d, e)
        self.w1, self.b1 = param(el, d, h), param(el, h)
        self.w2, self.b2 = param(el, h, d), param(el, d)
        self.aux_loss = None
        self.routing = None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # kaiming_uniform per expert: a stacked (E, in, out) weight gets the
        # bound an (in, out) Linear would.  Under an expert axis the whole
        # bank is drawn and this rank keeps its slice, so a seed gives every
        # rank the unsplit layer's experts
        init_lib.kaiming_uniform(self.router, self.dim, generator=generator)
        e0, el = self.first_expert, self.local_experts
        for w, fan_in in ((self.w1, self.dim), (self.w2, self.hidden)):
            bound = math.sqrt(6.0 / fan_in)
            full = (w if el == self.num_experts else
                    w.new_empty((self.num_experts,) + tuple(w.shape[1:])))
            with torch.no_grad():
                init_lib.uniform(full, -bound, bound, generator)
                if full is not w:
                    w.copy_(full[e0:e0 + el])
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
        sharded = self.local_experts < e
        if sharded:
            # each rank's gate gradients are 0 on the other ranks' choices,
            # so their sum is the unsplit layer's, bit for bit
            gate_vals = SumGradOverLine.apply(gate_vals, self.expert_line)

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
        if self.dispatch == "dropless":
            y = self._forward_dropless(xt, gate_vals, gate_idx, rank, counts)
        else:
            y = self._forward_capacity(
                SumGradOverLine.apply(xt, self.expert_line) if sharded
                else xt,
                gate_vals, gate_idx, rank, oh, counts)
            if sharded:
                y = SumOverLine.apply(y, self.expert_line)

        # Switch load-balance loss on first-choice assignments; over a data
        # axis the global shares, with this shard's probabilities carrying
        # the gradient (the step averages it over the data line)
        frac = _one_hot(gate_idx[:, 0], e).to(xt.dtype).mean(0)
        p_mean = probs.mean(0)
        if self._dp > 1:
            both = _ops.psum(torch.stack([frac, p_mean.detach()]),
                             self.data_line) / self._dp
            frac = both[0]
            p_mean = p_mean + (both[1] - p_mean).detach()
        self.aux_loss = e * (frac * p_mean).sum()
        return y.reshape(*lead, d)

    def _global_ranks(self, rank, gate_idx, oh, counts):
        """Each (choice, token)'s arrival rank over the global batch and the
        global choices an expert: this shard's ranks shifted by the choices
        that come before them in the global choice-major order (earlier
        choices of every shard, then the same choice of earlier shards),
        from every shard's (k, E) counts gathered over the data line."""
        if self._dp == 1:
            return rank, counts
        e, k = self.num_experts, self.top_k
        n = gate_idx.shape[0]
        mine = oh.reshape(e, k, n).sum(-1, dtype=torch.int32).T  # (k, E)
        every = _ops.all_gather(mine.contiguous(),
                                self.data_line)                  # (dp, k, E)
        total = every.sum(0, dtype=torch.int32)

        def before(t):  # exclusive cumsum over the choices
            return torch.cumsum(t, 0, dtype=torch.int32) - t

        shift = (before(total) - before(mine)
                 + every[:self.data_line.index].sum(0, dtype=torch.int32))
        return (rank + shift.gather(1, gate_idx.T),
                total.sum(0, dtype=torch.int32))

    def _capacity(self, n_tokens: int) -> int:
        c = math.ceil(self.top_k * n_tokens / self.num_experts
                      * self.capacity_factor)
        # an expert receives each token at most once (the top-k experts are
        # distinct), so a capacity past n_tokens would only pad
        return max(1, min(c, n_tokens))

    def _experts(self, xs):
        """This rank's expert FFNs over the padded rows ``xs`` (E, C, d)."""
        hdn = _F.gelu(torch.bmm(xs, self.w1) + self.b1[:, None, :],
                      approximate="tanh")
        return torch.bmm(hdn, self.w2) + self.b2[:, None, :]

    def _forward_capacity(self, xt, gate_vals, gate_idx, pos, oh, counts):
        """``pos``: each (choice, token)'s rank among this shard's choices
        of its expert, which is its row in this rank's slots: the global
        rank only grows along the shard's own order, so the rows the
        capacity keeps are a prefix of them."""
        e, k = self.num_experts, self.top_k
        el, e0 = self.local_experts, self.first_expert
        n, d = xt.shape
        rank, counts = self._global_ranks(pos, gate_idx, oh, counts)
        c = self._capacity(self._dp * n)
        cl = min(c, n)                   # this shard's slots an expert
        keep = rank < c                                          # (k, N)
        w = keep.to(xt.dtype) * gate_vals.T
        self.routing = {"gate_idx": gate_idx.detach(), "counts": counts,
                        "capacity": c,
                        "dropped": (counts - c).clamp_min(0).sum()}
        local = gate_idx.T - e0                # this rank's expert index
        if self.dispatch == "gather":
            # forward map (choice, token) → flat slot e·C + pos, dropped
            # choices (and other ranks' experts) at the zero row E·C; the
            # inverse by one int scatter into E·C + 1 entries, the last of
            # which is then emptied
            kn = k * n
            if el < e:
                keep = keep & (local >= 0) & (local < el)
            slot = torch.where(keep, local * cl + pos, el * cl)  # (k, N)
            choice_for_slot = torch.full(
                (el * cl + 1,), kn, device=xt.device).scatter_(
                0, slot.reshape(-1), torch.arange(kn, device=xt.device))
            choice_for_slot[-1] = kn
            token_for_slot = torch.where(choice_for_slot == kn, n,
                                         choice_for_slot % n)
            xs = _DispatchRows.apply(xt, token_for_slot, slot)   # (EC+1, d)
            out = self._experts(xs[:-1].reshape(el, cl, d))
            out = torch.cat([out.reshape(el * cl, d), out.new_zeros(1, d)])
            return _CombineRows.apply(out, w, choice_for_slot, slot)
        # einsum: the (N, E, C) one-hot tensors, built per choice and summed
        # over k as two products (a three-operand einsum could hold the
        # (k, N, E, C) product); each (n, e, c) has at most one term, and
        # other ranks' experts none
        onehot = (local[..., None] == torch.arange(
            el, device=xt.device)).to(xt.dtype)                  # (k, N, E)
        slot_oh = _one_hot(pos, cl).to(xt.dtype)                 # (k, N, C)
        dispatch_t = torch.einsum("kne,knc->nec", onehot,
                                  slot_oh * keep.to(xt.dtype)[..., None])
        combine_t = torch.einsum("kne,knc->nec", onehot,
                                 slot_oh * w[..., None])
        xs = dispatch_t.reshape(n, el * cl).T @ xt               # (E·C, d)
        out = self._experts(xs.reshape(el, cl, d))
        return combine_t.reshape(n, el * cl) @ out.reshape(el * cl, d)

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
