"""The port's activation checkpointing (``nn.checkpoint``, ``nn.Remat``,
``TransformerLM(remat=True)``) against the JAX package's ``jax.checkpoint``
and ``nn.Remat``, and against the port without remat.

Same numpy inputs; weights from the JAX ``init`` through
``load_jax_params``.  The recompute runs in backward, after the DDP's
``functional_call`` has ended, so these also hold that it binds the tensors
of the first forward (the compute-dtype casts), replays its dropout keys,
and leaves the first forward's MoE ``aux_loss``/``routing`` and BatchNorm
statistics in place.

Tolerances: against the JAX package, float32 with the same terms summed in
another order — logits, losses, aux losses and gradients 1e-5 relative plus
1e-5 absolute, parameters after SGD 1e-5 relative plus 2e-6 absolute, as in
``tests/test_torch_moe.py``.  Against the port without remat the recompute
runs the same kernels on the same inputs on the CPU, so results are held to
1e-6 relative plus 1e-7 absolute (float32) and to equality of every
bfloat16 leaf within one bfloat16 step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import nn as jnn
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.models.transformer import TransformerBlock as JaxBlock
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.models.transformer import TransformerBlock as TorchBlock
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

RTOL, ATOL = 1e-5, 1e-5
SAME = dict(rtol=1e-6, atol=1e-7)
VOCAB, T, BATCH = 53, 16, 4
BASE = dict(vocab_size=VOCAB, dim=32, depth=2, num_heads=4, max_seq_len=T)
KINDS = {"dense": {}, "llama": dict(norm="rmsnorm", rope=True),
         "moe_einsum": dict(num_experts=4, moe_capacity_factor=0.75),
         "moe_gather": dict(num_experts=4, moe_dispatch="gather",
                            moe_capacity_factor=0.75)}


def _tree(params):
    return {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32),
            rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32))


def _grads(model, x, y):
    out = model(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(
        out.reshape(-1, VOCAB), torch.from_numpy(y).long().reshape(-1))
    names = [k for k, _ in model.named_parameters()]
    return loss, dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()))))


@pytest.fixture(scope="module", params=sorted(KINDS))
def jax_remat(request):
    """The JAX ``TransformerLM(remat=True)``'s loss, gradients and new
    state (MoE aux losses) on one batch, with its initial params."""
    kw = {**BASE, **KINDS[request.param]}
    model = JaxLM(**kw, remat=True)
    params = model.init(jax.random.key(0))
    state0 = model.init_state()
    x, y = map(jnp.asarray, _batch())
    ce = jnn.CrossEntropyLoss()

    def objective(p):
        out, new_state = model.apply(p, x, state=state0, training=True)
        return ce(out, y), new_state

    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    return (request.param, kw, _tree(params), float(loss), _tree(grads),
            _tree(new_state))


def test_remat_gradients_match_jax_and_no_remat(jax_remat):
    kind, kw, params, loss_j, grads_j, state_j = jax_remat
    x, y = _batch()
    plain = load_jax_params(TorchLM(**kw, device="cpu"), params)
    remat = load_jax_params(TorchLM(**kw, remat=True, device="cpu"), params)
    assert ([k for k, _ in remat.named_parameters()]
            == [k for k, _ in plain.named_parameters()])  # paths unchanged
    loss_p, g_p = _grads(plain, x, y)
    loss_r, g_r = _grads(remat, x, y)
    np.testing.assert_allclose(float(loss_r), loss_j, rtol=RTOL)
    torch.testing.assert_close(loss_r, loss_p, **SAME)
    want = dict(load_jax_params(TorchLM(**kw, device="cpu"),
                                grads_j).named_parameters())
    for k, g in g_r.items():
        torch.testing.assert_close(g, g_p[k], **SAME, msg=k)
        np.testing.assert_allclose(g.numpy(), want[k].detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # the MoE aux losses left after backward are the first forward's
    for path, leaves in state_j.items():
        mlp = remat.get_submodule(path)
        np.testing.assert_allclose(float(mlp.aux_loss), leaves["aux_loss"],
                                   rtol=RTOL, err_msg=path)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_ddp_collects_the_first_forwards_aux_loss(dispatch):
    """Under remat the MoE forward runs again in backward; the DDP reads
    ``aux_loss`` after backward and must get the first forward's tensor,
    whose value the JAX step publishes."""
    kw = {**BASE, **KINDS[f"moe_{dispatch}"]}
    jm = JaxLM(**kw, remat=True)
    params = jm.init(jax.random.key(1))
    x, y = _batch(seed=2)
    _, new_state = jm.apply(params, jnp.asarray(x), state=jm.init_state(),
                            training=True)
    model = load_jax_params(TorchLM(**kw, remat=True, device="cpu"),
                            _tree(params))
    moes = {p: m for p, m in model.named_modules()
            if isinstance(m, tnn.MoELayer)}
    firsts = {}

    def record(mod, args, out):
        # the first call of each layer in the step is the forward proper
        firsts.setdefault(mod, (mod.aux_loss, mod.routing))

    hooks = [m.register_forward_hook(record) for m in moes.values()]
    ddp = TorchDDP(model, optimizer=toptim.SGD(lr=0.1),
                   loss_fn=tnn.CrossEntropyLoss())
    state = ddp.init(seed=0)
    load_jax_params(model, _tree(params))
    calls = {m: 0 for m in moes.values()}
    counters = [m.register_forward_pre_hook(
        lambda mod, a: calls.__setitem__(mod, calls[mod] + 1))
        for m in moes.values()]
    state, _ = ddp.train_step(state, torch.from_numpy(x),
                              torch.from_numpy(y))
    for h in hooks + counters:
        h.remove()
    for path, m in moes.items():
        assert calls[m] == 2                    # forward, then recompute
        assert m.aux_loss is firsts[m][0] and m.routing is firsts[m][1]
        np.testing.assert_allclose(float(state.model_state[path]["aux_loss"]),
                                   float(new_state[path]["aux_loss"]),
                                   rtol=RTOL, err_msg=path)


def test_remat_module_paths_and_parity_with_jax_remat():
    """``nn.Remat(block)``: the block under ``inner``, loaded from the JAX
    ``nn.Remat(block)``'s tree, its output and gradients the JAX ones."""
    jr = jnn.Remat(JaxBlock(32, 4, causal=True))
    params = jr.init(jax.random.key(3))
    assert all(p.startswith("inner.") for p in params)
    tr = tnn.Remat(TorchBlock(32, 4, causal=True, device="cpu"))
    assert all(k.startswith("inner.") for k, _ in tr.named_parameters())
    load_jax_params(tr, _tree(params))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    cot = rng.standard_normal((2, 10, 32)).astype(np.float32)

    def objective(p, x):
        return jnp.sum(jr.apply(p, x) * cot)

    gp, gx = jax.grad(objective, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tr(xt)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jr.apply(params, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    want = dict(load_jax_params(
        tnn.Remat(TorchBlock(32, 4, causal=True, device="cpu")),
        _tree(gp)).named_parameters())
    for k, p in tr.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    with torch.no_grad():                      # nothing to keep: plain call
        torch.testing.assert_close(tr(xt), tr.inner(xt), rtol=0, atol=0)


def test_remat_policy_is_refused():
    with pytest.raises(NotImplementedError, match="policy"):
        tnn.Remat(tnn.Linear(4, 4, device="cpu"), policy="dots_saveable")
    assert tnn.Remat(tnn.Linear(4, 4, device="cpu"), policy=None).policy \
        is None


def test_recompute_binds_the_ddp_bf16_casts():
    """bf16 compute over float32 masters: the recompute sees the casts the
    DDP bound for the forward (not the module's float32 masters), so a
    remat step equals the step without remat."""
    kw = {**BASE, **KINDS["moe_gather"]}
    x, y = _batch(seed=5)
    results = []
    for remat in (False, True):
        model = TorchLM(**kw, remat=remat, device="cpu")
        ddp = TorchDDP(model, optimizer=toptim.SGD(lr=0.1),
                       loss_fn=tnn.CrossEntropyLoss(),
                       compute_dtype=torch.bfloat16)
        state = ddp.init(seed=0)
        state, m = ddp.train_step(state, torch.from_numpy(x),
                                  torch.from_numpy(y))
        results.append((m["loss"], state.params, state.model_state))
    (l0, p0, s0), (l1, p1, s1) = results
    torch.testing.assert_close(l1, l0, rtol=2.0 ** -8, atol=0)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], **SAME, msg=k)
    for path in s0:
        torch.testing.assert_close(s1[path]["aux_loss"],
                                   s0[path]["aux_loss"], rtol=0, atol=0)


def test_recompute_replays_dropout_and_keeps_batchnorm_statistics():
    """Dropout draws from the first forward's keys again (the gradients
    equal the call without remat); a BatchNorm's running statistics move
    once, not twice."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 6, 6, generator=g)
    cot = torch.randn(4, 12, generator=g)

    def net():
        torch.manual_seed(0)
        m = tnn.Sequential(tnn.Conv2d(3, 4, 3, device="cpu"),
                           tnn.BatchNorm2d(4, device="cpu"), tnn.ReLU(),
                           tnn.Flatten(), tnn.Linear(64, 12, device="cpu"),
                           tnn.Dropout(0.5))
        tnn.reset_parameters(m, torch.Generator().manual_seed(1))
        return m.train()

    outs = []
    for wrap in (False, True):
        m = net()
        run = tnn.Remat(m) if wrap else m
        xr = x.clone().requires_grad_(True)
        with tnn.rng_scope(np.array([0, 7], np.int64)):
            y = run(xr)
            (y * cot).sum().backward()
        outs.append((y.detach(), xr.grad, [p.grad for p in m.parameters()],
                     m[1].running_mean.clone(), m[1].running_var.clone()))
    (y0, gx0, gp0, rm0, rv0), (y1, gx1, gp1, rm1, rv1) = outs
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    torch.testing.assert_close(gx1, gx0, **SAME)
    for a, b in zip(gp1, gp0):
        torch.testing.assert_close(a, b, **SAME)
    torch.testing.assert_close(rm1, rm0, rtol=0, atol=0)
    torch.testing.assert_close(rv1, rv0, rtol=0, atol=0)


def test_remat_is_off_when_decoding():
    """A cache passed (generate, the slot pool) runs the blocks plainly:
    the same tokens as the model without remat."""
    jm = JaxLM(**BASE, **KINDS["llama"])
    params = _tree(jm.init(jax.random.key(6)))
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, VOCAB, (2, 5)))
    got = [load_jax_params(TorchLM(**BASE, **KINDS["llama"], remat=r,
                                   device="cpu"), params).generate(prompt, 6)
           for r in (False, True)]
    assert torch.equal(got[0], got[1])
