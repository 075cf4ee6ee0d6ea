"""The port's TransformerLM and DDP train step against the JAX package's.

Weights move from ``tpu_dist`` to ``tpu_dist_torch`` with
``tpu_dist_torch.interop.load_jax_params``.  Both sides run float32 with
``attention_impl("flash")`` and the fused cross-entropy: on the JAX side the
Pallas kernels in interpret mode inside its DDP ``shard_map`` over conftest's
8-device CPU mesh (global batch 8, one row per device: its pmean of
per-device gradients equals one step on the whole batch), on the port's side
the plain versions at world 1.

Tolerances: float32, with the same terms summed in another order through a
2-layer model — 1e-5 relative on the logits and losses; the parameters after
SGD with momentum, 1e-5 relative plus 2e-6 absolute (lr x the gradient
differences, compounded over the steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist.dist as jdist
from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.nn.attention import attention_impl as jax_attention_impl
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

torch.backends.cuda.matmul.allow_tf32 = False

VOCAB, DIM, DEPTH, HEADS, T, BATCH = 257, 64, 2, 4, 24, 8
STEPS = 3
OPT = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, nesterov=True)


def _numpy_tree(tree):
    return {path: {k: np.array(a) for k, a in leaves.items()}
            for path, leaves in tree.items()}


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32)
    y = rng.integers(0, VOCAB, (BATCH, T)).astype(np.int32)
    return x, y


def _torch_model(params):
    model = TorchLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                    max_seq_len=T, device="cpu")
    return load_jax_params(model, params)


@pytest.fixture(scope="module")
def jax_run():
    """Initial params, logits, then each DDP step's loss, correct count and
    params, from the JAX package."""
    x, y = _batch()
    model = JaxLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                  max_seq_len=T)
    if jdist.is_initialized():
        jdist.destroy_process_group()
    pg = jdist.init_process_group(backend="cpu")
    try:
        ddp = JaxDDP(model, optimizer=joptim.SGD(**OPT),
                     loss_fn=jnn.CrossEntropyLoss(fused=True), group=pg)
        state = ddp.init(seed=0)
        params0 = _numpy_tree(state.params)
        steps = []
        with jax_attention_impl("flash"):
            logits = np.asarray(model.apply(state.params, jnp.asarray(x)))
            for _ in range(STEPS):
                state, m = ddp.train_step(state, jnp.asarray(x),
                                          jnp.asarray(y))
                steps.append((float(m["loss"]), int(m["correct"]),
                              _numpy_tree(state.params)))
    finally:
        jdist.destroy_process_group()
    return params0, logits, steps


def test_load_jax_params_maps_every_leaf(jax_run):
    params0, _, _ = jax_run
    model = _torch_model(params0)
    ours = {k: p.detach() for k, p in model.named_parameters()}
    np.testing.assert_array_equal(ours["block0.attn.qkv_weight"].numpy(),
                                  params0["block0.attn"]["qkv_weight"].T)
    np.testing.assert_array_equal(ours["block1.mlp.2.weight"].numpy(),
                                  params0["block1.mlp.2"]["weight"].T)
    np.testing.assert_array_equal(ours["pos.weight"].numpy(),
                                  params0["pos"]["weight"])
    broken = {p: dict(leaves) for p, leaves in params0.items()}
    del broken["head"]["bias"]
    with pytest.raises(KeyError, match="head.bias"):
        _torch_model(broken)
    broken = {p: dict(leaves) for p, leaves in params0.items()}
    broken["ln_f"]["weight"] = np.ones(DIM + 1, np.float32)
    with pytest.raises(ValueError, match="ln_f.weight"):
        _torch_model(broken)


def test_logits_match_jax(jax_run):
    params0, logits_j, _ = jax_run
    x, _ = _batch()
    model = _torch_model(params0)
    with tnn.attention_impl("flash"), torch.no_grad():
        logits_t = model(torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_steps", [1, STEPS])
def test_ddp_train_steps_match_jax(jax_run, n_steps):
    params0, _, steps = jax_run
    x, y = _batch()
    model = _torch_model(params0)
    ddp = TorchDDP(model, optimizer=toptim.SGD(**OPT),
                   loss_fn=tnn.CrossEntropyLoss(fused=True))
    state = ddp.init(seed=0)
    load_jax_params(model, params0)  # the state holds the module's tensors
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with tnn.attention_impl("flash"):
        for _ in range(n_steps):
            state, m = ddp.train_step(state, xt, yt)
    loss_j, correct_j, params_j = steps[n_steps - 1]
    np.testing.assert_allclose(float(m["loss"]), loss_j, rtol=1e-5)
    assert int(m["correct"]) == correct_j
    assert state.step == n_steps
    # the JAX params in the port's layout
    want = dict(_torch_model(params_j).named_parameters())
    for key, got in state.params.items():
        np.testing.assert_allclose(got.detach().numpy(),
                                   want[key].detach().numpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=key)


def test_sgd_options_match_jax():
    """Every SGD option of the slice, update by update, against the JAX
    optimizer on the same gradients."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]
    for kw in (dict(lr=0.1), dict(lr=0.1, weight_decay=0.01),
               dict(lr=0.1, momentum=0.9),
               dict(lr=0.1, momentum=0.9, dampening=0.5),
               dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01)):
        jopt, topt = joptim.SGD(**kw), toptim.SGD(**kw)
        jp = {"w": jnp.asarray(p0)}
        js = jopt.init(jp)
        tp = {"w": torch.from_numpy(p0.copy())}
        ts = topt.init(tp)
        for g in grads:
            jp, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
            tp, ts = topt.update({"w": torch.from_numpy(g)}, ts, tp)
        np.testing.assert_allclose(tp["w"].numpy(), jp["w"], rtol=1e-6,
                                   atol=1e-6, err_msg=str(kw))


def test_ddp_refuses_options_of_later_slices():
    model = TorchLM(vocab_size=11, dim=8, depth=1, num_heads=2,
                    max_seq_len=4, device="cpu")
    # accum_steps came with the optim slice (tests/test_torch_ddp_accum.py)
    for kw in (dict(shard_optimizer=True), dict(comm_dtype=torch.bfloat16)):
        with pytest.raises(NotImplementedError, match="A9.1"):
            TorchDDP(model, optimizer=toptim.SGD(lr=0.1), **kw)
    # sync_batchnorm came with the vision slice: a model without BatchNorm
    # trains as before
    ddp = TorchDDP(model, optimizer=toptim.SGD(lr=0.1),
                   loss_fn=tnn.CrossEntropyLoss(), sync_batchnorm=True)
    state = ddp.init(seed=0)
    assert state.model_state == {}
    x = torch.randint(0, 11, (2, 4))
    state, m = ddp.train_step(state, x, x)
    assert torch.isfinite(m["loss"]) and state.step == 1
