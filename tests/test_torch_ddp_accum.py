"""The port's DDP gradient accumulation (``accum_steps``) against the JAX
package's, and a JAX-trained state carried into the port.

Each rank splits its rows into ``accum`` micro-batches, runs them in turn
(BatchNorm statistics carried from one to the next), sums their float32
gradients and divides by ``accum``, and all-reduces once.  The LM and a
dropout MLP are held to the JAX DDP over ``ProcessGroup(jax.devices()[:1])``.
The JAX DDP cannot accumulate over a model with state: under JAX 0.9 its
``lax.scan`` over the micro-batches refuses the BatchNorm statistics as a
carry whose varying axes change (ROADMAP C6).  So the BatchNorm model
(conv, BatchNorm, ReLU, pooling, linear) is held to :func:`_jax_accum_steps`, the JAX
DDP's step written out with the JAX package's own modules and optimizer
(``module.apply`` with ``state=`` and the per-micro-batch key, the
gradients summed and divided, the ranks' gradients, losses and statistics
averaged, ``optimizer.update``), at world 1 and against the port's two gloo
ranks at world 2.  It has no dropout: the JAX package draws a mask over
NHWC maps and the port over NCHW, so their masks differ by layout; the MLP
holds the keys.

Tolerances (float32 on both sides, the same terms summed in other orders):
the loss within 1e-5 relative and the correct count equal; every parameter
after the steps within 1e-5 relative plus 2e-6 absolute (``LM_TOL``, as
``tests/test_torch_transformer_lm.py`` holds the step) or, for the
convolutional BatchNorm model, plus 1e-5 absolute (its gradients are sums
over the image that mostly cancel); the BatchNorm statistics within 1e-5
relative plus 1e-6 absolute.  Dropout's masks are the JAX package's bit for
bit (per micro-batch key), so the dropout model is held to the same
limits.  The planted faults the checks must reject: one accumulation with
the statistics reset between micro-batches, and the accum = 1 key for
every micro-batch."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jmodels
from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.dist.process_group import ProcessGroup as JaxGroup
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import models as tmodels
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.interop import (jax_state, load_jax_opt_state,
                                    load_jax_params, load_jax_state)
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

REPO = Path(__file__).resolve().parent.parent
LM = dict(vocab_size=61, dim=32, depth=2, num_heads=2, max_seq_len=12)
LM_TOL = dict(rtol=1e-5, atol=2e-6)
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _JaxMLP(jnn.Module):
    def __init__(self):
        super().__init__()
        self.net = jnn.Sequential(jnn.Linear(12, 32), jnn.ReLU(),
                                  jnn.Dropout(0.4), jnn.Linear(32, 5))

    def forward(self, x):
        return self.net(x)


class _TorchMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = tnn.Sequential(tnn.Linear(12, 32, device="cpu"),
                                  tnn.ReLU(), tnn.Dropout(0.4),
                                  tnn.Linear(32, 5, device="cpu"))

    def forward(self, x):
        return self.net(x)


class _JaxBN(jnn.Module):
    def __init__(self):
        super().__init__()
        self.net = jnn.Sequential(jnn.Conv2d(3, 8, 3, padding=1),
                                  jnn.BatchNorm2d(8), jnn.ReLU(),
                                  jnn.AdaptiveAvgPool2d(1), jnn.Flatten(),
                                  jnn.Linear(8, 5))

    def forward(self, x):
        return self.net(x)


class _TorchBN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = tnn.Sequential(tnn.Conv2d(3, 8, 3, padding=1,
                                             device="cpu"),
                                  tnn.BatchNorm2d(8, device="cpu"),
                                  tnn.ReLU(), tnn.AdaptiveAvgPool2d(1), tnn.Flatten(),
                                  tnn.Linear(8, 5, device="cpu"))

    def forward(self, x):
        return self.net(x)


def _lm_batches(n, rows, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, LM["vocab_size"], (rows, LM["max_seq_len"]))
             .astype(np.int32),) * 2 for _ in range(n)]


def _mlp_batches(n, rows, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 12)).astype(np.float32),
             rng.integers(0, 5, rows).astype(np.int32)) for _ in range(n)]


def _bn_batches(n, rows, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, 6, 6, 3)).astype(np.float32),
             rng.integers(0, 5, rows).astype(np.int32)) for _ in range(n)]


def _to_torch(x):
    if x.ndim == 4:  # NHWC → NCHW
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    t = torch.from_numpy(x)
    return t.long() if t.dtype == torch.int32 else t


KINDS = {"lm": (lambda: jmodels.TransformerLM(**LM),
               lambda: tmodels.TransformerLM(**LM, device="cpu"),
               _lm_batches),
         "mlp": (_JaxMLP, _TorchMLP, _mlp_batches),
         "bn": (_JaxBN, _TorchBN, _bn_batches)}


def _models(kind):
    return KINDS[kind][0](), KINDS[kind][1]()


def _jax_accum_steps(module, loss_fn, opt, state, batches, accum, world):
    """The JAX DDP's step (``tpu_dist/parallel/ddp.py``, ``local_step``)
    written out over ``world`` ranks without ``shard_map``: rank ``r`` takes
    rows ``[r * b, (r + 1) * b)`` of each global batch and runs its
    micro-batches through ``module.apply`` with the state threaded and the
    key ``fold_in(fold_in(rng, step * accum + i), r)``; the rank means of
    the gradients, losses and statistics feed ``opt.update``.  Returns
    ``(params, model_state, opt_state, [(loss, correct), ...])``."""
    params, mstate, opt_state, step, rng = state
    base = jax.random.wrap_key_data(rng)
    metrics = []
    for x, y in batches:
        b = x.shape[0] // world
        m = b // accum
        grads, losses, corrects, states = [], [], 0, []
        for r in range(world):
            ms, g_sum, loss_sum = mstate, None, 0.0
            for i in range(accum):
                rows = slice(r * b + i * m, r * b + (i + 1) * m)
                xb, yb = jnp.asarray(x[rows]), jnp.asarray(y[rows])
                key = jax.random.fold_in(
                    jax.random.fold_in(base, step * accum + i), r)

                def loss_local(p, ms=ms, xb=xb, yb=yb, key=key):
                    out, new_ms = module.apply(p, xb, state=ms,
                                               training=True, rng=key)
                    return loss_fn(out, yb), (out, new_ms)

                (loss, (out, ms)), g = jax.value_and_grad(
                    loss_local, has_aux=True)(params)
                g_sum = g if g_sum is None else jax.tree.map(jnp.add,
                                                             g_sum, g)
                loss_sum = loss_sum + loss
                corrects += int((out.argmax(-1) == yb).sum())
            grads.append(jax.tree.map(lambda t: t / accum, g_sum))
            losses.append(loss_sum / accum)
            states.append(ms)
        mean = lambda *xs: sum(xs[1:], xs[0]) / world  # noqa: E731
        params, opt_state = opt.update(jax.tree.map(mean, *grads), opt_state,
                                       params)
        mstate = jax.tree.map(mean, *states)
        metrics.append((float(mean(*losses)), corrects))
        step = step + 1
    return params, mstate, opt_state, metrics


def _pair(kind, accum, opt):
    jm, tm = _models(kind)
    jd = JaxDDP(jm, optimizer=opt(joptim), loss_fn=jnn.CrossEntropyLoss(),
                group=JaxGroup(jax.devices()[:1]), donate=False,
                accum_steps=accum)
    td = TorchDDP(tm, optimizer=opt(toptim), loss_fn=tnn.CrossEntropyLoss(),
                  accum_steps=accum)
    js, ts = jd.init(seed=3), td.init(seed=3)
    load_jax_params(tm, _np(js.params))
    if js.model_state:
        load_jax_state(tm, _np(js.model_state))
    return jd, js, td, ts


def _sgd(m):
    return m.SGD(lr=0.2, momentum=0.9)


def _assert_params(kind, ts, jparams, tol):
    scratch = _models(kind)[1]
    load_jax_params(scratch, _np(jparams))
    for k, v in scratch.named_parameters():
        np.testing.assert_allclose(ts.params[k].detach().numpy(),
                                   v.detach().numpy(), **tol, err_msg=k)


def _assert_stats(got, want):
    for p in want:
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[p][k], want[p][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{p}.{k}")


@pytest.mark.parametrize("kind", ["lm", "mlp"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulation_matches_the_jax_ddp_at_world1(kind, accum):
    """The LM, and an MLP whose dropout draws micro-batch ``i`` of step
    ``s``'s mask from ``fold_in(fold_in(rng, s * accum + i), rank)``."""
    jd, js, td, ts = _pair(kind, accum, _sgd)
    for x, y in KINDS[kind][2](2, 8):
        js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
        ts, tm = td.train_step(ts, _to_torch(x), _to_torch(y))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert int(tm["correct"]) == int(jm["correct"])
    assert ts.step == 2
    _assert_params(kind, ts, js.params, LM_TOL)


@pytest.mark.parametrize("accum", [2, 4])
def test_batchnorm_accumulation_matches_the_jax_step_at_world1(accum):
    """Each micro-batch normalizes with its own batch statistics and folds
    them into the running statistics the next one starts from."""
    jd, js, td, ts = _pair("bn", accum, _sgd)
    batches = _bn_batches(2, 8)
    params, mstate, _, metrics = _jax_accum_steps(
        jd.module, jd.loss_fn, jd.optimizer, js, batches, accum, world=1)
    for (x, y), (loss, correct) in zip(batches, metrics):
        ts, tm = td.train_step(ts, _to_torch(x), _to_torch(y))
        np.testing.assert_allclose(float(tm["loss"]), loss, rtol=1e-5)
        assert int(tm["correct"]) == correct
    _assert_params("bn", ts, params, BN_TOL)
    _assert_stats(jax_state(td.module), _np(mstate))


def test_the_written_out_jax_step_is_the_jax_ddp_step():
    """Without accumulation the JAX DDP runs the BatchNorm model: the
    written-out step equals it there (accum 1), and equals the JAX DDP's
    accumulation on the stateless MLP (accum 2)."""
    for kind, accum in (("bn", 1), ("mlp", 2)):
        jd, js, _, _ = _pair(kind, accum, _sgd)
        batches = KINDS[kind][2](2, 8)
        params, mstate, _, metrics = _jax_accum_steps(
            jd.module, jd.loss_fn, jd.optimizer, js, batches, accum, 1)
        for (x, y), (loss, correct) in zip(batches, metrics):
            js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
            np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-6)
            assert correct == int(jm["correct"])
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(js.params)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        if kind == "bn":
            _assert_stats(_np(mstate), _np(js.model_state))


def test_planted_faults_are_rejected():
    """Resetting the statistics between micro-batches, or reusing one key
    for every micro-batch, each moves the step outside the limits."""
    jd, js, td, ts = _pair("bn", 2, _sgd)
    batches = _bn_batches(1, 8)
    (x, y), = batches
    _, mstate, _, _ = _jax_accum_steps(
        jd.module, jd.loss_fn, jd.optimizer, js, batches, 2, world=1)
    want = _np(mstate)

    saved = {p: {k: v.clone() for k, v in lv.items()}
             for p, lv in ts.model_state.items()}
    real = td._micro_grads

    def reset_stats(state, xb, yb, i):
        for p, lv in state.model_state.items():
            for k, v in lv.items():
                v.copy_(saved[p][k])
        return real(state, xb, yb, i)

    td._micro_grads = reset_stats
    td.train_step(ts, _to_torch(x), _to_torch(y))
    got = jax_state(td.module)
    assert any(not np.allclose(got[p][k], want[p][k], rtol=1e-5, atol=1e-6)
               for p in want for k in ("mean", "var"))

    jd, js, td, ts = _pair("mlp", 2, _sgd)
    (x, y), = _mlp_batches(1, 8)
    js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
    td._micro_key = lambda state, i: TorchDDP._micro_key(td, state, 0)
    ts, tm = td.train_step(ts, _to_torch(x), _to_torch(y))
    assert not np.isclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_accumulation_composes_with_train_chunk():
    """``train_chunk`` with ``accum_steps=2`` equals that many steps, and
    the JAX package's ``train_chunk``."""
    jd, js, td, ts = _pair("lm", 2, _sgd)
    batches = _lm_batches(3, 8, seed=5)
    xs = np.stack([x for x, _ in batches])
    js, jm = jd.train_chunk(js, jnp.asarray(xs), jnp.asarray(xs))
    xt = _to_torch(xs)
    ts, tm = td.train_chunk(ts, xt, xt)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(tm["correct"].numpy(),
                                  np.asarray(jm["correct"]))
    _assert_params("lm", ts, js.params, LM_TOL)
    _, _, td2, ts2 = _pair("lm", 2, _sgd)
    for x in xt:
        ts2, _ = td2.train_step(ts2, x, x)
    for k, v in ts2.params.items():
        assert torch.equal(v, ts.params[k]), k


def test_accumulation_refusals():
    td = TorchDDP(tmodels.TransformerLM(**LM, device="cpu"),
                  optimizer=toptim.SGD(lr=0.1),
                  loss_fn=tnn.CrossEntropyLoss(), accum_steps=3)
    ts = td.init(seed=0)
    x = torch.zeros(4, LM["max_seq_len"], dtype=torch.long)
    with pytest.raises(ValueError, match="accum_steps=3"):
        td.train_step(ts, x, x)
    with pytest.raises(ValueError, match=">= 1"):
        TorchDDP(td.module, accum_steps=0)


# ---------------------------------------------------------------------------
# world 2: the port's gloo ranks against the JAX DDP over 2 devices
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.interop import jax_state, load_jax_params, \\
        load_jax_state
    from tests.test_torch_ddp_accum import KINDS
    from tpu_dist_torch.parallel import DistributedDataParallel

    rank, port, inp, out, kind = (int(sys.argv[1]), sys.argv[2],
                                  sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    d = dict(np.load(inp))

    def tree(prefix):
        t = {}
        for k, v in d.items():
            if k.startswith(prefix + "|"):
                _, path, leaf = k.split("|")
                t.setdefault(path, {})[leaf] = v
        return t

    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=2, rank=rank, device="cpu",
                                 timeout=120)
    model = KINDS[kind][1]()
    ddp = DistributedDataParallel(
        model, optimizer=optim.SGD(lr=0.2, momentum=0.9),
        loss_fn=nn.CrossEntropyLoss(), group=pg, accum_steps=2)
    state = ddp.init(seed=3)
    load_jax_params(model, tree("p"))
    if kind == "bn":
        load_jax_state(model, tree("s"))
    res = {}
    rows = slice(rank * 8, (rank + 1) * 8)
    for step in range(2):
        x = torch.from_numpy(d[f"x{step}"][rows])
        y = torch.from_numpy(d[f"y{step}"][rows]).long()
        state, m = ddp.train_step(state, x, y)
        res[f"{step}:loss"] = float(m["loss"])
        res[f"{step}:correct"] = int(m["correct"])
    for k, v in state.params.items():
        res[f"p:{k}"] = v.detach().numpy().copy()
    for p, lv in jax_state(model).items():
        for k, v in lv.items():
            res[f"s:{p}:{k}"] = v
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("kind", ["bn", "mlp"])
def test_world2_accumulation_matches_jax(tmp_path, kind):
    """Two ranks with accum 2 (global batch 16: 8 rows a rank, two
    micro-batches of 4), the port's two gloo ranks against: the written-out
    JAX step for the BatchNorm model (statistics threaded on each rank,
    then the gradients, losses and statistics averaged), and the JAX DDP
    over two devices for the dropout MLP (per-rank, per-micro-batch
    keys)."""
    jd, js, _, _ = _pair(kind, 2, _sgd)
    feed = {f"p|{p}|{k}": v for p, lv in _np(js.params).items()
            for k, v in lv.items()}
    feed.update({f"s|{p}|{k}": v for p, lv in _np(js.model_state).items()
                 for k, v in lv.items()})
    batches = KINDS[kind][2](2, 16, seed=7)
    for i, (x, y) in enumerate(batches):
        feed[f"x{i}"] = _to_torch(x).numpy()
        feed[f"y{i}"] = y
    if kind == "bn":
        params, mstate, _, want = _jax_accum_steps(
            jd.module, jd.loss_fn, jd.optimizer, js, batches, 2, world=2)
    else:
        jd2 = JaxDDP(jd.module, optimizer=_sgd(joptim),
                     loss_fn=jnn.CrossEntropyLoss(),
                     group=JaxGroup(jax.devices()[:2]), donate=False,
                     accum_steps=2)
        js = jd2.init(seed=3)
        want = []
        for x, y in batches:
            js, jm = jd2.train_step(js, jnp.asarray(x), jnp.asarray(y))
            want.append((float(jm["loss"]), int(jm["correct"])))
        params, mstate = js.params, {}
    np.savez(tmp_path / "in.npz", **feed)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port),
         str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz"), kind],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        finally:
            p.kill()
        assert p.returncode == 0, err
    ranks = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    scratch = KINDS[kind][1]()
    load_jax_params(scratch, _np(params))
    stats = _np(mstate)
    for res in ranks:
        for step, (loss, correct) in enumerate(want):
            np.testing.assert_allclose(res[f"{step}:loss"], loss, rtol=1e-5)
            assert int(res[f"{step}:correct"]) == correct
        for k, v in scratch.named_parameters():
            np.testing.assert_allclose(res[f"p:{k}"], v.detach().numpy(),
                                       **BN_TOL, err_msg=k)
        for p, lv in stats.items():
            for k, v in lv.items():
                np.testing.assert_allclose(res[f"s:{p}:{k}"], v, rtol=1e-5,
                                           atol=1e-6)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


# ---------------------------------------------------------------------------
# a JAX-trained state carried into the port
# ---------------------------------------------------------------------------

# The key third of each qkv bias has a gradient that is zero in exact
# arithmetic (it adds a constant to every score of a row), so both packages
# compute rounding noise there; an adaptive optimizer divides it by its own
# root mean square and takes a full step on it, in a direction the noise
# decides (0.12 apart after two steps at the default eps).  The adaptive
# optimizers' eps is set to 1e-6, which damps those steps (measured: at most
# 7e-5 apart), and that third is held to KEY_BIAS_ATOL; every other leaf to
# LM_TOL.
KEY_BIAS_ATOL = 1e-3
CARRY = {
    "adamw_sched": lambda m: m.AdamW(lr=m.warmup_cosine(0.01, 2, 8),
                                     eps=1e-6, weight_decay=0.05),
    "sgd_nesterov": lambda m: m.SGD(lr=0.1, momentum=0.9, nesterov=True),
    "rmsprop_centered": lambda m: m.RMSprop(lr=0.003, eps=1e-6,
                                            momentum=0.5, centered=True),
    "adagrad": lambda m: m.Adagrad(lr=0.05, lr_decay=0.01, eps=1e-6),
}


@pytest.mark.parametrize("opt", sorted(CARRY))
def test_jax_trained_state_continues_in_the_port(opt):
    """Two JAX steps (and an EMA of the parameters), carried over with
    ``load_jax_params`` + ``load_jax_opt_state``; both then take two more
    steps, which agree at ``LM_TOL``."""
    jm, tm = _models("lm")
    jd = JaxDDP(jm, optimizer=CARRY[opt](joptim),
                loss_fn=jnn.CrossEntropyLoss(),
                group=JaxGroup(jax.devices()[:1]), donate=False)
    jema, tema = joptim.EMA(0.9), toptim.EMA(0.9)
    js = jd.init(seed=1)
    je = jema.init(js.params)
    batches = _lm_batches(4, 4, seed=9)
    for x, y in batches[:2]:
        js, _ = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
        je = jema.update(je, js.params)

    td = TorchDDP(tm, optimizer=CARRY[opt](toptim),
                  loss_fn=tnn.CrossEntropyLoss())
    ts = td.init(seed=0)
    load_jax_params(tm, _np(js.params))
    ts = ts._replace(opt_state=load_jax_opt_state(td.optimizer,
                                                  _np(js.opt_state), tm),
                     step=int(js.step))
    te = load_jax_opt_state(tema, _np(je), tm)
    assert int(te["step"]) == 2 and te["step"].dtype == torch.int32
    np.testing.assert_array_equal(
        te["shadow"]["block0.attn.qkv_weight"].numpy(),
        np.asarray(je["shadow"]["block0.attn"]["qkv_weight"]).T)
    for x, y in batches[2:]:
        js, jmet = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
        je = jema.update(je, js.params)
        ts, tmet = td.train_step(ts, _to_torch(x), _to_torch(y))
        tema.update(te, ts.params)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    dim = LM["dim"]
    for got, jparams in ((dict(ts.params), js.params),
                         (tema.params(te), jema.params(je))):
        scratch = _models("lm")[1]
        load_jax_params(scratch, _np(jparams))
        for k, v in scratch.named_parameters():
            g, w = got[k].detach().numpy(), v.detach().numpy()
            if k.endswith("attn.qkv_bias"):
                np.testing.assert_allclose(g[dim:2 * dim], w[dim:2 * dim],
                                           rtol=0, atol=KEY_BIAS_ATOL,
                                           err_msg=k)
                g = np.concatenate([g[:dim], g[2 * dim:]])
                w = np.concatenate([w[:dim], w[2 * dim:]])
            np.testing.assert_allclose(g, w, **LM_TOL, err_msg=k)


def test_load_jax_opt_state_refusals():
    jm, tm = _models("lm")
    params = _np(jm.init(jax.random.key(0)))
    opt = joptim.AdamW()
    state = _np(opt.init(params))
    with pytest.raises(KeyError, match="unexpected keys"):
        load_jax_opt_state(toptim.AdamW(), dict(state, extra=1), tm)
    with pytest.raises(KeyError, match="missing keys"):
        load_jax_opt_state(toptim.AdamW(), {"m": state["m"],
                                            "step": state["step"]}, tm)
    bad = {p: dict(lv) for p, lv in state["v"].items()}
    bad["head"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="head.bias"):
        load_jax_opt_state(toptim.AdamW(), dict(state, v=bad), tm)
    with pytest.raises(ValueError, match="step"):
        load_jax_opt_state(toptim.AdamW(),
                           dict(state, step=np.zeros(2, np.int32)), tm)


# ---------------------------------------------------------------------------
# the train_lm twin, on the CPU
# ---------------------------------------------------------------------------

def test_train_lm_twin_learns_the_permutation_on_cpu():
    """The dp mode at a small size with the warmup-cosine schedule: the loss
    falls tenfold and greedy generation follows the permutation."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.examples.train_lm",
         "--device", "cpu", "--steps", "60", "--seq-len", "32", "--dim",
         "64", "--depth", "2", "--heads", "4", "--vocab", "32",
         "--lr-schedule", "warmup_cosine", "--log-every", "10",
         "--generate", "16"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    losses = [float(ln.split("loss:")[1]) for ln in r.stdout.splitlines()
              if ln.startswith("Step [")]
    assert len(losses) == 6 and losses[-1] < losses[0] / 10, losses
    assert "permutation-consistent transitions: 16/16" in r.stdout
    assert "Training complete in:" in r.stdout


def test_train_lm_twin_pp_matches_the_dp_mode():
    """``--parallel pp --device cpu`` at world 1 (a pipe axis of one rank,
    one microbatch: the plain step through ``PipelineParallel``) trains as
    the dp mode does: every step's loss within float32 tolerance."""
    from tpu_dist_torch.examples import train_lm
    argv = ["--device", "cpu", "--steps", "12", "--seq-len", "16", "--dim",
            "32", "--depth", "2", "--heads", "4", "--vocab", "32",
            "--log-every", "100"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the suite's workers share the cores
    try:
        dp = train_lm.train(train_lm.parse_args(argv))
        pp = train_lm.train(train_lm.parse_args(["--parallel", "pp"] + argv))
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_allclose(pp["losses"], dp["losses"], rtol=1e-5)
    assert pp["losses"][-1] < pp["losses"][0] / 2


def test_train_lm_twin_tp_trains_on_cpu():
    """``--parallel tp --device cpu`` (world 1: a model axis of one rank)
    trains: the loss falls fourfold."""
    from tpu_dist_torch.examples import train_lm
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the suite's workers share the cores
    try:
        r = train_lm.train(train_lm.parse_args(
            ["--parallel", "tp", "--device", "cpu", "--steps", "30",
             "--seq-len", "32", "--dim", "32", "--depth", "2", "--heads",
             "4", "--vocab", "32", "--log-every", "10"]))
    finally:
        torch.set_num_threads(threads)
    assert r["losses"][-1] < r["losses"][0] / 4, r["losses"]
