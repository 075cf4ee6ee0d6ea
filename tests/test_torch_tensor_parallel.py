"""The port's host-path tensor parallelism (``parallel/tensor.py``) against
the JAX package's.

- ``SerialTPRunner`` at tp=1, tp=2 and dp=2 against the JAX package's
  ``SerialTPRunner`` from the same initial parameters (the JAX
  ``init(PRNGKey(0))`` tree loaded through ``interop``): three SGD steps,
  each lane's loss within 1e-5 relative and every parameter shard within
  1e-5 relative plus 2e-6 absolute (float32; the port's segments are torch
  ops where the JAX package's are XLA's).
- tp=2 against tp=1 within the same float32 limits, not bit for bit: the
  JAX package's own tp=2 differs from its tp=1 in the last bits from the
  second step on (ROADMAP C1), and so may the port's.
- ``TPTrainer`` at dp2 × tp2 over four socket data planes (threads) equals
  the in-process ``SerialTPRunner`` bit for bit: losses and every shard,
  three steps; the all-None rule table degrades tp=2 to replication bit for
  bit.
- ``tp_shard_params`` equals the JAX package's on the same tree, bit for
  bit; the combiners fold in rank order (the plane's exchange and ring
  equal the in-process fold); every ``TPConfigError`` case;
  ``build_tp_stage_fns`` on a pp 2 × tp 2 grid of pipeline stages equals
  ``SerialTPRunner`` at tp 2 bit for bit; the ``bench_mesh_rules`` twin's
  ``--smoke``.
"""

import os
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.parallel import tensor as jtensor
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch.interop import jax_params, load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.parallel import tensor as ttensor
from tpu_dist_torch.parallel.rules import DEFAULT_RULES

REPO = pathlib.Path(__file__).resolve().parent.parent
VOCAB, DIM, DEPTH, HEADS, SEQ = 64, 32, 2, 4, 8
RTOL, ATOL = 1e-5, 2e-6
STEPS = 3


def _jax_lm():
    return JaxLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                 max_seq_len=SEQ)


def _init_tree():
    return jax.tree.map(np.asarray, _jax_lm().init(jax.random.PRNGKey(0)))


def _torch_lm(tree=None):
    model = TorchLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                    max_seq_len=SEQ, device="cpu")
    return load_jax_params(model, _init_tree() if tree is None else tree)


def _jax_loss():
    ce = jnn.CrossEntropyLoss()
    return lambda logits, y: ce(logits.reshape(-1, VOCAB), y.reshape(-1))


def _torch_loss():
    ce = tnn.CrossEntropyLoss()
    return lambda logits, y: ce(logits.reshape(-1, VOCAB), y.reshape(-1))


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (b, SEQ)),
            rng.integers(0, VOCAB, (b, SEQ)))


def _port_runner(tp=1, dp=1, rules=None):
    return ttensor.SerialTPRunner(_torch_lm(), toptim.SGD(lr=0.1),
                                  _torch_loss(), tp=tp, dp=dp, rules=rules,
                                  seed=None)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tp,dp", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_serial_runner_matches_jax(tp, dp):
    port = _port_runner(tp=tp, dp=dp)
    ref = jtensor.SerialTPRunner(_jax_lm(), joptim.SGD(lr=0.1), _jax_loss(),
                                 tp=tp, dp=dp)
    for step in range(STEPS):
        x, y = _batch(seed=step)
        got, want = port.step(x, y), ref.step(x, y)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    for t in range(tp):
        for path, leaves in ref.params[t].items():
            for name, a in leaves.items():
                _close(port.params[t][path][name].numpy(), a)


def test_tp2_within_float32_of_tp1():
    """ROADMAP C1: tp=2 is held to tp=1 within float32 tolerance."""
    one, two = _port_runner(tp=1), _port_runner(tp=2)
    for step in range(STEPS):
        x, y = _batch(seed=step)
        np.testing.assert_allclose(two.step(x, y), one.step(x, y),
                                   rtol=RTOL)
    model = TorchLM(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                    max_seq_len=SEQ, device="cpu")
    full = {p: {k: v.numpy() for k, v in d.items()}
            for p, d in one.params[0].items()}
    for t in range(2):
        want = ttensor.tp_shard_params(model, full, t, 2)
        for path, leaves in want.items():
            for name, a in leaves.items():
                _close(two.params[t][path][name].numpy(), a)


def test_all_none_table_degrades_to_replication():
    none_rules = {a: None for a in DEFAULT_RULES}
    one, two = _port_runner(tp=1), _port_runner(tp=2, rules=none_rules)
    for step in range(2):
        x, y = _batch(seed=step)
        assert one.step(x, y)[0] == two.step(x, y)[0]
    for path, leaves in two.params[0].items():
        for name, t in leaves.items():
            assert torch.equal(t, two.params[1][path][name])
            assert torch.equal(t, one.params[0][path][name])


def test_dp2_splits_batch():
    runner = _port_runner(dp=2)
    x, y = _batch(b=4)
    assert len(runner.step(x, y)) == 2
    with pytest.raises(ttensor.TPConfigError):
        runner.step(x[:3], y[:3])


def test_tp_shard_params_is_the_jax_packages():
    tree = _init_tree()
    model = _torch_lm(tree)
    assert jax_params(model).keys() == tree.keys()
    for t in range(2):
        got = ttensor.tp_shard_params(model, tree, t, 2)
        want = jtensor.tp_shard_params(_jax_lm(), tree, t, 2)
        for path, leaves in want.items():
            for name, a in leaves.items():
                np.testing.assert_array_equal(got[path][name], a)
    shard = ttensor.tp_shard_params(model, tree, 0, 2)
    assert shard["block0.attn"]["qkv_weight"].shape == (DIM, 3 * DIM // 2)
    assert shard["block0.attn"]["out_weight"].shape == (DIM // 2, DIM)
    np.testing.assert_array_equal(shard["block0.attn"]["out_bias"],
                                  tree["block0.attn"]["out_bias"])
    assert shard["head"]["weight"].shape == (DIM, VOCAB // 2)
    assert shard["tok"]["weight"].shape == (VOCAB // 2, DIM)


def _plane_rig(world):
    from tpu_dist_torch.collectives.transport import DataPlane
    from tpu_dist_torch.dist.store import TCPStore
    store = TCPStore(is_master=True)
    return store, [DataPlane(store, r, world) for r in range(world)]


def _threads(fn, n):
    errs = []

    def run(r):
        try:
            fn(r)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ths = [threading.Thread(target=run, args=(r,), daemon=True)
           for r in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(120)
    assert not errs, errs


def test_plane_combiner_folds_in_rank_order():
    """The plane's exchange (small) and ring (large) combines and its
    all-gather give every rank the in-process combiner's bytes."""
    from tpu_dist_torch.collectives.topology import SubGroup
    world = 2
    store, planes = _plane_rig(world)
    rng = np.random.default_rng(5)
    small = [rng.standard_normal((4, 8)).astype(np.float32)
             for _ in range(world)]
    large = [rng.standard_normal((64, 1024)).astype(np.float32)
             for _ in range(world)]
    got, want = {}, {}
    local = ttensor.LocalCombiner(world)
    try:
        combs = [ttensor.PlaneCombiner(
            SubGroup((0, 1), r, world, instance=0), planes[r])
            for r in range(world)]

        def run(r):
            got[r] = [combs[r].all_reduce(small[r]),
                      combs[r].all_reduce(large[r]),
                      combs[r].all_gather_last(small[r])]

        def ref(r):
            port = local.bound(r)
            want[r] = [port.all_reduce(small[r]), port.all_reduce(large[r]),
                       port.all_gather_last(small[r])]

        _threads(run, world)
        _threads(ref, world)
    finally:
        for p in planes:
            p.close()
        store.close()
    for r in range(world):
        for a, b in zip(got[r], want[r]):
            np.testing.assert_array_equal(a, b)
    assert all(c.bytes_sent > 0 for c in combs)


def test_tptrainer_plane_bitwise_vs_oracle():
    """dp2 × tp2 over four socket data planes on threads reproduces the
    in-process oracle bit for bit: each lane's loss and every shard."""
    from tpu_dist_torch.collectives.topology import SubGroup
    dp_n, tp_n, world = 2, 2, 4
    oracle = _port_runner(tp=tp_n, dp=dp_n)
    store, planes = _plane_rig(world)
    trainers = [None] * world
    try:
        def build(r):
            d, t = divmod(r, tp_n)
            trainers[r] = ttensor.TPTrainer(
                _torch_lm(), toptim.SGD(lr=0.1), _torch_loss(),
                dp=planes[r], tp=tp_n, seed=None,
                tp_group=SubGroup(tuple(d * tp_n + i for i in range(tp_n)),
                                  r, world, instance=0),
                dp_group=SubGroup(tuple(i * tp_n + t for i in range(dp_n)),
                                  r, world, instance=0))

        _threads(build, world)
        for step in range(STEPS):
            x, y = _batch(b=4, seed=step)
            want = oracle.step(x, y)
            xs, ys = np.split(x, dp_n), np.split(y, dp_n)
            got = [None] * world

            def run(r):
                got[r] = trainers[r].step(xs[r // tp_n], ys[r // tp_n])

            _threads(run, world)
            assert got == [want[r // tp_n] for r in range(world)], step
        for r in range(world):
            for path, leaves in trainers[r].params.items():
                for name, t in leaves.items():
                    assert torch.equal(
                        t, oracle.params[r % tp_n][path][name]), (r, path,
                                                                  name)
        assert all(tr.tp_bytes_sent > 0 for tr in trainers)
    finally:
        for p in planes:
            p.close()
        store.close()


class _Plane:
    """A data-plane stand-in for the construction-time refusals."""
    rank, num_processes = 0, 2


def _refusal(case):
    lm = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
              max_seq_len=SEQ, device="cpu")
    opt, loss = toptim.SGD(lr=0.1), _torch_loss()
    if case == "moe":
        ttensor.SerialTPRunner(TorchLM(**lm, num_experts=4), opt, loss,
                               tp=2)
    elif case == "sequence_axis":
        model = TorchLM(**lm)
        model.sequence_axis = "seq"
        ttensor.SerialTPRunner(model, opt, loss, tp=2)
    elif case == "indivisible_heads":
        ttensor.SerialTPRunner(TorchLM(**dict(lm, num_heads=2, dim=32)),
                               opt, loss, tp=4)
    elif case == "indivisible_vocab":
        ttensor.SerialTPRunner(TorchLM(**dict(lm, vocab_size=63)), opt,
                               loss, tp=2)
    elif case == "unsupported_axis":
        ttensor.SerialTPRunner(TorchLM(**lm), opt, loss, tp=2,
                               rules=dict(DEFAULT_RULES, embed="model"))
    elif case == "world_not_divisible":
        ttensor.TPTrainer(TorchLM(**lm), opt, loss, dp=_Plane(), tp=3)
    elif case == "grad_sync":
        ttensor.TPTrainer(TorchLM(**lm), opt, loss, dp=_Plane(), tp=2,
                          grad_sync="ring")


@pytest.mark.parametrize("case", ["moe", "sequence_axis",
                                  "indivisible_heads", "indivisible_vocab",
                                  "unsupported_axis", "world_not_divisible",
                                  "grad_sync"])
def test_config_errors(case):
    with pytest.raises(ttensor.TPConfigError):
        _refusal(case)


class _QChan:
    """An in-process channel endpoint (a queue) for the stage runtime."""

    def __init__(self):
        import queue
        self._q = queue.Queue()

    def put(self, tree, timeout=None):
        self._q.put(tree)

    def get(self, timeout=None):
        return self._q.get(timeout=timeout)


def pp_tp_grid(steps=STEPS, pp_n=2, tp_n=2):
    """dp × tp × pp on the host route: ``build_tp_stage_fns`` for each
    (stage, tp rank) of a pp × tp grid, each a ``PipelineStage`` on its own
    thread (M = 1, GPipe), SGD on each rank's shard; each step's losses
    of the last stage's tp ranks."""
    from tpu_dist_torch.pipeline import PipelineStage, partition_model

    model = _torch_lm()
    part = partition_model(model, pp_n)
    full = _init_tree()
    combiners = [ttensor.LocalCombiner(tp_n) for _ in range(pp_n)]
    act = [_QChan() for _ in range(tp_n)]
    grad = [_QChan() for _ in range(tp_n)]
    opt = toptim.SGD(lr=0.1)
    stages, params, opt_states = {}, {}, {}
    for st in range(pp_n):
        for t in range(tp_n):
            fns = ttensor.build_tp_stage_fns(part, st, _torch_loss(),
                                             combiners[st].bound(t),
                                             rules=DEFAULT_RULES)
            stages[(st, t)] = PipelineStage(
                fns, st, pp_n, num_microbatches=1,
                out_act=act[t] if st == 0 else None,
                in_act=act[t] if st == 1 else None,
                in_grad=grad[t] if st == 0 else None,
                out_grad=grad[t] if st == 1 else None)
            params[(st, t)] = ttensor._to_device(ttensor.tp_shard_params(
                model, part.stage_params(full, st), t, tp_n, DEFAULT_RULES),
                "cpu")
            opt_states[(st, t)] = opt.init(ttensor._flat_keys(
                params[(st, t)]))
    losses = []
    try:
        for step in range(steps):
            x, y = _batch(b=4, seed=step)
            results, errs = {}, []

            def run(st, t):
                try:
                    # host ids, as the JAX grid takes them
                    results[(st, t)] = stages[(st, t)].run_step(
                        params[(st, t)], x_mb=[x] if st == 0 else None,
                        y_mb=[y] if st == pp_n - 1 else None)
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            ths = [threading.Thread(target=run, args=(st, t), daemon=True)
                   for st in range(pp_n) for t in range(tp_n)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(120)
            assert not errs, errs
            losses.append([float(results[(pp_n - 1, t)].losses[0])
                           for t in range(tp_n)])
            for key, res in results.items():
                opt.update(ttensor._flat_keys(res.grads), opt_states[key],
                           ttensor._flat_keys(params[key]))
    finally:
        for stage in stages.values():
            stage.close()
    return losses, params


def test_build_tp_stage_fns_pp2_tp2_matches_the_serial_runner():
    """dp × tp × pp: a pp 2 × tp 2 grid of ``build_tp_stage_fns`` stages on
    threads (GPipe, M = 1) equals ``SerialTPRunner`` at tp 2 bit for bit,
    three steps: the same segments and combines in the same order."""
    losses, params = pp_tp_grid()
    oracle = _port_runner(tp=2)
    for step in range(STEPS):
        x, y = _batch(b=4, seed=step)
        want = oracle.step(x, y)[0]
        assert losses[step] == [want, want], (step, losses[step], want)
    for (st, t), shard in params.items():
        for path, leaves in shard.items():
            for leaf, v in leaves.items():
                assert torch.equal(v, oracle.params[t][path][leaf]), \
                    (st, t, path, leaf)


def test_bench_mesh_rules_smoke():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.benchmarks.bench_mesh_rules",
         "--device", "cpu", "--smoke"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-4000:]}"
    for line in ("literal specs", "all-None table",
                 "over socket planes == SerialTPRunner bit for bit",
                 "GSPMD tp forward within float32 tolerance"):
        assert line in r.stdout, r.stdout
