"""The port's optimizers, schedules, clipping and EMA against the JAX
package's, on the same seeded numpy inputs.

Tolerances:

- schedules: each value within 1 ulp of the JAX package's float32 value
  over steps 0-300 (both compute in float32 in the same order; the port's
  cosine is rounded from float64, XLA's is within an ulp of that), and
  within 1e-6 relative of torch.optim.lr_scheduler's float64 sequence, as
  ``tests/test_lr_scheduler.py`` holds the JAX package.
- optimizers, 20 updates on a tree of two float32 leaves and one bf16 leaf:
  float32 leaves (parameters and every state leaf) within 2e-6 of the
  leaf's largest magnitude (measured: at most 1.3e-7, a few ulps; the
  port's multi-tensor ops fuse some multiply-adds the JAX package rounds
  twice).  bf16 leaves within 2^-5 of the leaf's largest magnitude: the
  port keeps a bf16 leaf bf16, while the JAX package promotes it to float32
  at its first update wherever a float32 scalar meets it (AdamW's bias
  corrections, Adagrad's decayed lr, any schedule), so the two differ by
  the port's per-update bf16 rounding (measured: at most 2^-6).
- the multi-tensor ``update`` against the per-parameter ``update_plain`` on
  the CPU: float32 within 1e-6 of the largest magnitude, bf16 within one
  bf16 ulp of it.
- clipping: the norm within 1e-6 relative, clipped leaves within 1e-6
  relative (float32) and one bf16 ulp (bf16); at world 2 over gloo the
  sharded norm within 1e-6 relative of the global one.
- EMA: float32 within 1e-6 relative over 20 updates, both ``debias`` ways.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import optim as joptim
from tpu_dist_torch import optim as toptim

REPO = Path(__file__).resolve().parent.parent
SHAPES = {"a": (4, 5), "b": (7,), "c": (3, 4)}
BF16 = {"c"}
F32_TOL, BF16_TOL = 2e-6, 2 ** -5


def _schedules(m):
    return {
        "step_lr": m.step_lr(0.1, 7, 0.5),
        "multistep_lr": m.multistep_lr(0.1, [30, 80, 200], 0.3),
        "exponential_lr": m.exponential_lr(0.1, 0.97),
        "linear_lr": m.linear_lr(0.1, 0.25, 1.0, 40),
        "cosine_annealing_lr": m.cosine_annealing_lr(0.1, 120, 0.001),
        "constant_lr": m.constant_lr(0.1, 0.5, 30),
        "sequential_lr": m.sequential_lr(
            [m.linear_lr(0.1, 0.1, 1.0, 20),
             m.cosine_annealing_lr(0.1, 100, 0.0),
             m.exponential_lr(0.05, 0.99)], [20, 150]),
        "warmup_cosine": m.warmup_cosine(3e-4, 30, 250, 1e-5),
    }


@pytest.mark.parametrize("name", sorted(_schedules(joptim)))
def test_schedule_matches_jax_over_300_steps(name):
    want = np.array([np.float32(_schedules(joptim)[name](i))
                     for i in range(301)])
    sched = _schedules(toptim)[name]
    got = np.array([sched(i) for i in range(301)])
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, (name, int(ulps.argmax()), ulps.max())


def _torch_lrs(make_sched, steps, lr=0.1):
    p = [torch.nn.Parameter(torch.zeros(1))]
    opt = torch.optim.SGD(p, lr=lr)
    sched = make_sched(opt)
    out = []
    for _ in range(steps):
        out.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    return np.asarray(out, np.float64)


S = torch.optim.lr_scheduler


@pytest.mark.parametrize("ours,theirs,steps", [
    (toptim.step_lr(0.1, step_size=3, gamma=0.5),
     lambda o: S.StepLR(o, step_size=3, gamma=0.5), 10),
    (toptim.multistep_lr(0.1, milestones=[2, 5, 9], gamma=0.3),
     lambda o: S.MultiStepLR(o, milestones=[2, 5, 9], gamma=0.3), 12),
    (toptim.exponential_lr(0.1, gamma=0.9),
     lambda o: S.ExponentialLR(o, gamma=0.9), 8),
    (toptim.linear_lr(0.1, start_factor=0.25, end_factor=1.0, total_iters=4),
     lambda o: S.LinearLR(o, start_factor=0.25, end_factor=1.0,
                          total_iters=4), 8),
    (toptim.cosine_annealing_lr(0.1, t_max=6, eta_min=0.01),
     lambda o: S.CosineAnnealingLR(o, T_max=6, eta_min=0.01), 7),
    (toptim.constant_lr(0.1, factor=0.5, total_iters=3),
     lambda o: S.ConstantLR(o, factor=0.5, total_iters=3), 6),
    (toptim.sequential_lr([toptim.constant_lr(0.1, factor=0.1,
                                              total_iters=100),
                           toptim.exponential_lr(0.1, gamma=0.5)],
                          milestones=[4]),
     lambda o: S.SequentialLR(o, [S.ConstantLR(o, factor=0.1,
                                               total_iters=100),
                                  S.ExponentialLR(o, gamma=0.5)],
                              milestones=[4]), 10),
], ids=["step", "multistep", "exponential", "linear", "cosine", "constant",
        "sequential"])
def test_schedule_matches_torch(ours, theirs, steps):
    want = _torch_lrs(theirs, steps)
    got = np.asarray([float(ours(i)) for i in range(steps)])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sequential_validates():
    with pytest.raises(ValueError, match="milestones"):
        toptim.sequential_lr([toptim.constant_lr(0.1)], milestones=[1])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _sched(m):
    return m.warmup_cosine(0.1, 5, 20)


CASES = {
    "sgd": ("SGD", dict(lr=0.1)),
    "sgd_wd": ("SGD", dict(lr=0.1, weight_decay=0.01)),
    "sgd_momentum": ("SGD", dict(lr=0.1, momentum=0.9)),
    "sgd_dampening_sched": ("SGD", dict(lr="sched", momentum=0.9,
                                        dampening=0.3)),
    "sgd_nesterov_wd": ("SGD", dict(lr=0.1, momentum=0.9, nesterov=True,
                                    weight_decay=0.01)),
    "sgd_sched": ("SGD", dict(lr="sched")),
    "adamw": ("AdamW", dict(lr=0.01)),
    "adamw_sched_wd": ("AdamW", dict(lr="sched", betas=(0.8, 0.95),
                                     eps=1e-6, weight_decay=0.1)),
    "adamw_no_wd": ("AdamW", dict(lr=0.01, weight_decay=0.0)),
    "adam": ("Adam", dict(lr=0.01)),
    "adam_wd_sched": ("Adam", dict(lr="sched", weight_decay=0.01)),
    "rmsprop": ("RMSprop", dict(lr=0.01)),
    "rmsprop_wd_eps": ("RMSprop", dict(lr=0.01, alpha=0.9, eps=1e-6,
                                       weight_decay=0.01)),
    "rmsprop_momentum": ("RMSprop", dict(lr=0.01, momentum=0.9)),
    "rmsprop_centered": ("RMSprop", dict(lr=0.01, centered=True)),
    "rmsprop_centered_momentum_sched": ("RMSprop", dict(
        lr="sched", momentum=0.9, centered=True, weight_decay=0.01)),
    "adagrad": ("Adagrad", dict(lr=0.1)),
    "adagrad_all": ("Adagrad", dict(lr=0.1, lr_decay=0.01,
                                    weight_decay=0.01,
                                    initial_accumulator_value=0.1,
                                    eps=1e-8)),
    "adagrad_sched": ("Adagrad", dict(lr="sched")),
}


def _build(m, case):
    cls, kw = CASES[case]
    kw = dict(kw)
    if kw.get("lr") == "sched":
        kw["lr"] = _sched(m)
    return getattr(m, cls)(**kw)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_tree(t):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in t.items()}


def _torch_tree(t):
    return {k: torch.tensor(v).to(torch.bfloat16 if k in BF16
                                  else torch.float32) for k, v in t.items()}


def _close(got: torch.Tensor, want, bf16: bool, what: str):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    tol = (BF16_TOL if bf16 else F32_TOL) * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol, (what, err, tol)


def _state_leaves(state, prefix=""):
    """``{path: leaf}`` of an optimizer state (nested dicts)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax_over_20_updates(case):
    jopt, topt = _build(joptim, case), _build(toptim, case)
    jp, tp = _jax_tree(_tree(0)), _torch_tree(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    assert sorted(ts) == sorted(js)
    for i in range(20):
        g = _tree(100 + i)
        jp, js = jopt.update(_jax_tree(g), js, jp)
        tp, ts = topt.update(_torch_tree(g), ts, tp)
    for k in SHAPES:
        assert tp[k].dtype == (torch.bfloat16 if k in BF16
                               else torch.float32)
        _close(tp[k], jp[k], k in BF16, f"{case}: param {k}")
    jl, tl = _state_leaves(js), _state_leaves(ts)
    assert sorted(jl) == sorted(tl)
    for path, leaf in tl.items():
        if path == "step":
            assert leaf.dtype == torch.int32 and leaf.device.type == "cpu"
            assert leaf.dim() == 0 and int(leaf) == int(jl[path]) == 20
        else:
            _close(leaf, jl[path], path.endswith(tuple(BF16)),
                   f"{case}: {path}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_tensor_update_equals_plain_loop(case):
    """The multi-tensor update against the per-parameter reference that
    the card's check uses, on the CPU."""
    opt = _build(toptim, case)
    pa, pb = _torch_tree(_tree(1)), _torch_tree(_tree(1))
    sa, sb = opt.init(pa), opt.init(pb)
    for i in range(5):
        g = _torch_tree(_tree(200 + i))
        opt.update(g, sa, pa)
        opt.update_plain(g, sb, pb)
    for k in SHAPES:
        want = pb[k].float().numpy()
        ulp = 2 ** -7 if k in BF16 else 1e-6
        assert np.abs(pa[k].float().numpy() - want).max() <= \
            ulp * np.abs(want).max(), (case, k)


def test_updates_run_in_place_and_sgd_counts_only_with_a_schedule():
    params = _torch_tree(_tree(2))
    ids = {k: id(v) for k, v in params.items()}
    for opt in (toptim.SGD(lr=0.1, momentum=0.9), toptim.AdamW(),
                toptim.RMSprop(centered=True), toptim.Adagrad()):
        state = opt.init(params)
        new_params, new_state = opt.update(_torch_tree(_tree(3)), state,
                                           params)
        assert new_params is params and new_state is state
        assert {k: id(v) for k, v in new_params.items()} == ids
    assert "step" not in toptim.SGD(lr=0.1).init(params)
    state = toptim.SGD(lr=toptim.constant_lr(0.1)).init(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


def test_hyperparameters_are_validated_like_jax():
    for build in (lambda m: m.SGD(lr=0.1, nesterov=True),
                  lambda m: m.AdamW(betas=(1.0, 0.9)),
                  lambda m: m.AdamW(eps=0.0),
                  lambda m: m.RMSprop(alpha=1.0),
                  lambda m: m.RMSprop(momentum=-0.1),
                  lambda m: m.Adagrad(lr_decay=-1.0),
                  lambda m: m.Adagrad(initial_accumulator_value=-1.0),
                  lambda m: m.EMA(decay=1.0)):
        for m in (joptim, toptim):
            with pytest.raises(ValueError):
                build(m)


# ---------------------------------------------------------------------------
# clipping and EMA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_grad_norm_matches_jax(max_norm):
    g = _tree(4)
    want, norm_j = joptim.clip_grad_norm(_jax_tree(g), max_norm)
    assert abs(float(joptim.global_norm(_jax_tree(g)))
               - float(toptim.global_norm(_torch_tree(g)))) <= \
        1e-6 * float(norm_j)
    got, norm_t = toptim.clip_grad_norm(_torch_tree(g), max_norm)
    assert norm_t.dtype == torch.float32 and norm_t.dim() == 0
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
    for k in SHAPES:
        assert got[k].dtype == (torch.bfloat16 if k in BF16
                                else torch.float32)
        w = np.asarray(want[k], np.float32)
        tol = (2 ** -7 if k in BF16 else 1e-6) * np.abs(w).max()
        assert np.abs(got[k].float().numpy() - w).max() <= tol, k


def test_sharded_norm_at_world1_and_with_an_all_reduce_override():
    g = _torch_tree(_tree(5))
    flat = {k: v.reshape(-1) for k, v in g.items()}
    assert torch.equal(toptim.sharded_global_norm(flat),
                       toptim.global_norm(g))
    # two "ranks" each holding half of every leaf, joined by the override
    halves = [{k: v[: v.numel() // 2] for k, v in flat.items()},
              {k: v[v.numel() // 2:] for k, v in flat.items()}]
    other = float(toptim.sharded_global_norm(halves[1])) ** 2
    seen = []

    def all_reduce(x):
        seen.append(x)
        return np.float32(x + other)

    clipped, norm = toptim.sharded_clip_grad_norm(
        {k: v.clone() for k, v in halves[0].items()}, 1.0,
        all_reduce=all_reduce)
    assert len(seen) == 1 and isinstance(seen[0], np.float32)
    np.testing.assert_allclose(float(norm), float(toptim.global_norm(g)),
                               rtol=1e-6)
    scale = 1.0 / float(norm)
    for k, v in clipped.items():
        np.testing.assert_allclose(v.float().numpy(),
                                   halves[0][k].float().numpy() * scale,
                                   rtol=2 ** -7 if k in BF16 else 1e-6)


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, optim

    rank, port, inp, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=2, rank=rank, device="cpu",
                                 timeout=120)
    d = dict(np.load(inp))
    shards = {}
    for k, v in sorted(d.items()):
        flat = torch.from_numpy(v).reshape(-1)
        half = flat.numel() // 2
        shards[k] = (flat[:half] if rank == 0 else flat[half:]).clone()
    clipped, norm = optim.sharded_clip_grad_norm(shards, 1.0, group=pg)
    np.savez(out, norm=np.float32(norm.item()),
             **{k: v.numpy() for k, v in clipped.items()})
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_clip_at_world2_over_gloo_matches_jax(tmp_path):
    """Two gloo ranks, each owning half of every flattened float32 leaf:
    one scalar all-reduce gives the JAX package's global norm, and each
    rank's clipped half is the JAX clip's."""
    g = {k: v for k, v in _tree(6).items() if k not in BF16}
    np.savez(tmp_path / "in.npz", **g)
    want, norm_j = joptim.clip_grad_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port),
         str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz")], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err
    res = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    for r in res:
        np.testing.assert_allclose(float(r["norm"]), float(norm_j),
                                   rtol=1e-6)
    for k, w in want.items():
        got = np.concatenate([res[0][k], res[1][k]]).reshape(w.shape)
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("debias", [True, False])
def test_ema_matches_jax(debias):
    jema, tema = joptim.EMA(0.9, debias=debias), toptim.EMA(0.9,
                                                           debias=debias)
    f32 = {k: v for k, v in _tree(7).items() if k not in BF16}
    js = jema.init({k: jnp.asarray(v) for k, v in f32.items()})
    ts = tema.init({k: torch.tensor(v) for k, v in f32.items()})
    assert int(ts["step"]) == int(js["step"]) == (0 if debias else 1)
    for i in range(20):
        p = {k: v for k, v in _tree(300 + i).items() if k not in BF16}
        js = jema.update(js, {k: jnp.asarray(v) for k, v in p.items()})
        ts = tema.update(ts, {k: torch.tensor(v) for k, v in p.items()})
    assert int(ts["step"]) == int(js["step"])
    want, got = jema.params(js), tema.params(ts)
    for k in f32:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts["shadow"][k].numpy(),
                                   np.asarray(js["shadow"][k]), rtol=1e-6,
                                   atol=1e-7)
    # the multi-tensor update against its per-parameter reference
    plain = tema.init({k: torch.tensor(v) for k, v in f32.items()})
    multi = tema.init({k: torch.tensor(v) for k, v in f32.items()})
    p = {k: torch.tensor(v) for k, v in _tree(8).items() if k not in BF16}
    tema.update_plain(plain, p)
    tema.update(multi, p)
    for k in f32:
        np.testing.assert_allclose(multi["shadow"][k].numpy(),
                                   plain["shadow"][k].numpy(), rtol=1e-6)
