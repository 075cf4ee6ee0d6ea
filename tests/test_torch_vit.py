"""The port's Vision Transformer against the JAX package's.

A small ViT (image 32, patch 8, 2 layers, 4 heads, width 64, 10 classes)
takes the JAX package's parameters through ``interop.load_jax_params``
(the patch projection HWIO → OIHW, the tokens as they are); the same numpy
images (NHWC for JAX, NCHW for the port) must give the same logits.  The
JAX init's head and class token are zero, under which the logits are 0 and
a first step reaches nothing below the head, so the comparisons start from
a head and class token drawn from a seed.

Tolerances:

- forward logits: rtol 1e-4 and atol 1e-5 (float32; the same sums in
  another order through two LayerNorms a block);
- DDP steps (AdamW lr 3e-4, weight decay 0.05, float32), each from the JAX
  run's state (parameters and AdamW moments): the rules of
  ``tests/test_torch_vision_ddp.py``, the loss within 1e-5 relative, the
  correct count equal, each leaf's update within ``LEAF_TOL`` of its norm
  and all within ``STEP_TOL``, at world 1 and at world 2 (two gloo ranks
  against the JAX DDP over two devices);
- bf16 compute: the port's step held to the JAX float32 step no further
  than 1.5 times the JAX bf16 step's own error, the loss within 2^-6 of the
  JAX bf16 loss and the counts within one image.

The init is checked against torchvision's rules by distribution (each
leaf's bounds, zeros and moments within four standard errors); it draws
from the port's generator, not the JAX package's streams."""

import math
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
from tpu_dist_torch.interop import load_jax_opt_state, load_jax_params
from tpu_dist_torch.nn.module import reset_parameters
from tpu_dist_torch.parallel import DistributedDataParallel as TorchDDP

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4,
             hidden_dim=64, num_classes=10)
STEPS = 3
STEP_TOL, LEAF_TOL = 4e-2, 8e-2
RECIPE = dict(lr=3e-4, weight_decay=0.05)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_params(seed=0):
    """The JAX init with a head and class token drawn from ``seed``."""
    p = _np(jmodels.VisionTransformer(**SMALL).init(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    p["head"]["weight"] = (0.1 * rng.standard_normal(
        p["head"]["weight"].shape)).astype(np.float32)
    p["tokens"]["class_token"] = rng.standard_normal(
        p["tokens"]["class_token"].shape).astype(np.float32)
    return p


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("name,count", [("vit_b_16", 86_567_656),
                                        ("vit_b_32", 88_224_232)])
def test_parameter_counts_match_torchvision(name, count):
    model = getattr(tmodels, name)(num_classes=1000, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == count


def test_init_follows_torchvision():
    d, p = 256, 16
    model = tmodels.VisionTransformer(64, p, 2, 4, d, 10, device="cpu")
    g = torch.Generator().manual_seed(3)
    reset_parameters(model, g)
    params = dict(model.named_parameters())

    def moments_ok(t, std, limit=None):
        t = t.detach().double()
        n = t.numel()
        # the sample std within four standard errors of ``std``
        ok = abs(float(t.std()) - std) <= 4 * std / math.sqrt(2 * n)
        ok = ok and abs(float(t.mean())) <= 4 * std / math.sqrt(n)
        if limit is not None:  # the bound, rounded to float32
            ok = ok and float(t.abs().max()) <= limit * (1 + 2 ** -23)
        return ok

    for k in ("head.weight", "head.bias", "tokens.class_token",
              "conv_proj.bias"):
        assert not params[k].any(), k
    assert moments_ok(params["tokens.pos_embedding"], 0.02)
    fan_in = 3 * p * p
    std = math.sqrt(1.0 / fan_in)
    # trunc_normal's bounds are ±2 in value units: no truncation in effect
    assert moments_ok(params["conv_proj.weight"], std, limit=2.0)
    for i in range(2):
        b = f"block{i}"
        for j, (fi, fo) in ((0, (d, 4 * d)), (2, (4 * d, d))):
            lim = math.sqrt(6.0 / (fi + fo))
            assert moments_ok(params[f"{b}.mlp.{j}.weight"],
                              lim / math.sqrt(3), limit=lim)
            assert moments_ok(params[f"{b}.mlp.{j}.bias"], 1e-6)
        lim = math.sqrt(6.0 / (d + 3 * d))
        assert moments_ok(params[f"{b}.attn.qkv_weight"], lim / math.sqrt(3),
                          limit=lim)
        assert not params[f"{b}.attn.qkv_bias"].any()
        assert not params[f"{b}.attn.out_bias"].any()
        lim = 1.0 / math.sqrt(d)  # torch's default Linear init
        assert moments_ok(params[f"{b}.attn.out_weight"], lim / math.sqrt(3),
                          limit=lim)
        for ln in ("ln1", "ln2"):
            assert getattr(model, b).__getattr__(ln).eps == 1e-6
    assert model.ln.eps == 1e-6
    # deterministic from the generator's seed
    again = tmodels.VisionTransformer(64, p, 2, 4, d, 10, device="cpu")
    reset_parameters(again, torch.Generator().manual_seed(3))
    for k, v in again.named_parameters():
        assert torch.equal(v, params[k]), k


def test_small_vit_forward_matches_jax():
    jv = jmodels.VisionTransformer(**SMALL)
    params = _jax_params()
    tv = load_jax_params(tmodels.VisionTransformer(**SMALL, device="cpu"),
                         params)
    x, _ = _images(5, seed=1)
    want = np.asarray(jv.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tv(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the patch tokens' order matters: a transposed flatten (w, h) is
    # rejected by the same check
    with torch.no_grad():
        w = tv.conv_proj.weight
        w.copy_(w.transpose(2, 3).clone())
        wrong = tv(_nchw(x.transpose(0, 2, 1, 3).copy())).numpy()
    assert not np.allclose(wrong, want, rtol=1e-4, atol=1e-5)


def test_load_jax_params_refuses_a_wrong_vit_tree():
    params = _jax_params()
    tv = tmodels.VisionTransformer(**SMALL, device="cpu")
    bad = dict(params, tokens=dict(params["tokens"]))
    del bad["tokens"]["class_token"]
    with pytest.raises(KeyError, match="tokens.class_token"):
        load_jax_params(tv, bad)
    bad = dict(params, tokens=dict(params["tokens"], extra=np.zeros(1)))
    with pytest.raises(KeyError, match="tokens.extra"):
        load_jax_params(tv, bad)
    bad = dict(params, tokens=dict(params["tokens"],
                                   pos_embedding=np.zeros((1, 16, 64))))
    with pytest.raises(ValueError, match="pos_embedding"):
        load_jax_params(tv, bad)
    with pytest.raises(ValueError, match="NCHW"):
        tv(torch.zeros(1, 32, 32, 3))


# ---------------------------------------------------------------------------
# DDP steps against the JAX DDP
# ---------------------------------------------------------------------------

def _jax_ddp(world=1, compute_dtype=None):
    return JaxDDP(jmodels.VisionTransformer(**SMALL),
                  optimizer=joptim.AdamW(**RECIPE),
                  loss_fn=jnn.CrossEntropyLoss(),
                  group=JaxGroup(jax.devices()[:world]), donate=False,
                  compute_dtype=compute_dtype)


def _jax_start(jd):
    js = jd.init(seed=0)
    return js._replace(params=jax.tree.map(jnp.asarray, _jax_params()))


def _torch_ddp(compute_dtype=None):
    ddp = TorchDDP(tmodels.VisionTransformer(**SMALL, device="cpu"),
                   optimizer=toptim.AdamW(**RECIPE),
                   loss_fn=tnn.CrossEntropyLoss(),
                   compute_dtype=compute_dtype)
    return ddp, ddp.init(seed=0)


def _set_state(ddp, state, jstate):
    """The port's parameters and AdamW state set to the JAX state's."""
    load_jax_params(ddp.module, _np(jstate.params))
    return state._replace(
        opt_state=load_jax_opt_state(ddp.optimizer, _np(jstate.opt_state),
                                     ddp.module),
        step=int(jstate.step))


def _port_params(jparams):
    scratch = load_jax_params(
        tmodels.VisionTransformer(**SMALL, device="cpu"), _np(jparams))
    return {k: v.detach() for k, v in scratch.named_parameters()}


def _update_errors(got, want, before):
    """Per leaf ``|got - want| / |want - before|`` and over all leaves."""
    leaf, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        e = float((got[k].detach().float() - w).norm())
        u = float((w - before[k]).norm())
        leaf[k] = e / max(u, 1e-30)
        num += e * e
        den += u * u
    return leaf, (num / den) ** 0.5


@pytest.fixture(scope="module")
def float32_run():
    """Three JAX float32 steps at batch 8, each with the port's step from
    the same state."""
    jd = _jax_ddp()
    js = _jax_start(jd)
    td, ts = _torch_ddp()
    out = []
    for step in range(STEPS):
        x, y = _images(8, seed=10 + step)
        ts = _set_state(td, ts, js)
        before = {k: v.detach().clone() for k, v in ts.params.items()}
        start = js
        js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
        ts, tm = td.train_step(ts, _nchw(x), torch.from_numpy(y).long())
        out.append(dict(x=x, y=y, start=start, before=before, jm=_np(jm),
                        tm=tm, want=_port_params(js.params),
                        got={k: v.detach().clone()
                             for k, v in ts.params.items()}))
    return out


def test_float32_adamw_steps_match_jax(float32_run):
    for i, s in enumerate(float32_run):
        loss_j, loss_t = float(s["jm"]["loss"]), float(s["tm"]["loss"])
        assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j), (i, loss_t, loss_j)
        assert int(s["tm"]["correct"]) == int(s["jm"]["correct"])
        leaf, total = _update_errors(s["got"], s["want"], s["before"])
        worst = max(leaf, key=leaf.get)
        assert leaf[worst] <= LEAF_TOL, (i, worst, leaf[worst])
        assert total <= STEP_TOL, (i, total)


def test_bf16_steps_match_jax_at_its_own_accuracy(float32_run):
    jd16 = _jax_ddp(compute_dtype=jnp.bfloat16)
    td, ts = _torch_ddp(compute_dtype=torch.bfloat16)
    for i, s in enumerate(float32_run):
        ts = _set_state(td, ts, s["start"])
        js16, jm16 = jd16.train_step(s["start"], jnp.asarray(s["x"]),
                                     jnp.asarray(s["y"]))
        ts, tm = td.train_step(ts, _nchw(s["x"]),
                               torch.from_numpy(s["y"]).long())
        _, e_jax = _update_errors(_port_params(js16.params), s["want"],
                                  s["before"])
        _, e_port = _update_errors(dict(ts.params), s["want"], s["before"])
        assert e_port <= 1.5 * e_jax, (i, e_port, e_jax)
        loss16, loss_t = float(jm16["loss"]), float(tm["loss"])
        assert abs(loss_t - loss16) <= 2 ** -6 * abs(loss16), \
            (i, loss_t, loss16)
        assert abs(int(tm["correct"]) - int(jm16["correct"])) <= 1


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.interop import load_jax_opt_state, load_jax_params
    from tpu_dist_torch.models import VisionTransformer
    from tpu_dist_torch.parallel import DistributedDataParallel

    rank, port, inp, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4])
    torch.set_num_threads(2)
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
    model = VisionTransformer(32, 8, 2, 4, 64, 10, device="cpu")
    ddp = DistributedDataParallel(
        model, optimizer=optim.AdamW(lr=3e-4, weight_decay=0.05),
        loss_fn=nn.CrossEntropyLoss(), group=pg)
    state = ddp.init(seed=0)
    res = {}
    rows = slice(rank * 4, (rank + 1) * 4)
    for step in range(3):
        load_jax_params(model, tree(f"p{step}"))
        opt = {"m": tree(f"m{step}"), "v": tree(f"v{step}"),
               "step": d[f"step{step}"]}
        state = state._replace(
            opt_state=load_jax_opt_state(ddp.optimizer, opt, model))
        x = torch.from_numpy(d[f"x{step}"][rows])
        y = torch.from_numpy(d[f"y{step}"][rows]).long()
        state, m = ddp.train_step(state, x, y)
        res[f"{step}:loss"] = float(m["loss"])
        res[f"{step}:correct"] = int(m["correct"])
        for k, v in state.params.items():
            res[f"{step}:p:{k}"] = v.detach().numpy().copy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def _flat(prefix, tree):
    return {f"{prefix}|{p}|{k}": np.asarray(v) for p, lv in tree.items()
            for k, v in lv.items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world2_adamw_steps_match_jax(tmp_path):
    """Three JAX steps over two devices at global batch 8; the port's two
    gloo ranks take each from the same state, 4 rows each, and must both
    match it."""
    jd = _jax_ddp(world=2)
    js = _jax_start(jd)
    feed, want = {}, []
    for step in range(STEPS):
        x, y = _images(8, seed=20 + step)
        feed[f"x{step}"] = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        feed[f"y{step}"] = y
        feed.update(_flat(f"p{step}", _np(js.params)))
        feed.update(_flat(f"m{step}", _np(js.opt_state["m"])))
        feed.update(_flat(f"v{step}", _np(js.opt_state["v"])))
        feed[f"step{step}"] = np.asarray(js.opt_state["step"])
        before = _port_params(js.params)
        js, jm = jd.train_step(js, jnp.asarray(x), jnp.asarray(y))
        want.append(dict(loss=float(jm["loss"]), correct=int(jm["correct"]),
                         before=before, params=_port_params(js.params)))
    np.savez(tmp_path / "in.npz", **feed)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port),
         str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz")], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err
    ranks = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    for res in ranks:
        for step, w in enumerate(want):
            assert abs(res[f"{step}:loss"] - w["loss"]) <= 1e-5 * abs(
                w["loss"]), (step, res[f"{step}:loss"], w["loss"])
            assert res[f"{step}:correct"] == w["correct"]
            got = {k.split(":", 2)[2]: torch.from_numpy(v)
                   for k, v in res.items() if k.startswith(f"{step}:p:")}
            leaf, total = _update_errors(got, w["params"], w["before"])
            worst = max(leaf, key=leaf.get)
            assert leaf[worst] <= LEAF_TOL, (step, worst, leaf[worst])
            assert total <= STEP_TOL, (step, total)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
