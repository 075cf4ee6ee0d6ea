"""The elastic path of the port against the JAX package's: the launcher's
world-change rule (``_elastic_new_world``), its ``--elastic_world`` checks,
and the ``elastic_train`` twin — its first steps against the JAX example's
at one shared init (``load_jax_params``), and under the port's launcher at
gloo world 2: killed and restarted (the resumed losses and final parameters
bit for bit an uninterrupted run's), and shrunk and regrown 2 → 1 → 2 with
``--zero`` (the optimizer shards resharded each time).

Every launched run has its own timeout; the interrupted and uninterrupted
runs of a comparison start together.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from tpu_dist.launch import cli as jcli
from tpu_dist_torch.launch import cli as tcli

REPO = str(pathlib.Path(__file__).resolve().parents[1])
RUN_TIMEOUT = 240


@pytest.mark.parametrize("rng,world,rcs", [
    (None, 2, [117, 0]), ((1, 4), 4, [117, None, None, None]),
    ((1, 4), 4, [117, 117, 1, None]), ((2, 4), 3, [117, 117, None]),
    ((1, 2), 1, [118]), ((1, 2), 2, [118, None]),
    ((1, 4), 2, [118, 117]), ((1, 4), 2, [1, None]), ((1, 4), 2, [0, 0]),
    ((1, 3), 3, [None, 117, 118])])
def test_elastic_new_world_is_the_jax_rule(rng, world, rcs):
    assert tcli._elastic_new_world(rng, world, rcs) == \
        jcli._elastic_new_world(rng, world, rcs)


@pytest.mark.parametrize("argv", [
    ["--elastic_world=3"], ["--elastic_world=2:1"], ["--elastic_world=0:2"],
    ["--nproc_per_node=3", "--elastic_world=1:2"],
    ["--elastic_world=1:2", "--no_store"]],
    ids=["no-colon", "min-above-max", "zero-min", "outside", "no-store"])
def test_bad_elastic_world_exits_2_like_the_jax_launcher(tmp_path, capfd,
                                                         argv):
    probe = tmp_path / "never.py"
    probe.write_text("raise SystemExit('spawned')\n")
    assert tcli.main([*argv, str(probe)]) == 2
    err = capfd.readouterr().err
    assert jcli.main([*argv, str(probe)]) == 2
    assert "--elastic_world" in err


# ---------------------------------------------------------------------------
# the twin's first steps against the JAX example's, one init
# ---------------------------------------------------------------------------

def _jax_example_steps(n_steps):
    """The JAX example's loop at world 1 (its batch(step), its fwd_bwd,
    SGD(0.01, momentum 0.9)), from ``model.init(PRNGKey(0))``."""
    from tpu_dist import optim
    from tpu_dist.data import synthetic_mnist_arrays
    from tpu_dist.models import ConvNet
    from tpu_dist.nn import functional as F
    model = ConvNet()
    params = model.init(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, params)
    images, labels = synthetic_mnist_arrays(train=True)
    images = images.reshape(-1, 28, 28, 1).astype(np.float32) / 255.0
    labels = labels.astype(np.int32)
    opt = optim.SGD(lr=0.01, momentum=0.9)
    state = opt.init(params)

    @jax.jit
    def fwd_bwd(p, x, y):
        return jax.value_and_grad(
            lambda q: F.cross_entropy(model.apply(q, x), y))(p)

    losses = []
    for step in range(n_steps):
        g = np.random.default_rng(10_000 + step)
        idx = g.integers(0, len(images), size=100)
        loss, grads = fwd_bwd(params, images[idx], labels[idx])
        params, state = opt.update(grads, state, params)
        losses.append(float(loss))
    return params0, losses, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("zero", [False, True], ids=["bucketer", "zero"])
def test_twin_first_steps_match_the_jax_example(tmp_path, monkeypatch, zero):
    import torch

    from tpu_dist_torch.examples import elastic_train
    from tpu_dist_torch.interop import load_jax_params
    from tpu_dist_torch.models import ConvNet
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR", "TPU_DIST_CHAOS"):
        monkeypatch.delenv(var, raising=False)
    torch.set_num_threads(2)
    params0, losses, params_j = _jax_example_steps(3)
    argv = ["--device", "cpu", "--synthetic", "--max-steps", "3",
            "--save-every", "0", "--ckpt-root", str(tmp_path / "ck")]
    res = elastic_train.train(
        elastic_train.parse_args(argv + (["--zero"] if zero else [])),
        init_params=lambda m: load_jax_params(m, params0))
    np.testing.assert_allclose([res["losses"][s] for s in range(3)], losses,
                               rtol=1e-5)
    want = dict(load_jax_params(ConvNet(device="cpu"),
                                params_j).named_parameters())
    for k, v in want.items():
        np.testing.assert_allclose(res["params"][k].detach().numpy(),
                                   v.detach().numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# under the port's launcher, gloo world 2
# ---------------------------------------------------------------------------

def _launch(tmp, name, launcher_args, twin_args, chaos=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "TPU_DIST_STORE_ADDR", "TPU_DIST_CHAOS",
                "TPU_DIST_RESTART_COUNT"):
        env.pop(var, None)
    if chaos:
        env["TPU_DIST_CHAOS"] = chaos
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--standalone",
         "--restart_backoff=0", *launcher_args, "-m",
         "tpu_dist_torch.examples.elastic_train", "--device", "cpu",
         "--synthetic", "--ckpt-root", str(tmp / f"ck_{name}"),
         "--record", str(tmp / f"{name}.jsonl"), *twin_args],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(procs):
    out = {}
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=RUN_TIMEOUT)
        finally:
            p.kill()
        out[name] = (p.returncode, err)
    return out


def _records(tmp, name):
    with open(tmp / f"{name}.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    steps = ["--max-steps", "8", "--save-every", "3"]
    procs = {
        "plain": _launch(tmp, "plain", ["--nproc_per_node=2"], steps),
        "killed": _launch(tmp, "killed",
                          ["--nproc_per_node=2", "--max_restarts=1"], steps,
                          chaos="kill:rank=0,step=3"),
        "zero_plain": _launch(tmp, "zero_plain", ["--nproc_per_node=2"],
                              ["--max-steps", "9", "--save-every", "3",
                               "--zero"]),
        "zero_elastic": _launch(
            tmp, "zero_elastic", ["--nproc_per_node=2",
                                  "--elastic_world=1:2"],
            ["--max-steps", "9", "--save-every", "3", "--zero"],
            chaos="shrink:rank=1,step=3;grow:rank=0,step=6,world=2"),
    }
    return tmp, _finish(procs)


def test_killed_run_restarts_once_and_resumes_bitwise(launched):
    tmp, res = launched
    for name in ("plain", "killed"):
        rc, err = res[name]
        assert rc == 0, (name, err[-3000:])
    err = res["killed"][1][-3000:]   # every message below names the run
    assert "restart 1/1" in res["killed"][1], err
    plain, killed = _records(tmp, "plain"), _records(tmp, "killed")
    want = {(r["rank"], r["step"]): r["loss"] for r in plain if "step" in r}
    resumed = {(r["rank"], r["step"]): r["loss"] for r in killed
               if "step" in r and r["gen"] == 1}
    assert sorted({s for _, s in resumed}) == list(range(4, 8)), (
        killed, err)
    assert resumed == {k: want[k] for k in resumed}, err
    first = {(r["rank"], r["step"]): r["loss"] for r in killed
             if "step" in r and r["gen"] == 0}
    assert first == {k: want[k] for k in first}, err
    finals = {r["final"] for r in plain + killed if "final" in r}
    starts = {(r["gen"], r["start"]) for r in killed if "final" in r}
    assert len(finals) == 1 and starts == {(1, 4)}, (finals, starts, err)


def test_shrink_and_grow_with_zero_resharded(launched):
    tmp, res = launched
    for name in ("zero_plain", "zero_elastic"):
        rc, err = res[name]
        assert rc == 0, (name, err[-3000:])
    err = res["zero_elastic"][1]
    assert "elastic world change: 2 -> 1" in err
    assert "elastic world change: 1 -> 2" in err
    assert "reshard plan: world 2 -> 1" in err
    assert "elastic-reshard" in err and "restart budget untouched" in err
    recs = _records(tmp, "zero_elastic")
    worlds = {}
    for r in recs:
        if "step" in r:
            worlds.setdefault(r["gen"], set()).add(r["rank"])
    assert worlds == {0: {0, 1}, 1: {0}, 2: {0, 1}}
    starts = {(r["gen"], r["start"]) for r in recs if "final" in r}
    assert starts == {(2, 7)}
    assert len({r["final"] for r in recs if "final" in r}) == 1
    # generation 0 ran the uninterrupted world-2 steps, bit for bit
    plain = {(r["rank"], r["step"]): r["loss"]
             for r in _records(tmp, "zero_plain") if "step" in r}
    g0 = {(r["rank"], r["step"]): r["loss"] for r in recs
          if "step" in r and r["gen"] == 0}
    assert g0 and all(plain[k] == v for k, v in g0.items())
    g1 = sorted(r["step"] for r in recs if "step" in r and r["gen"] == 1)
    assert g1 == [4, 5, 6]
