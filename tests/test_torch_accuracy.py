"""The port's ``accuracy_run`` recipes against the JAX package's.

- **First steps.** The MNIST recipe and the low-SNR oracle, each made by
  the port's build function, against the JAX recipe built from the JAX
  package (its ``ConvNet``, ``DistributedDataParallel`` over one device,
  ``DataLoader`` and ``DeviceLoader``), from the JAX initial weights moved with
  ``interop.load_jax_params``: the batches equal, and 20 steps in a row,
  each from the JAX run's state (parameters and momentum set to it before
  the step), with the loss within 1e-5 relative (float32, the same sums in
  another order) and the update within 4e-2 of its norm over all
  parameters (``tests/test_torch_vision_ddp.py``'s step tolerance: a ReLU
  or max-pool input within rounding of a tie takes the other branch in
  one run).  Left to run free, the two trajectories part at the oracle's
  rate from about step 11 on (1.4e-5 relative at step 19, measured), as
  float32 rounding grows under momentum; the re-alignment holds each step
  to what it computes.
- **The oracle band.** ``run_noisy_oracle`` at the JAX spec (20,000
  training and 10,000 test images) for 2 epochs at world 1, and the twin
  of the JAX ``test_pipeline_hits_the_analytic_band`` (2 epochs, global
  batch 100 over four gloo ranks): the test accuracy within 3 binomial
  standard errors of the analytic ceiling 0.775.
- **torch parity.** ``run_torch_parity`` (200 steps at lr 0.05): the largest
  step loss delta below 4e-3, the mean below 4e-4, the eval accuracies
  within 0.005 and the task learnt — the JAX test's bounds at that rate
  (``tests/test_torch_e2e_parity.py``).
- **The recorded rows.** ``ACCURACY_TORCH.json`` holds the CIFAR oracle
  measured on an NVIDIA card, inside its band.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_dist import models as jmodels
from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.data import (MNIST as JMNIST, ArrayImageDataset as JArrays,
                           DataLoader as JDataLoader,
                           DeviceLoader as JDeviceLoader,
                           DistributedSampler as JSampler,
                           synthetic_mnist_noisy_arrays as jnoisy,
                           transforms as jtransforms)
from tpu_dist.dist.process_group import ProcessGroup as JaxGroup
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import dist as tdist
from tpu_dist_torch import models as tmodels
from tpu_dist_torch.benchmarks import accuracy_run
from tpu_dist_torch.interop import load_jax_params

REPO = Path(__file__).resolve().parent.parent
STEPS = 20
LOSS_RTOL = 1e-5
UPDATE_TOL = 4e-2


@pytest.fixture(autouse=True)
def _two_threads():
    """torch's intra-op threads held to two for each test: the suite runs
    several files at once, and a small model's ops on every core of a
    shared host spend their time contending, not computing."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture
def world1():
    if tdist.is_initialized():
        tdist.destroy_process_group()
    pg = tdist.init_process_group(device="cpu")
    try:
        yield pg
    finally:
        tdist.destroy_process_group()


def _jax_recipe(name):
    """The JAX recipe at world 1: ``(ddp, loader)``."""
    group = JaxGroup(jax.devices()[:1])
    norm = jtransforms.Normalize(jtransforms.MNIST_MEAN,
                                 jtransforms.MNIST_STD)
    if name == "mnist":
        ds = JMNIST(root="./data", train=True, transform=norm,
                    synthetic_fallback=True)
        sampler = JSampler(ds, num_replicas=1, rank=0, shuffle=False)
        loader = JDataLoader(ds, batch_size=100, sampler=sampler,
                             drop_last=True, num_workers=2)
        opt = joptim.SGD(lr=1e-4, momentum=0.0)
    else:
        xtr, ytr = jnoisy(True, 20000, label_noise=0.25)
        loader = JDataLoader(JArrays(xtr, ytr, transform=norm),
                             batch_size=100, drop_last=True, shuffle=True,
                             seed=0)
        opt = joptim.SGD(lr=0.01, momentum=0.9)
    ddp = JaxDDP(jmodels.ConvNet(), optimizer=opt,
                 loss_fn=jnn.CrossEntropyLoss(), group=group, donate=False)
    return ddp, JDeviceLoader(loader, group=group)


def _set_state(ddp, state, jstate):
    """The port's parameters and momentum set to the JAX state's."""
    load_jax_params(ddp.module, jax.tree.map(np.asarray, jstate.params))
    if "momentum" in jstate.opt_state:
        scratch = tmodels.ConvNet(device="cpu")
        load_jax_params(scratch, jax.tree.map(np.asarray,
                                              jstate.opt_state["momentum"]))
        for k, v in scratch.named_parameters():
            state.opt_state["momentum"][k].copy_(v)


def _params(ddp_module):
    return {k: v.detach().clone() for k, v in ddp_module.named_parameters()}


@pytest.mark.parametrize("name", ["mnist", "noisy_oracle"])
def test_first_steps_match_jax(world1, name):
    jddp, jloader = _jax_recipe(name)
    jstate = jddp.init(seed=0)
    if name == "mnist":
        ddp, loader, _ = accuracy_run.build_mnist(world1)
    else:
        ddp, loader, _ = accuracy_run.build_noisy_oracle(world1, n_test=1000)
    state = ddp.init(seed=0)
    scratch = tmodels.ConvNet(device="cpu")
    losses = []
    for i, ((jx, jy), (x, y)) in enumerate(zip(jloader, loader)):
        if i == STEPS:
            break
        np.testing.assert_array_equal(
            np.asarray(jx).transpose(0, 3, 1, 2), x.numpy())
        np.testing.assert_array_equal(np.asarray(jy), y.numpy())
        _set_state(ddp, state, jstate)
        before = _params(ddp.module)
        jstate, jm = jddp.train_step(jstate, jx, jy)
        state, m = ddp.train_step(state, x, y)
        got, want = float(m["loss"]), float(jm["loss"])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (i, got, want)
        load_jax_params(scratch, jax.tree.map(np.asarray, jstate.params))
        num = den = 0.0
        for k, w in scratch.named_parameters():
            w = w.detach()
            num += float((state.params[k].detach() - w).norm()) ** 2
            den += float((w - before[k]).norm()) ** 2
        assert (num / den) ** 0.5 <= UPDATE_TOL, (i, (num / den) ** 0.5)
        losses.append(want)
    assert len(losses) == STEPS
    if name == "noisy_oracle":   # the rate moves the loss within 20 steps
        assert min(losses[-5:]) < losses[0]


def test_noisy_oracle_lands_in_band():
    """World 1 at the JAX spec but 2 epochs, as the JAX pipeline test runs
    it (the card's rows are in band from the first epoch on)."""
    row = accuracy_run.run_noisy_oracle(epochs=2, device="cpu")
    ceiling, se3 = accuracy_run.oracle_band(10000)
    assert row["test_samples"] == 10000
    assert row["analytic_ceiling"] == pytest.approx(0.775)
    assert row["expected_band"] == [round(ceiling - se3, 4),
                                    round(ceiling + se3, 4)]
    acc = row["final_test_accuracy"]
    assert row["in_band"] and ceiling - se3 <= acc <= ceiling + se3, row
    assert len(row["test_accuracy_per_epoch"]) == 2
    assert row["device"] == "cpu" and row["nvidia_smi"] is None


def test_oracle_band_rejects_an_undershoot():
    """The band is two-sided and tight: a pipeline a few points short of the
    ceiling lies outside it, as does one above it."""
    ceiling, se3 = accuracy_run.oracle_band(10000)
    assert se3 == pytest.approx(0.0125, abs=1e-4)
    assert not ceiling - se3 <= 0.76 <= ceiling + se3
    assert not ceiling - se3 <= 0.79 <= ceiling + se3
    # a reduced test set widens the band by the same formula
    assert accuracy_run.oracle_band(2500)[1] == pytest.approx(2 * se3)


def test_torch_parity_meets_the_jax_bounds():
    row = accuracy_run.run_torch_parity(device="cpu")
    assert row["max_step_loss_delta"] < 4e-3
    assert row["mean_step_loss_delta"] < 4e-4
    ta, pa = (row["final_eval_accuracy_torch"],
              row["final_eval_accuracy_tpu_dist"])
    assert abs(ta - pa) <= 0.005
    assert ta > 0.95 and row["final_loss_tpu_dist"] < 0.1
    assert len(row["curve_torch_every10"]) == 20


def test_parity_data_equals_the_reference_tests():
    """The row's data are the JAX parity test's ``make_data``."""
    sys.path.insert(0, str(REPO))
    from tests.test_torch_e2e_parity import make_data
    for n, seed in ((300, 0), (50, 3)):
        want = make_data(n, seed)
        got = accuracy_run.make_parity_data(n, seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_main_refuses_without_a_card_and_merges_rows(tmp_path):
    """``--device cuda`` without a card exits 2 before any work; a mode's
    row merges into the file and keeps what it held."""
    out = tmp_path / "rows.json"
    assert accuracy_run.main(["--noisy-oracle-only", "--out",
                              str(out)]) == 2
    assert not out.exists()
    out.write_text(json.dumps({"kept": {"a": 1}}))
    accuracy_run.merge_write({"new": {"b": 2}}, str(out))
    assert json.loads(out.read_text()) == {"kept": {"a": 1},
                                           "new": {"b": 2}}


def test_recorded_cifar_oracle_row_in_band():
    """The ResNet/BatchNorm/augmentation pipeline's card recording
    (``ACCURACY_TORCH.json`` ``cifar_resnet_low_snr_oracle``, written by
    ``accuracy_run --cifar-oracle-only``) exists, names an NVIDIA card and
    lies inside its analytic band.  ResNet-18 at batch 256 for 8 epochs is
    too slow for the CPU, so the recorded run is held here."""
    rows = json.loads((REPO / "ACCURACY_TORCH.json").read_text())
    row = rows.get("cifar_resnet_low_snr_oracle")
    assert row is not None, "run accuracy_run --cifar-oracle-only on a card"
    assert "NVIDIA" in row["device"] and "NVIDIA" in row["nvidia_smi"]
    assert row["analytic_ceiling"] == pytest.approx(0.775)
    lo, hi = row["expected_band"]
    ceiling, se3 = accuracy_run.oracle_band(row["test_samples"])
    assert (lo, hi) == (round(ceiling - se3, 4), round(ceiling + se3, 4))
    acc = row["final_test_accuracy"]
    assert row["in_band"] and lo <= acc <= hi, (acc, lo, hi)
    assert "example_mp" in row["recipe"]
    assert len(row["test_accuracy_per_epoch"]) == 8


_ORACLE_RANK = textwrap.dedent("""
    import json, sys
    from tpu_dist_torch import dist
    from tpu_dist_torch.benchmarks import accuracy_run
    pg = dist.init_process_group(init_method="env://", device="cpu")
    try:
        row = accuracy_run.run_noisy_oracle(epochs=2, batch_per_replica=25,
                                            device="cpu")
    finally:
        dist.destroy_process_group()
    with open(sys.argv[1] + f"/rank{pg.rank}.json", "w") as f:
        json.dump(row, f)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pipeline_hits_the_analytic_band_on_four_ranks(tmp_path):
    """The twin of the JAX ``test_pipeline_hits_the_analytic_band``: the
    MNIST oracle's pipeline over four gloo ranks (global batch 100, 25 a
    rank; the test set in global batches of 4,000, each rank scoring its
    quarter) for 2 epochs lands in the band, the same on every rank."""
    world = 4
    env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ORACLE_RANK, str(tmp_path)], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    rows = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]
    ceiling, se3 = accuracy_run.oracle_band(10000)
    for row in rows:
        assert row["test_samples"] == 10000
        acc = row["final_test_accuracy"]
        assert ceiling - se3 <= acc <= ceiling + se3, (
            f"accuracy {acc:.4f} outside [{ceiling - se3:.4f}, "
            f"{ceiling + se3:.4f}]")
        assert row["test_accuracy_per_epoch"] == \
            rows[0]["test_accuracy_per_epoch"]
