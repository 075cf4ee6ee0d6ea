"""Sub-groups and barriers of the port (``dist.new_group``, ``barrier``,
``monitored_barrier``, ``abort``) at world 4 over gloo, started by the
port's launcher, against the JAX package.

Every rank makes both sub-groups, ``[0, 1]`` and ``[2, 3]`` (members and
non-members alike, as torch requires).  Ranks 0 and 1 take one ConvNet DDP
step over ``[0, 1]`` with half of a batch of 8 each, from the JAX initial
parameters; the JAX DDP takes the same step over ``new_group([0, 1])`` of
two virtual devices.  Held as ``tests/test_torch_vision_ddp.py`` holds a
step: the loss within 1e-5 relative, the correct count equal, the
BatchNorm statistics within 1e-6 + 1e-5 relative, each parameter's update
within 8e-2 of its norm and all of them within 4e-2 (a ReLU input within
rounding of 0 may take the other branch in one run).  Ranks 2 and 3
all-reduce over ``[2, 3]`` alone; a non-member's use of ``[0, 1]`` raises
``GroupMembershipError`` naming its rank; ``monitored_barrier`` passes
twice, then names rank 3 when rank 3 stays away, and the JAX package's
``monitored_barrier`` names it the same way; ``abort`` leaves with no
teardown."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import dist as jdist
from tpu_dist import models as jmodels
from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist.parallel import DistributedDataParallel as JaxDDP
from tpu_dist_torch import models as tmodels
from tpu_dist_torch.interop import load_jax_params

pytestmark = pytest.mark.multiprocess

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
    import json, os, sys, time
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.interop import load_jax_params
    from tpu_dist_torch.models import ConvNet
    from tpu_dist_torch.parallel import DistributedDataParallel

    out = sys.argv[1]
    pg = dist.init_process_group(init_method="env://", device="cpu")
    rank = dist.get_rank()
    pair = dist.new_group([0, 1])
    other = dist.new_group([2, 3])
    rec = {"rank": rank, "world": dist.get_world_size(),
           "num_processes": dist.get_num_processes(),
           "local_world_size": dist.get_local_world_size(),
           "backend": dist.get_backend()}
    if rank < 2:
        rec["pair"] = [pair.rank, pair.size(), list(pair.ranks)]
        feed = dict(np.load(os.path.join(out, "in.npz")))
        tree = {}
        for k, v in feed.items():
            if k.startswith("p|"):
                _, path, leaf = k.split("|")
                tree.setdefault(path, {})[leaf] = v
        model = ConvNet(device="cpu")
        load_jax_params(model, tree)
        ddp = DistributedDataParallel(model, optimizer=optim.SGD(lr=0.05),
                                      loss_fn=nn.CrossEntropyLoss(),
                                      group=pair)
        state = ddp.init(seed=0)
        load_jax_params(model, tree)   # init drew fresh weights
        rows = slice(4 * rank, 4 * rank + 4)
        state, m = ddp.train_step(state, torch.from_numpy(feed["x"][rows]),
                                  torch.from_numpy(feed["y"][rows]))
        np.savez(os.path.join(out, f"step{rank}.npz"),
                 loss=float(m["loss"]), correct=int(m["correct"]),
                 **{"p:" + k: v.detach().numpy()
                    for k, v in state.params.items()},
                 **{f"s:{p}:{k}": v.numpy()
                    for p, lv in state.model_state.items()
                    for k, v in lv.items()})
        dist.barrier(pair)
    else:
        try:
            pair.rank
        except dist.GroupMembershipError as e:
            rec["non_member"] = str(e)
        t = torch.tensor([float(rank)])
        torch.distributed.all_reduce(t, group=other.torch_group)
        rec["other_sum"] = t.item()
        rec["other"] = [other.rank, other.size()]
        dist.barrier(other)
    dist.barrier()
    dist.monitored_barrier(timeout=60)
    dist.monitored_barrier(timeout=60)
    if rank != 3:
        try:
            dist.monitored_barrier(timeout=3)
            rec["missing"] = None
        except RuntimeError as e:
            rec["missing"] = str(e)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.abort(0)   # no teardown: rank 3 never meets the others again
""")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(jparams):
    scratch = tmodels.ConvNet(device="cpu")
    load_jax_params(scratch, _np(jparams))
    return {k: v.detach() for k, v in scratch.named_parameters()}


@pytest.fixture(scope="module")
def jax_step():
    """One JAX DDP step over ``new_group([0, 1])`` of the virtual devices;
    returns (inputs for the port, the JAX results)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(8, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    jdist.init_process_group(backend="cpu")
    try:
        pair = jdist.new_group([0, 1])
        assert pair.size() == 2
        ddp = JaxDDP(jmodels.ConvNet(), optimizer=joptim.SGD(lr=0.05),
                     loss_fn=jnn.CrossEntropyLoss(), group=pair,
                     donate=False)
        st = ddp.init(seed=0)
        feed = {f"p|{p}|{k}": np.asarray(v) for p, lv in
                _np(st.params).items() for k, v in lv.items()}
        feed["x"] = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        feed["y"] = y
        before = _port_params(st.params)
        st, m = ddp.train_step(st, jnp.asarray(x), jnp.asarray(y))
        want = dict(loss=float(m["loss"]), correct=int(m["correct"]),
                    before=before, params=_port_params(st.params),
                    stats=_np(st.model_state))
    finally:
        jdist.destroy_process_group()
    return feed, want


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_step):
    feed, _ = jax_step
    tmp = tmp_path_factory.mktemp("world4")
    np.savez(tmp / "in.npz", **feed)
    (tmp / "w.py").write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--nproc_per_node=4",
         "--master_port=0", str(tmp / "w.py"), str(tmp)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    recs = {}
    for rank in range(4):
        with open(tmp / f"rank{rank}.json") as f:
            recs[rank] = json.load(f)
    steps = [dict(np.load(tmp / f"step{r}.npz")) for r in range(2)]
    return recs, steps


def test_subgroup_ddp_step_matches_the_jax_subgroup(world4, jax_step):
    _, want = jax_step
    _, steps = world4
    for res in steps:
        assert abs(float(res["loss"]) - want["loss"]) <= \
            1e-5 * abs(want["loss"])
        assert int(res["correct"]) == want["correct"]
        num = den = 0.0
        for k, w in want["params"].items():
            e = float((torch.from_numpy(res["p:" + k]) - w).norm())
            u = float((w - want["before"][k]).norm())
            assert e <= 8e-2 * u, k
            num, den = num + e * e, den + u * u
        assert (num / den) ** 0.5 <= 4e-2
        for p, lv in want["stats"].items():
            for k, w in lv.items():
                np.testing.assert_allclose(res[f"s:{p}:{k}"], w, rtol=1e-5,
                                           atol=1e-6)
    for k in steps[0]:
        np.testing.assert_array_equal(steps[0][k], steps[1][k], err_msg=k)


def test_membership_counts_and_the_other_pair(world4):
    recs, _ = world4
    for rank, rec in recs.items():
        assert (rec["world"], rec["num_processes"],
                rec["local_world_size"], rec["backend"]) == (4, 4, 1, "gloo")
    assert recs[0]["pair"] == [0, 2, [0, 1]]
    assert recs[1]["pair"] == [1, 2, [0, 1]]
    for rank in (2, 3):
        assert f"global rank {rank} is not a member" in \
            recs[rank]["non_member"]
        assert recs[rank]["other_sum"] == 5.0
        assert recs[rank]["other"] == [rank - 2, 2]


def test_monitored_barrier_names_the_missing_rank(world4):
    recs, _ = world4
    assert "process rank(s) [3] did not reach the barrier" in \
        recs[0]["missing"]
    for rank in (1, 2):
        assert "waiting for process 0's release" in recs[rank]["missing"]


def test_jax_monitored_barrier_names_the_same_rank():
    """The JAX package's monitored_barrier on the same keys: rank 3's
    arrival missing from the store, process 0 names it."""
    from tpu_dist.dist import process_group as jpg
    from tpu_dist_torch.dist.store import TCPStore

    store = TCPStore(is_master=True, timeout=10)
    try:
        for r in (1, 2):
            store.set(f"__monitored_barrier__/0/arrived/{r}", b"1")

        class Group:   # four processes, process 0 here
            _parent = None
            num_processes = 4
        rdzv = jpg._rdzv
        saved = (rdzv._store, jpg._MB_SEQ[0], jpg._MB_PASSED[0],
                 jpg.get_rank)
        rdzv._store, jpg._MB_SEQ[0], jpg._MB_PASSED[0] = store, 0, -1
        jpg.get_rank = lambda group=None: 0
        try:
            with pytest.raises(RuntimeError,
                               match=r"process rank\(s\) \[3\] did not"):
                jpg.monitored_barrier(Group(), timeout=0.5)
        finally:
            (rdzv._store, jpg._MB_SEQ[0], jpg._MB_PASSED[0],
             jpg.get_rank) = saved
    finally:
        store.close()
