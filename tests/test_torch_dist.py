"""The port's process group and DDP across processes, on the CPU with gloo.

Two ranks, each with half of the batch, must take the same steps as one
rank with the whole batch: DDP averages the gradients of the two half-batch
means, which is the gradient of the whole-batch mean.  So must the dropless
MoE model, whose routing is per token; its aux losses, averaged over the
ranks as the JAX package averages module state, are the mean of the ranks'
own.  float32; the tolerance covers the all-reduce summing in another order
(1e-6 relative)."""

import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from tpu_dist_torch import dist, nn, optim
    from tpu_dist_torch.models import TransformerLM
    from tpu_dist_torch.parallel import DistributedDataParallel

    rank, world, port, out, experts = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4],
                                       int(sys.argv[5]))
    pg = dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=world, rank=rank, device="cpu",
                                 timeout=60)
    assert (dist.get_world_size(), dist.get_rank()) == (world, rank)
    assert pg.backend == "gloo"
    model = TransformerLM(vocab_size=31, dim=16, depth=1, num_heads=2,
                          max_seq_len=8, num_experts=experts,
                          moe_dispatch="dropless", device="cpu")
    ddp = DistributedDataParallel(
        model, optimizer=optim.SGD(lr=0.5, momentum=0.9),
        loss_fn=nn.CrossEntropyLoss(fused=True), group=pg)
    state = ddp.init(seed=0)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 31, (4, 8))
    y = rng.integers(0, 31, (4, 8))
    rows = slice(rank * 4 // world, (rank + 1) * 4 // world)
    for _ in range(2):
        state, m = ddp.train_step(state, torch.from_numpy(x[rows]),
                                  torch.from_numpy(y[rows]))
    aux = {"aux:" + p: float(v["aux_loss"])
           for p, v in state.model_state.items()}
    local = {"local_aux:" + p: float(model.get_submodule(p).aux_loss)
             for p in state.model_state}
    np.savez(out, loss=float(m["loss"]), correct=int(m["correct"]),
             **{k: v.detach().numpy() for k, v in state.params.items()},
             **aux, **local)
    dist.destroy_process_group()
    assert not dist.is_initialized()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, tmp_path, experts=0):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         str(tmp_path / f"w{world}_r{r}.npz"), str(experts)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err
    return [dict(np.load(tmp_path / f"w{world}_r{r}.npz"))
            for r in range(world)]


def test_ddp_world2_gloo_matches_world1(tmp_path):
    (one,) = _launch(1, tmp_path)
    two = _launch(2, tmp_path)
    for res in two:
        assert set(res) == set(one)
        np.testing.assert_allclose(res["loss"], one["loss"], rtol=1e-6)
        assert int(res["correct"]) == int(one["correct"])
        for key in one:
            np.testing.assert_allclose(res[key], one[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)


def test_moe_ddp_world2_gloo_matches_world1(tmp_path):
    (one,) = _launch(1, tmp_path, experts=4)
    two = _launch(2, tmp_path, experts=4)
    params = [k for k in one if ":" not in k and k not in ("loss", "correct")]
    assert "block0.mlp.w1" in params
    for res in two:
        np.testing.assert_allclose(res["loss"], one["loss"], rtol=1e-6)
        for key in params:
            np.testing.assert_allclose(res[key], one[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)
        # model_state holds the mean of the two ranks' own aux losses
        mean_local = np.mean([r["local_aux:block0.mlp"] for r in two])
        np.testing.assert_allclose(res["aux:block0.mlp"], mean_local,
                                   rtol=1e-6)


def test_world1_group_without_init_method():
    from tpu_dist_torch import dist
    pg = dist.init_process_group(device="cpu")
    try:
        assert (pg.size(), pg.rank, pg.backend) == (1, 0, None)
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="already initialized"):
            dist.init_process_group(device="cpu")
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_method"):
        dist.init_process_group(world_size=2, device="cpu")
