"""The port stands alone: ``tpu_dist_torch`` imports neither ``jax`` nor
``tpu_dist`` (nor ``ml_dtypes``, which the card's machine lacks, nor the
repo's ``tests``), and its entry points do not move to the CPU on their
own."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tpu_dist_torch"
FORBIDDEN = ("jax", "tpu_dist", "ml_dtypes", "tests")


def test_imports_with_jax_and_tpu_dist_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["tpu_dist"] = None
        sys.modules["ml_dtypes"] = None
        import tpu_dist_torch
        import tpu_dist_torch.interop
        import tpu_dist_torch.benchmarks.transformer_lm
        import tpu_dist_torch.benchmarks.moe_lm
        import tpu_dist_torch.benchmarks.profile_step
        import tpu_dist_torch.benchmarks.serve_lm
        import tpu_dist_torch.nn.quant
        import tpu_dist_torch.serve
        import tpu_dist_torch.random
        import tpu_dist_torch.serve._wire
        import tpu_dist_torch.utils
        import tpu_dist_torch.data
        import tpu_dist_torch.launch
        import tpu_dist_torch.examples.mpspawn_dist
        import tpu_dist_torch.examples.example_mp
        import tpu_dist_torch.benchmarks.convnet
        import tpu_dist_torch.benchmarks.resnet_cifar
        import tpu_dist_torch.optim
        import tpu_dist_torch.optim.adagrad
        import tpu_dist_torch.optim.adamw
        import tpu_dist_torch.optim.clip
        import tpu_dist_torch.optim.ema
        import tpu_dist_torch.optim.lr_scheduler
        import tpu_dist_torch.optim.rmsprop
        import tpu_dist_torch.optim.sgd
        import tpu_dist_torch.checkpoint
        import tpu_dist_torch.collectives
        import tpu_dist_torch.examples.train_lm
        import tpu_dist_torch.parallel.ring_attention
        import tpu_dist_torch.dist.process_group
        import tpu_dist_torch.benchmarks.sp_lm
        import tpu_dist_torch.data.datasets
        import tpu_dist_torch.data.device_augment
        import tpu_dist_torch.data.sampler
        import tpu_dist_torch.data.transforms
        import tpu_dist_torch.models.vit
        import tpu_dist_torch.examples.example_imagenet
        import tpu_dist_torch.benchmarks.imagenet_e2e
        import tpu_dist_torch.benchmarks.vit_train
        import tpu_dist_torch.dist.store
        import tpu_dist_torch.dist.rendezvous
        import tpu_dist_torch.resilience
        import tpu_dist_torch.resilience.heartbeat
        import tpu_dist_torch.launch.cli
        import tpu_dist_torch.run
        import tpu_dist_torch.serve.frontend
        import tpu_dist_torch.serve.__main__
        import tpu_dist_torch.examples.launch_dist
        import tpu_dist_torch.examples.example_launch
        import tpu_dist_torch.examples.serve_lm
        import tpu_dist_torch.collectives.ops
        import tpu_dist_torch.collectives.eager
        import tpu_dist_torch.collectives.work
        import tpu_dist_torch.collectives.bucketer
        import tpu_dist_torch.parallel.zero
        import tpu_dist_torch.resilience.chaos
        import tpu_dist_torch.resilience.reshard
        import tpu_dist_torch.resilience.state
        import tpu_dist_torch.utils.logging
        import tpu_dist_torch.examples.elastic_train
        import tpu_dist_torch.benchmarks.bench_zero
        import tpu_dist_torch.collectives._lowp
        import tpu_dist_torch.collectives.quant
        import tpu_dist_torch.collectives.transport
        import tpu_dist_torch.collectives.shm
        import tpu_dist_torch.collectives.ring
        import tpu_dist_torch.collectives.topology
        import tpu_dist_torch.benchmarks.bench_host_collectives
        import tpu_dist_torch.benchmarks.bench_overlap
        import tpu_dist_torch.benchmarks.accuracy_run
        import tpu_dist_torch.benchmarks.host_sync
        import tpu_dist_torch.benchmarks.elastic_ring
        import tpu_dist_torch.obs
        import tpu_dist_torch.obs.__main__
        import tpu_dist_torch.analysis
        import tpu_dist_torch.analysis.sanitizer
        import tpu_dist_torch.analysis.findings
        import tpu_dist_torch.analysis.rules
        import tpu_dist_torch.analysis.linter
        import tpu_dist_torch.analysis.protocol
        import tpu_dist_torch.analysis.replay
        import tpu_dist_torch.analysis.__main__
        import tpu_dist_torch.utils.memory
        import tpu_dist_torch.utils.profiler
        import tpu_dist_torch.utils.metrics
        # the tools run with jax and tpu_dist blocked
        from tpu_dist_torch.analysis import lint_source, replay_dumps
        from tpu_dist_torch.analysis.protocol import build_graph
        assert lint_source("store.wait(keys)")[0].rule == "TD004"
        g, _, _ = build_graph(roles_spec="a:1,b:1",
                              channels_spec="x:a>b:2,y:b>a:2")
        assert tpu_dist_torch.analysis.verify_graph(g)[0].rule == "TD101"
        assert replay_dumps([]).findings == []
        import tpu_dist_torch.roles
        import tpu_dist_torch.roles.channel
        import tpu_dist_torch.roles.launcher
        import tpu_dist_torch.roles.runtime
        import tpu_dist_torch.examples.actor_learner
        import tpu_dist_torch.examples.param_server
        import tpu_dist_torch.benchmarks.bench_roles
        import tpu_dist_torch.benchmarks.bench_obs_overhead
        import tpu_dist_torch.benchmarks.obs_stall
        import tpu_dist_torch.cluster
        import tpu_dist_torch.cluster.agent
        import tpu_dist_torch.cluster.endpoints
        import tpu_dist_torch.cluster.membership
        import tpu_dist_torch.cluster.replica
        import tpu_dist_torch.resilience.netchaos
        import tpu_dist_torch.benchmarks.cluster_elastic
        import tpu_dist_torch.pipeline
        import tpu_dist_torch.pipeline.partition
        import tpu_dist_torch.pipeline.schedule
        import tpu_dist_torch.pipeline.stage
        import tpu_dist_torch.pipeline.train
        import tpu_dist_torch.parallel.pipeline
        import tpu_dist_torch.examples.pipeline_train
        import tpu_dist_torch.benchmarks.bench_pipeline
        import tpu_dist_torch.models.vgg
        import tpu_dist_torch.benchmarks.generate
        import tpu_dist_torch.benchmarks.attention
        import tpu_dist_torch.benchmarks.input_pipeline
        import tpu_dist_torch.benchmarks.scaling
        # the native store is built and served with jax and tpu_dist blocked
        from tpu_dist_torch.dist import TCPStore
        s = TCPStore(is_master=True, timeout=10)
        s.set("k", b"v")
        assert s.get("k") == b"v" and s.native
        s.close()
        # and the cluster's replicating Python wire, with a follower
        from tpu_dist_torch.cluster import StoreFollower
        from tpu_dist_torch.dist.store import PyTCPStoreServer
        leader = PyTCPStoreServer(replicate=True)
        with StoreFollower("127.0.0.1", leader.port) as fo:
            assert fo.wait_caught_up(leader.replication_seq())
        leader.stop()
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist",
                                               "ml_dtypes")
                        and sys.modules[m] is not None)
        assert not loaded, loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_tpu_dist(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}")


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no device argument and no CUDA device, the entry points raise
    instead of running on the CPU."""
    from tpu_dist_torch import data, dist, nn, optim
    from tpu_dist_torch.benchmarks import (convnet, imagenet_e2e,
                                           resnet_cifar, serve_lm, vit_train)
    from tpu_dist_torch.benchmarks.transformer_lm import run
    from tpu_dist_torch.benchmarks import bench_zero
    from tpu_dist_torch.examples import (elastic_train, example_imagenet,
                                         example_launch, example_mp,
                                         launch_dist, mpspawn_dist, train_lm)
    from tpu_dist_torch.examples import serve_lm as serve_twin
    from tpu_dist_torch.models import (ConvNet, TransformerLM, resnet18,
                                       vit_b_16)
    from tpu_dist_torch.parallel import DistributedDataParallel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=11, dim=8, depth=1, num_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_process_group()
    assert not dist.is_initialized()
    for example, argv in ((mpspawn_dist, ["--synthetic"]),
                          (example_mp, ["--synthetic"]), (train_lm, []),
                          (example_imagenet, []),
                          (launch_dist, ["--synthetic"]),
                          (example_launch, ["--synthetic"]),
                          (elastic_train, ["--synthetic"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.train(example.parse_args(argv))
        assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_twin.main(["--tiny"])
    for bench in (convnet, resnet_cifar, imagenet_e2e, vit_train):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.run()
    assert bench_zero.main([]) == 2   # names --device cpu, runs nothing
    from tpu_dist_torch.benchmarks import (accuracy_run,
                                           bench_host_collectives,
                                           bench_overlap, elastic_ring,
                                           host_sync)
    from tpu_dist_torch.benchmarks import (bench_obs_overhead, bench_roles,
                                           cluster_elastic, obs_stall)
    for bench in (bench_host_collectives, bench_overlap, host_sync,
                  elastic_ring, bench_roles, bench_obs_overhead, obs_stall,
                  cluster_elastic):
        assert bench.main([]) == 2
    assert accuracy_run.main(["--quant-gate-only"]) == 2
    for mode in ([], ["--quick"], ["--torch-parity-only"],
                 ["--noisy-oracle-only"], ["--cifar-oracle-only"]):
        assert accuracy_run.main(mode) == 2   # before any work or file
    from tpu_dist_torch.benchmarks import (attention, generate,
                                           input_pipeline, scaling)
    from tpu_dist_torch.models import vgg11, vgg16_bn
    for fn in (generate.run, generate.run_prefill, attention.run,
               input_pipeline.run, scaling.run,
               lambda: vgg11(num_classes=10), vgg16_bn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    loader = data.DataLoader(data.TensorDataset(np.zeros(4), np.zeros(4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DeviceLoader(loader)
    # a DDP's model built on the default device
    for build in (ConvNet, lambda: resnet18(num_classes=10),
                  lambda: vit_b_16(num_classes=10)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistributedDataParallel(build(), optimizer=optim.SGD(lr=0.1),
                                    loss_fn=nn.CrossEntropyLoss())
    with pytest.raises(RuntimeError, match="CUDA events"):
        run(device="cpu")


LOWER_LAYERS = sorted((PORT / "models").rglob("*.py")) + sorted(
    (PORT / "nn").rglob("*.py"))


@pytest.mark.parametrize("path", LOWER_LAYERS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_models_and_nn_do_not_import_serving(path):
    """The model and layer modules sit below serving and the benchmarks:
    none of them imports ``tpu_dist_torch.serve`` or
    ``tpu_dist_torch.benchmarks``."""
    package = list(path.relative_to(REPO).with_suffix("").parts[:-1])
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            targets = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else []
            mod = ".".join(base + ([node.module] if node.module else []))
            targets = [mod] + [f"{mod}.{a.name}" for a in node.names]
        else:
            continue
        for name in targets:
            assert not name.startswith(("tpu_dist_torch.serve",
                                        "tpu_dist_torch.benchmarks")), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
