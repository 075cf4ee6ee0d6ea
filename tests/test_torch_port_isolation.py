"""The port stands alone: ``tpu_dist_torch`` imports neither ``jax`` nor
``tpu_dist``, and its entry points do not move to the CPU on their own."""

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
FORBIDDEN = ("jax", "tpu_dist")


def test_imports_with_jax_and_tpu_dist_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["tpu_dist"] = None
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
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist")
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
    from tpu_dist_torch.examples import (example_imagenet, example_mp,
                                         mpspawn_dist, train_lm)
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
                          (example_imagenet, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.train(example.parse_args(argv))
        assert not dist.is_initialized()
    for bench in (convnet, resnet_cifar, imagenet_e2e, vit_train):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.run()
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
