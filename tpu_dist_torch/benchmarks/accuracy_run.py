"""Convergence and accuracy recording — the port's twin of the JAX
package's ``benchmarks/accuracy_run.py``, every mode of it.

Rows go to ``ACCURACY_TORCH.json`` at the repo root (``--out``), merged
into what the file holds when it is written; each row names the device and,
on a card, its name and power limit as ``nvidia-smi`` prints them.  The
recipes are the JAX script's, through the port's sampler, loaders, DDP step
and ``evaluate``; the data are the deterministic synthetic sets (the JAX
package's bytes), stamped ``"data": "synthetic"``:

- **MNIST ConvNet** (the ``mpspawn_dist`` twin): SGD lr 1e-4 without
  momentum, batch 100 a replica, seed 0, 2 epochs,
  ``DistributedSampler(shuffle=False)``; the tuned row is the same recipe
  at lr 0.01, momentum 0.9, half the epochs.
- **CIFAR-10 ResNet-18 bf16** (the ``example_mp`` twin): SGD 0.02,
  momentum 0.9, weight decay 1e-4, nesterov, global batch 256,
  RandomCrop(32, 4) + flip + normalize on the host, a ``set_epoch``
  reshuffle a epoch, bf16 compute over float32 masters, 5 epochs.
- **torch parity**: the port's ConvNet through the port's loss and SGD
  against the reference tutorial's literal ``torch.nn`` ConvNet with
  ``torch.optim.SGD``, the same initial weights and batches (200 steps,
  lr 0.05, batch 100), TF32 off on a card.
- **the low-SNR oracles**: the ConvNet recipe (SGD 0.01, momentum 0.9,
  batch 100 a replica, 4 epochs) on ``synthetic_mnist_noisy_arrays`` and
  the CIFAR recipe (8 epochs) on ``synthetic_cifar10_noisy_arrays``, labels
  flipped with probability 0.25: the final accuracy must lie within 3
  binomial standard errors of the analytic ceiling ``(1 - rho) + rho/10``
  = 0.775.
- **the quantized wire's gate** (``--quant-gate-only``): the same recipe
  twice at world 2 over the host collective path, gradients averaged by
  :class:`~tpu_dist_torch.collectives.Bucketer` on the host ring, once on
  the float32 wire and once on ``int8_block256`` with an
  :class:`~tpu_dist_torch.collectives.quant.ErrorFeedback` residual; the
  accuracy delta within ±3 binomial standard errors of the float32 run's
  held-out accuracy (150 steps, batch 128, SGD 0.02 with momentum 0.9,
  20,000 training and 4,000 test images).  Its workers reach each other
  only through the control-plane store and the host data plane, so both
  ranks can share one card.  Its row is printed, not written.

Each recipe has a build function (model, DDP, datasets, loaders:
``build_mnist``, ``build_cifar``, ``build_noisy_oracle``,
``build_cifar_noisy_oracle``) and one loop shared by all
(:func:`train_epochs`).  Above one process the
recipes join the world that ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK`` describe (``python -m tpu_dist_torch.launch``), and rank 0 writes.
The model runs on ``--device`` (``cuda`` by default; without a card that
refuses with exit 2)::

    python -m tpu_dist_torch.benchmarks.accuracy_run
    python -m tpu_dist_torch.benchmarks.accuracy_run --noisy-oracle-only
    python -m tpu_dist_torch.benchmarks.accuracy_run --cifar-oracle-only
    python -m tpu_dist_torch.benchmarks.accuracy_run --torch-parity-only
    python -m tpu_dist_torch.benchmarks.accuracy_run --quant-gate-only \\
        --device cpu --quant-gate-steps 20
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from ._card import device_stamp

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ROWS_FILE = os.path.join(_REPO, "ACCURACY_TORCH.json")
DATA = "synthetic (deterministic stand-in, data/datasets.py)"
LABEL_NOISE = 0.25


def _open_group(device: str):
    """The default group and whether this call brought it up: the world of
    ``MASTER_ADDR``/``RANK``/``WORLD_SIZE`` when they are set, else this
    process alone, on ``device``'s kind."""
    from .. import dist
    if dist.is_initialized():
        return dist.get_default_group(), False
    init = "env://" if "MASTER_ADDR" in os.environ else None
    return dist.init_process_group(
        init_method=init, device=None if device == "cuda" else device), True


def _close_group(own: bool) -> None:
    if own:
        from .. import dist
        dist.destroy_process_group()


def _cifar_transforms():
    from ..data import transforms
    aug = transforms.Compose([
        transforms.RandomCrop(32, padding=4),
        transforms.RandomHorizontalFlip(),
        transforms.Normalize(transforms.CIFAR10_MEAN, transforms.CIFAR10_STD),
    ])
    return aug, transforms.Normalize(transforms.CIFAR10_MEAN,
                                     transforms.CIFAR10_STD)


def build_mnist(group, lr: float = 1e-4, momentum: float = 0.0,
                batch_per_replica: int = 100):
    """The ConvNet recipe's ``(ddp, loader, test_loader)``: batch
    ``batch_per_replica`` a rank from ``DistributedSampler(shuffle=False)``
    and the test set in global batches, each rank scoring its slice."""
    from .. import nn, optim
    from ..data import (MNIST, DataLoader, DeviceLoader, DistributedSampler,
                        transforms)
    from ..models import ConvNet
    from ..parallel import DistributedDataParallel

    world, rank = group.size(), group.rank
    norm = transforms.Normalize(transforms.MNIST_MEAN, transforms.MNIST_STD)
    train_ds = MNIST(root="./data", train=True, transform=norm,
                     synthetic_fallback=True)
    test_ds = MNIST(root="./data", train=False, transform=norm,
                    synthetic_fallback=True)
    ddp = DistributedDataParallel(
        ConvNet(device=group.device),
        optimizer=optim.SGD(lr=lr, momentum=momentum),
        loss_fn=nn.CrossEntropyLoss(), group=group)
    sampler = DistributedSampler(train_ds, num_replicas=world, rank=rank,
                                 shuffle=False)
    loader = DeviceLoader(
        DataLoader(train_ds, batch_size=batch_per_replica, sampler=sampler,
                   drop_last=True, num_workers=2), group=group)
    test_loader = DeviceLoader(
        DataLoader(test_ds, batch_size=batch_per_replica * world,
                   drop_last=False, num_workers=2),
        group=group, local_shards=False)
    return ddp, loader, test_loader


def build_cifar(group, global_batch: int = 256):
    """The ResNet-18 bf16 recipe's ``(ddp, loader, test_loader)``:
    ``global_batch // world`` a rank from ``DistributedSampler(shuffle=True,
    seed=0)``, augmented on the host."""
    import torch

    from .. import nn, optim
    from ..data import CIFAR10, DataLoader, DeviceLoader, DistributedSampler
    from ..models import resnet18
    from ..parallel import DistributedDataParallel

    world, rank = group.size(), group.rank
    aug, norm = _cifar_transforms()
    train_ds = CIFAR10(root="./data", train=True, transform=aug,
                       synthetic_fallback=True)
    test_ds = CIFAR10(root="./data", train=False, transform=norm,
                      synthetic_fallback=True)
    ddp = DistributedDataParallel(
        resnet18(num_classes=10, device=group.device),
        optimizer=optim.SGD(lr=0.02, momentum=0.9, weight_decay=1e-4,
                            nesterov=True),
        loss_fn=nn.CrossEntropyLoss(), group=group,
        compute_dtype=torch.bfloat16)
    sampler = DistributedSampler(train_ds, num_replicas=world, rank=rank,
                                 shuffle=True, seed=0)
    loader = DeviceLoader(
        DataLoader(train_ds, batch_size=global_batch // world,
                   sampler=sampler, drop_last=True, num_workers=2),
        group=group)
    test_loader = DeviceLoader(
        DataLoader(test_ds, batch_size=global_batch, drop_last=False,
                   num_workers=2), group=group, local_shards=False)
    return ddp, loader, test_loader


def build_noisy_oracle(group, n_train: int = 20000, n_test: int = 10000,
                       label_noise: float = LABEL_NOISE,
                       batch_per_replica: int = 100):
    """The MNIST oracle's ``(ddp, loader, test_loader)``: the ConvNet at SGD
    0.01, momentum 0.9 on the noisy-label arrays; each step takes one global
    batch of ``batch_per_replica`` x world rows of a seeded shuffle, a
    rank its slice (the JAX package's global batch over its devices)."""
    from .. import nn, optim
    from ..data import (ArrayImageDataset, DataLoader, DeviceLoader,
                        synthetic_mnist_noisy_arrays, transforms)
    from ..models import ConvNet
    from ..parallel import DistributedDataParallel

    world = group.size()
    norm = transforms.Normalize(transforms.MNIST_MEAN, transforms.MNIST_STD)
    xtr, ytr = synthetic_mnist_noisy_arrays(True, n_train,
                                            label_noise=label_noise)
    xte, yte = synthetic_mnist_noisy_arrays(False, n_test,
                                            label_noise=label_noise)
    ddp = DistributedDataParallel(
        ConvNet(device=group.device), optimizer=optim.SGD(lr=0.01,
                                                          momentum=0.9),
        loss_fn=nn.CrossEntropyLoss(), group=group)
    loader = DeviceLoader(
        DataLoader(ArrayImageDataset(xtr, ytr, transform=norm),
                   batch_size=batch_per_replica * world, drop_last=True,
                   shuffle=True, seed=0), group=group, local_shards=False)
    test_loader = DeviceLoader(
        DataLoader(ArrayImageDataset(xte, yte, transform=norm),
                   batch_size=1000 * world, drop_last=False),
        group=group, local_shards=False)
    return ddp, loader, test_loader


def build_cifar_noisy_oracle(group, n_train: int = 20000,
                             n_test: int = 10000,
                             label_noise: float = LABEL_NOISE,
                             global_batch: int = 256):
    """The CIFAR oracle's ``(ddp, loader, test_loader)``: the ResNet-18 bf16
    recipe on the noisy-label arrays, one global batch of ``global_batch``
    rows of a seeded shuffle a step, a rank its slice."""
    import torch

    from .. import nn, optim
    from ..data import (ArrayImageDataset, DataLoader, DeviceLoader,
                        synthetic_cifar10_noisy_arrays)
    from ..models import resnet18
    from ..parallel import DistributedDataParallel

    aug, norm = _cifar_transforms()
    xtr, ytr = synthetic_cifar10_noisy_arrays(True, n_train,
                                              label_noise=label_noise)
    xte, yte = synthetic_cifar10_noisy_arrays(False, n_test,
                                              label_noise=label_noise)
    ddp = DistributedDataParallel(
        resnet18(num_classes=10, device=group.device),
        optimizer=optim.SGD(lr=0.02, momentum=0.9, weight_decay=1e-4,
                            nesterov=True),
        loss_fn=nn.CrossEntropyLoss(), group=group,
        compute_dtype=torch.bfloat16)
    loader = DeviceLoader(
        DataLoader(ArrayImageDataset(xtr, ytr, transform=aug),
                   batch_size=global_batch, drop_last=True, shuffle=True,
                   seed=0, num_workers=2), group=group, local_shards=False)
    test_loader = DeviceLoader(
        DataLoader(ArrayImageDataset(xte, yte, transform=norm),
                   batch_size=global_batch, drop_last=False, num_workers=2),
        group=group, local_shards=False)
    return ddp, loader, test_loader


def epoch_pass(ddp, state, loader, log_every: int = 0, tag: str = ""):
    """One epoch of training steps: ``(state, mean loss, steps)``.  The
    losses are summed on the device and read once, unless ``log_every``
    prints one every that many steps."""
    total, steps = None, 0
    for i, (images, labels) in enumerate(loader):
        state, metrics = ddp.train_step(state, images, labels)
        loss = metrics["loss"].double()
        total = loss if total is None else total + loss
        steps += 1
        if log_every and (i + 1) % log_every == 0:
            print(f"  {tag} step {i + 1}: loss {float(metrics['loss']):.4f}",
                  flush=True)
    return state, (float(total) / steps if steps else 0.0), steps


def train_epochs(ddp, loader, test_loader, epochs: int, tag: str,
                 log_every: int = 0) -> dict:
    """The loop every recipe shares: ``ddp.init(seed=0)``, then a
    ``set_epoch``, an :func:`epoch_pass` and an ``evaluate`` an epoch.
    Returns the trained state, each epoch's mean training loss and test
    result, the steps of an epoch and the wall seconds."""
    state = ddp.init(seed=0)
    t0 = time.perf_counter()
    losses, tests, steps, res = [], [], 0, None
    for ep in range(epochs):
        loader.set_epoch(ep)
        state, mean_loss, steps = epoch_pass(ddp, state, loader, log_every,
                                             f"{tag} ep{ep + 1}")
        res = ddp.evaluate(state, test_loader)
        losses.append(mean_loss)
        tests.append(res)
        print(f"{tag} epoch {ep + 1}/{epochs}: train loss {mean_loss:.4f}, "
              f"test acc {res['accuracy']:.4f}", flush=True)
    return {"state": state, "losses": losses, "tests": tests,
            "steps": steps, "wall": time.perf_counter() - t0}


def _recipe_row(recipe: str, run: dict, world: int, epochs: int,
                device) -> dict:
    final = run["tests"][-1]
    return {
        "recipe": recipe,
        "data": DATA,
        "device_replicas": world,
        "epochs": epochs,
        "steps_per_epoch": run["steps"],
        "train_loss_per_epoch": [round(v, 4) for v in run["losses"]],
        "test_per_epoch": [{"loss": round(t["loss"], 4),
                            "accuracy": round(t["accuracy"], 4)}
                           for t in run["tests"]],
        "final_test_accuracy": round(final["accuracy"], 4),
        "final_test_loss": round(final["loss"], 4),
        "test_samples": final["count"],
        "wall_clock_sec": run["wall"],
        **device_stamp(device),
    }


def run_mnist(epochs: int = 2, batch_per_replica: int = 100,
              lr: float = 1e-4, momentum: float = 0.0,
              device: str = "cuda") -> dict:
    """The reference's ``mpspawn_dist`` recipe (SGD 1e-4, batch 100, seed
    0), whose tiny rate makes the loss fall slowly; ``lr``/``momentum``
    give the tuned row, which converges on the same pipeline."""
    pg, own = _open_group(device)
    try:
        ddp, loader, test_loader = build_mnist(pg, lr, momentum,
                                               batch_per_replica)
        run = train_epochs(ddp, loader, test_loader, epochs, "mnist",
                           log_every=100)
        return _recipe_row(
            f"mnist_convnet_sgd{lr:g}_m{momentum:g}_batch100_seed0 "
            "(examples/mpspawn_dist.py)", run, pg.size(), epochs, pg.device)
    finally:
        _close_group(own)


def run_cifar(epochs: int = 5, global_batch: int = 256,
              device: str = "cuda") -> dict:
    """The reference's ``example_mp`` recipe (ResNet-18, SGD
    .02/.9/1e-4/nesterov, augmentation, a reshuffle an epoch) with bf16
    compute."""
    pg, own = _open_group(device)
    try:
        ddp, loader, test_loader = build_cifar(pg, global_batch)
        run = train_epochs(ddp, loader, test_loader, epochs, "cifar",
                           log_every=50)
        return _recipe_row("cifar10_resnet18_bf16_sgd.02_batch256_aug "
                           "(examples/example_mp.py --bf16)", run, pg.size(),
                           epochs, pg.device)
    finally:
        _close_group(own)


# the reference tutorial's ConvNet, verbatim (pad-1 5x5 conv, a stride-1
# second max-pool, a dropout never called), for the torch-parity row
def _torch_ref_convnet():
    import torch.nn as tnn

    class TorchRefConvNet(tnn.Module):
        def __init__(self):
            super().__init__()
            self.relu = tnn.ReLU()
            self.conv1 = tnn.Conv2d(1, 32, kernel_size=5, stride=1,
                                    padding=1)
            self.maxpool1 = tnn.MaxPool2d(kernel_size=2, stride=2)
            self.conv2 = tnn.Conv2d(32, 64, kernel_size=3, stride=1)
            self.maxpool2 = tnn.MaxPool2d(kernel_size=2, stride=1)
            self.conv3 = tnn.Conv2d(64, 128, kernel_size=3, stride=1)
            self.maxpool3 = tnn.MaxPool2d(kernel_size=2, stride=2)
            self.dropout = tnn.Dropout(p=0.5)   # defined, never called
            self.fc1 = tnn.Linear(128 * 4 * 4, 10)

        def forward(self, x):
            x = self.maxpool1(self.relu(self.conv1(x)))
            x = self.maxpool2(self.relu(self.conv2(x)))
            x = self.maxpool3(self.relu(self.conv3(x)))
            return self.fc1(x.flatten(1))

    return TorchRefConvNet()


def make_parity_data(n: int, seed: int = 0):
    """The torch-parity row's MNIST-shaped set, NHWC float32 and int64
    labels: ten brightened patches, one a class, over N(0, 0.5) noise —
    learnable, but not in one step (the reference test's ``make_data``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 10, n).astype(np.int64)
    xs = rng.normal(0, 0.5, (n, 28, 28, 1)).astype(np.float32)
    for c in range(10):
        r0, c0 = (c // 5) * 9 + 2, (c % 5) * 5 + 1
        xs[ys == c, r0:r0 + 6, c0:c0 + 4, 0] += 1.0
    return xs, ys


def parity_curves(lr: float = 0.05, steps: int = 200, batch: int = 100,
                  device: str = "cuda"):
    """Train the literal torch ConvNet (``torch.optim.SGD``) and the port's
    (its ``optim.SGD`` and loss) from the same initial weights on the same
    batches; ``(torch curve, port curve, torch eval accuracy, port eval
    accuracy)``, the accuracies on 1,000 held-out images.  On a card TF32
    is off for the run."""
    import numpy as np
    import torch

    from .. import nn, optim
    from ..models import ConvNet

    dev = torch.device(device)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        xs, ys = make_parity_data((steps + 10) * batch)
        xs = torch.from_numpy(np.ascontiguousarray(
            xs.transpose(0, 3, 1, 2))).to(dev)
        ys = torch.from_numpy(ys).to(dev)
        torch.manual_seed(0)
        ref = _torch_ref_convnet().to(dev)
        ours = ConvNet(device=dev)
        # the two torch modules share names and layouts, fc1 included
        ours.load_state_dict(ref.state_dict())
        ref_opt = torch.optim.SGD(ref.parameters(), lr)
        ref_loss = torch.nn.CrossEntropyLoss()
        loss_fn = nn.CrossEntropyLoss()
        opt = optim.SGD(lr=lr)
        params = {k: p.detach().clone() for k, p in ours.named_parameters()}
        ostate = opt.init(params)

        def port_step(params, ostate, xb, yb):
            ps = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
            loss = loss_fn(torch.func.functional_call(ours, ps, (xb,)), yb)
            grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
            params, ostate = opt.update(grads, ostate, params)
            return params, ostate, loss.detach()

        tcurve, pcurve = [], []
        for i in range(steps):
            rows = slice(i * batch, (i + 1) * batch)
            xb, yb = xs[rows], ys[rows]
            ref_opt.zero_grad()
            tl = ref_loss(ref(xb), yb)
            tl.backward()
            ref_opt.step()
            tcurve.append(tl.detach())
            params, ostate, pl = port_step(params, ostate, xb, yb)
            pcurve.append(pl)
        xe, ye = xs[steps * batch:], ys[steps * batch:]
        with torch.no_grad():
            ta = float((ref(xe).argmax(1) == ye).float().mean())
            pa = float((torch.func.functional_call(ours, params, (xe,))
                        .argmax(1) == ye).float().mean())
        return (torch.stack(tcurve).double().cpu().numpy(),
                torch.stack(pcurve).double().cpu().numpy(), ta, pa)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def run_torch_parity(steps: int = 200, lr: float = 0.05,
                     device: str = "cuda") -> dict:
    """The direct oracle: the literal torch ConvNet and the port's trained
    on identical batches from identical weights; the paired loss curves
    and final accuracies (the JAX row's keys: ``tpu_dist`` is the port
    here)."""
    import numpy as np
    batch = 100
    t, p, ta, pa = parity_curves(lr, steps, batch, device)
    d = np.abs(t - p)
    stride = max(1, steps // 20)
    return {
        "recipe": f"torch ConvNet vs tpu_dist_torch ConvNet, identical init "
                  f"(state dict) + batches, SGD lr={lr:g} batch {batch}, "
                  f"{steps} steps, float32 (TF32 off)",
        "oracle": "tests/test_torch_accuracy.py (asserted there; recorded "
                  "here)",
        "max_step_loss_delta": float(d.max()),
        "mean_step_loss_delta": float(d.mean()),
        "final_loss_torch": float(t[-1]),
        "final_loss_tpu_dist": float(p[-1]),
        "final_eval_accuracy_torch": ta,
        "final_eval_accuracy_tpu_dist": pa,
        "curve_torch_every%d" % stride: [round(v, 5) for v in t[::stride]],
        "curve_tpu_dist_every%d" % stride: [round(v, 5) for v in p[::stride]],
        **device_stamp(device),
    }


def oracle_band(n_test: int, label_noise: float = LABEL_NOISE) -> tuple:
    """``(ceiling, 3 binomial SE)`` of the oracle's test accuracy."""
    ceiling = (1.0 - label_noise) + label_noise / 10.0
    return ceiling, 3.0 * (ceiling * (1.0 - ceiling) / n_test) ** 0.5


def _oracle_row(recipe: str, oracle: str, run: dict, label_noise: float,
                device) -> dict:
    accs = [round(t["accuracy"], 4) for t in run["tests"]]
    n_test = run["tests"][-1]["count"]
    ceiling, se3 = oracle_band(n_test, label_noise)
    final = run["tests"][-1]["accuracy"]
    return {
        "recipe": recipe,
        "oracle": oracle,
        "label_noise": label_noise,
        "analytic_ceiling": round(ceiling, 4),
        "expected_band": [round(ceiling - se3, 4), round(ceiling + se3, 4)],
        "test_accuracy_per_epoch": accs,
        "final_test_accuracy": accs[-1],
        "test_samples": n_test,
        "in_band": bool(ceiling - se3 <= final <= ceiling + se3),
        "wall_clock_sec": run["wall"],
        **device_stamp(device),
    }


def run_noisy_oracle(epochs: int = 4, n_train: int = 20000,
                     label_noise: float = LABEL_NOISE, n_test: int = 10000,
                     batch_per_replica: int = 100,
                     device: str = "cuda") -> dict:
    """The low-SNR oracle over the ConvNet pipeline: the final accuracy
    against the exact ceiling ``(1 - rho) + rho/10``.  Two-sided: a correct
    pipeline lands within ±3 binomial SEs of it, a subtly broken one
    undershoots, and nothing overshoots (the flips do not depend on the
    images)."""
    pg, own = _open_group(device)
    try:
        ddp, loader, test_loader = build_noisy_oracle(
            pg, n_train, n_test, label_noise, batch_per_replica)
        run = train_epochs(ddp, loader, test_loader, epochs, "noisy-oracle")
        return _oracle_row(
            f"mnist_convnet_sgd0.01_m0.9_batch100 on "
            f"synthetic_mnist_noisy_arrays(label_noise={label_noise})",
            "tests/test_torch_accuracy.py (asserted there)", run,
            label_noise, pg.device)
    finally:
        _close_group(own)


def run_cifar_noisy_oracle(epochs: int = 8, n_train: int = 20000,
                           label_noise: float = LABEL_NOISE,
                           n_test: int = 10000,
                           device: str = "cuda") -> dict:
    """The CIFAR-shaped low-SNR oracle: the ``example_mp`` recipe
    (ResNet-18, crop + flip + normalize, SGD .02/.9/1e-4/nesterov, global
    batch 256, a reshuffle an epoch, bf16 compute) on the noisy-label
    CIFAR arrays, in the same analytic band; the clean synthetic set
    saturates through this recipe and tells nothing apart."""
    pg, own = _open_group(device)
    try:
        ddp, loader, test_loader = build_cifar_noisy_oracle(
            pg, n_train, n_test, label_noise)
        run = train_epochs(ddp, loader, test_loader, epochs, "cifar-oracle")
        return _oracle_row(
            "cifar10_resnet18_bf16_sgd.02_batch256_aug "
            "(examples/example_mp.py recipe) on "
            f"synthetic_cifar10_noisy_arrays(label_noise={label_noise})",
            "tests/test_torch_accuracy.py (recorded-row band assert)", run,
            label_noise, pg.device)
    finally:
        _close_group(own)


def _quant_gate_worker() -> int:
    import numpy as np
    import torch

    from .. import optim
    from ..collectives import transport as T
    from ..collectives.bucketer import Bucketer
    from ..collectives.quant import ErrorFeedback
    from ..data import transforms
    from ..nn import functional as F
    from ..nn.module import reset_parameters
    from .bench_host_collectives import _Group, attach_store

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    spec = json.loads(os.environ["GATE_SPEC"])
    store = attach_store(os.environ["TPU_DIST_STORE_ADDR"])
    g = _Group(rank, world)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if spec["model"] == "resnet":
        from ..data import synthetic_cifar10_noisy_arrays as gen
        from ..models import resnet18
        model = resnet18(num_classes=10, device=dev)
        mean, std = transforms.CIFAR10_MEAN, transforms.CIFAR10_STD
    else:
        from ..data import synthetic_mnist_noisy_arrays as gen
        from ..models import ConvNet
        model = ConvNet(device=dev)
        mean, std = transforms.MNIST_MEAN, transforms.MNIST_STD
    reset_parameters(model, torch.Generator(device=dev).manual_seed(0))
    norm = transforms.Normalize(mean, std)

    def prep(x):
        # NHWC uint8 -> normalized NCHW float32 on the device
        x = norm(x.astype(np.float32) / 255.0).transpose(0, 3, 1, 2)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    xtr, ytr = gen(True, spec["n_train"])
    xte, yte = gen(False, spec["n_test"])
    xtr, ytr = xtr[rank::world], ytr[rank::world]   # rank-sharded stream
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    buffers = dict(model.named_buffers())

    def grads_of(xb, yb):
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = torch.func.functional_call(model, {**ps, **buffers}, (xb,))
        loss = F.cross_entropy(logits, yb)
        return dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))

    opt = optim.SGD(lr=spec["lr"], momentum=0.9)
    ostate = opt.init(params)
    bucketer = Bucketer()
    ef = ErrorFeedback()
    bs = spec["batch"]
    n = len(ytr)
    model.train()
    for step in range(spec["steps"]):
        lo = (step * bs) % max(n - bs, 1)
        grads = grads_of(prep(xtr[lo:lo + bs]),
                         torch.from_numpy(ytr[lo:lo + bs]).to(dev))
        grads = bucketer.all_reduce(grads, op="avg", group=g,
                                    error_feedback=ef).wait_all(300)
        params, ostate = opt.update(grads, ostate, params)

    model.eval()
    correct = 0
    with torch.no_grad():
        for lo in range(0, len(yte), 512):
            logits = torch.func.functional_call(
                model, {**params, **buffers}, (prep(xte[lo:lo + 512]),))
            correct += int((logits.argmax(-1).cpu().numpy()
                            == yte[lo:lo + 512]).sum())
    acc = correct / len(yte)
    if rank == 0:
        with open(os.environ["GATE_OUT"], "w") as f:
            json.dump({"accuracy": acc, "ef_norm": ef.norm()}, f)
    store.barrier(world, tag="gate-exit")
    T.close_data_plane()
    store.close()
    return 0


def _run_quant_gate_config(comm, spec, world: int = 2) -> dict:
    """One world of gate workers under the given wire."""
    from ..dist.store import TCPStore
    store = TCPStore(is_master=True)
    with tempfile.NamedTemporaryFile(mode="w", suffix=".json",
                                     delete=False) as tmp:
        out_path = tmp.name
    procs = []
    try:
        env = dict(os.environ,
                   TPU_DIST_STORE_ADDR=f"127.0.0.1:{store.port}",
                   WORLD_SIZE=str(world),
                   PYTHONPATH=_REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""),
                   GATE_OUT=out_path, GATE_SPEC=json.dumps(spec))
        for k in ("TPU_DIST_RESTART_COUNT", "TPU_DIST_HOST_TRANSPORT",
                  "TPU_DIST_COMM_DTYPE"):
            env.pop(k, None)
        if comm:
            env["TPU_DIST_COMM_DTYPE"] = comm
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.benchmarks.accuracy_run",
             "--quant-gate-worker"], env=dict(env, RANK=str(r)), cwd=_REPO)
            for r in range(world)]
        deadline = time.monotonic() + 1800
        rcs = [p.wait(timeout=max(1, deadline - time.monotonic()))
               for p in procs]
        if any(rcs):
            raise RuntimeError(f"quant gate workers failed: rcs={rcs}")
        with open(out_path) as f:
            return json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.close()
        os.unlink(out_path)


def run_quant_ef_gate(model: str = "convnet", steps: int = 150,
                      batch: int = 128, n_train: int = 20000,
                      n_test: int = 4000, lr: float = 0.02,
                      scheme: str = "int8_block256",
                      device: str = "cuda") -> dict:
    """The gate: the float32 wire against ``scheme`` with error feedback,
    the delta banded at ±3 binomial standard errors (the JAX row's keys,
    with the device).  The two worlds run at once: each has its own store
    and processes, and its accuracy does not depend on the other's
    timing."""
    from concurrent.futures import ThreadPoolExecutor

    spec = {"model": model, "steps": steps, "batch": batch,
            "n_train": n_train, "n_test": n_test, "lr": lr,
            "device": device}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        runs = [pool.submit(_run_quant_gate_config, comm, spec)
                for comm in (None, scheme)]
        base, quant = (f.result() for f in runs)
    p = max(min(base["accuracy"], 1 - 1e-6), 1e-6)
    se3 = 3.0 * (p * (1 - p) / n_test) ** 0.5
    delta = quant["accuracy"] - base["accuracy"]
    return {
        "recipe": f"{model}_low_snr_host_grad_sync sgd{lr} batch{batch} "
                  f"steps{steps} world2",
        "data": "synthetic_noisy(label_noise=0.25)",
        "scheme": scheme,
        "f32_accuracy": base["accuracy"],
        "quant_ef_accuracy": quant["accuracy"],
        "delta": delta,
        "noise_band_3se": se3,
        "within_noise": bool(abs(delta) <= se3),
        "ef_residual_norm": quant["ef_norm"],
        "wall_clock_sec": time.perf_counter() - t0,
        "device": device,
    }


def merge_write(rows: dict, out: str = ROWS_FILE) -> str:
    """Merge ``rows`` into ``out``, reading the file when it is written, so
    rows that other modes recorded while this one trained survive."""
    results = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    results.update(rows)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return out


def _write(rows: dict, out: str) -> None:
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"merged {sorted(rows)} into {merge_write(rows, out)}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="1 epoch each (a smoke run: it does not overwrite "
                         "an existing file)")
    ap.add_argument("--mnist-epochs", type=int, default=2)
    ap.add_argument("--cifar-epochs", type=int, default=5)
    ap.add_argument("--torch-parity-only", action="store_true",
                    help="only the torch-against-port curve comparison")
    ap.add_argument("--noisy-oracle-only", action="store_true",
                    help="only the MNIST low-SNR oracle")
    ap.add_argument("--cifar-oracle-only", action="store_true",
                    help="only the CIFAR ResNet/BN/augmentation low-SNR "
                         "oracle")
    ap.add_argument("--quant-gate-only", action="store_true",
                    help="only the quantized-wire error-feedback accuracy "
                         "gate (f32 against int8_block256 + EF)")
    ap.add_argument("--quant-gate-model", default="convnet",
                    choices=("convnet", "resnet"))
    ap.add_argument("--quant-gate-steps", type=int, default=150)
    ap.add_argument("--quant-gate-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=ROWS_FILE,
                    help="the JSON file the rows merge into")
    args = ap.parse_args(argv)
    if args.quant_gate_worker:
        return _quant_gate_worker()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("accuracy_run: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    dev = args.device
    if args.quant_gate_only:
        # the gate's row is printed, not merged
        print(json.dumps(run_quant_ef_gate(model=args.quant_gate_model,
                                           steps=args.quant_gate_steps,
                                           device=dev)))
        return 0
    only = {"torch_e2e_curve_parity": (args.torch_parity_only,
                                       run_torch_parity),
            "mnist_low_snr_oracle": (args.noisy_oracle_only,
                                     run_noisy_oracle),
            "cifar_resnet_low_snr_oracle": (args.cifar_oracle_only,
                                            run_cifar_noisy_oracle)}
    for key, (chosen, fn) in only.items():
        if chosen:
            row = fn(device=dev)
            print(json.dumps(row))
            _write({key: row}, args.out)
            return 0
    if args.quick:
        args.mnist_epochs = args.cifar_epochs = 1
    stamp = device_stamp(dev)
    rows = {"platform": "gpu" if dev == "cuda" else "cpu",
            "device": stamp["device"], "nvidia_smi": stamp["nvidia_smi"],
            # the reference's rate: a slow, steady fall of the loss
            "mnist_convnet_ref_recipe": run_mnist(epochs=args.mnist_epochs,
                                                  device=dev),
            # the same model and pipeline at a rate that converges
            "mnist_convnet_tuned": run_mnist(
                epochs=max(1, args.mnist_epochs // 2), lr=0.01,
                momentum=0.9, device=dev),
            "cifar10_resnet18_bf16": run_cifar(epochs=args.cifar_epochs,
                                               device=dev)}
    if args.quick and os.path.exists(args.out):
        print("quick mode: not merging into the existing file")
        print(json.dumps(rows, indent=1))
        return 0
    _write(rows, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
