"""The quantized wire's error-feedback accuracy gate — the port's twin of
the ``--quant-gate-only`` mode of ``benchmarks/accuracy_run.py``.

The same recipe trains twice at world 2 over the host collective path,
gradients averaged by :class:`~tpu_dist_torch.collectives.Bucketer` on the
host ring: once on the float32 wire, once on ``int8_block256`` with an
:class:`~tpu_dist_torch.collectives.quant.ErrorFeedback` residual.  Both
runs follow one deterministic schedule (seeded initialization, the
rank-sharded stream in a fixed order), so the accuracy delta isolates the
wire; it must lie within ±3 binomial standard errors of the float32 run's
held-out accuracy on the low-SNR noisy-label data
(``synthetic_mnist_noisy_arrays`` / ``synthetic_cifar10_noisy_arrays``,
label noise 0.25).  The JAX spec: 150 steps, batch 128, SGD lr 0.02 with
momentum 0.9, 20,000 training and 4,000 test images.

Workers reach each other only through the control-plane store and the
host data plane, through a rank shim — no NCCL communicator — so both
ranks can share one card.  The model runs on ``--device`` (``cuda`` by
default); the gradients cross through pinned host memory.  Prints the row
as JSON and writes no file in the repo.  The other modes of the JAX
script (the tutorial recipes to accuracy, the oracles) are ROADMAP A9.8.

    python -m tpu_dist_torch.benchmarks.accuracy_run --quant-gate-only
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

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quant-gate-only", action="store_true",
                    help="the quantized-wire error-feedback accuracy gate "
                         "(f32 against int8_block256 + EF)")
    ap.add_argument("--quant-gate-model", default="convnet",
                    choices=("convnet", "resnet"))
    ap.add_argument("--quant-gate-steps", type=int, default=150)
    ap.add_argument("--quant-gate-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--quick", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--torch-parity-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--noisy-oracle-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--cifar-oracle-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.quant_gate_worker:
        return _quant_gate_worker()
    if not args.quant_gate_only:
        print("accuracy_run: only --quant-gate-only is in tpu_dist_torch; "
              "the recipes to accuracy and the oracles are ROADMAP A9.8",
              file=sys.stderr)
        return 2
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("accuracy_run: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    row = run_quant_ef_gate(model=args.quant_gate_model,
                            steps=args.quant_gate_steps, device=args.device)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
