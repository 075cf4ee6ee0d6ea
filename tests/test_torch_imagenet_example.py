"""The ``example_imagenet`` twin on the CPU, at a small size: ResNet-50 at
image 32 (``--synthetic-size 64``, batch 8, ``--max-steps 2``,
``--evaluate``) with the augmentation on the device and on the host, at
world 1 in process and at world 2 as two gloo ranks; and ``--imagefolder``
on a ``.npy`` tree (at image 64, batch 4).  Each run must train its steps
with finite losses and evaluate every image of its held-out set exactly
once."""

import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_dist_torch.examples import example_imagenet

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--image-size", "32", "--synthetic-size", "64",
         "--batch-size", "8", "--max-steps", "2", "--evaluate",
         "--num-workers", "2"]


@pytest.mark.parametrize("host_augment", [False, True],
                         ids=["device_augment", "host_augment"])
def test_twin_trains_and_evaluates_at_world1(host_augment):
    argv = SMALL + (["--host-augment"] if host_augment else [])
    r = example_imagenet.train(example_imagenet.parse_args(argv))
    losses = [float(v) for v in r["losses"]]
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    # the held-out set: max(64 // 4, 64) images, each scored once
    assert r["eval"]["count"] == 64
    assert math.isfinite(r["eval"]["loss"])
    assert len(r["state"].model_state) == 53  # ResNet-50's BatchNorms


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_twin_runs_two_gloo_ranks():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpu_dist_torch.examples.example_imagenet",
             *SMALL], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    assert "[init] == process rank 0, 2 device replicas ==" in outs[0]
    assert "[init] == process rank 1, 2 device replicas ==" in outs[1]
    assert "Training complete in:" in outs[0]
    assert outs[0].count("(64 samples)") == 1 and "Eval" not in outs[1]


def test_twin_reads_an_image_folder_of_npy(tmp_path):
    rng = np.random.default_rng(0)
    for c in range(3):
        (tmp_path / f"class{c}").mkdir()
        for i in range(4):
            np.save(tmp_path / f"class{c}" / f"{i}.npy",
                    rng.integers(0, 256, (40 + i, 36, 3), np.uint8))
    # image 64: at 32 layer4's maps are 1x1, and over the 4-6 values a
    # channel of so small a batch a bf16 E[x^2] - E[x]^2 can round below
    # -eps, which the formula turns into NaN (ROADMAP C7)
    r = example_imagenet.train(example_imagenet.parse_args(
        ["--device", "cpu", "--image-size", "64", "--batch-size", "4",
         "--max-steps", "2", "--evaluate", "--num-workers", "2",
         "--imagefolder", str(tmp_path)]))
    assert len(r["losses"]) == 2
    assert all(math.isfinite(float(v)) for v in r["losses"])
    assert r["eval"]["count"] == 12
    assert r["ddp"].module.fc.out_features == 3  # one class a directory
