"""CIFAR-10 ResNet-18 under the launch CLI — the port's twin of
``examples/example_launch.py`` (the reference tutorial's launcher-driven
CIFAR script).

The ``example_mp`` twin's workload at the JAX example's settings: batch 128
per rank, 5 epochs, SGD lr 0.02 with momentum 0.9, weight decay 1e-4 and
nesterov, RandomCrop + flip, ``--sync-bn`` for cross-replica BatchNorm,
with the launcher's env contract (``init_method='env://'``) and the
classic ``--local_rank`` argv; ``--device cuda|cpu`` takes the place of
``--backend``::

    python -m tpu_dist_torch.launch --nproc_per_node=1 --nnodes=2 \\
        --node_rank=0 --master_addr=HOST --master_port=22222 \\
        -m tpu_dist_torch.examples.example_launch --sync-bn
"""

from __future__ import annotations

import argparse

__all__ = ["parse_args", "train", "main", "BATCH_SIZE", "EPOCHS"]

BATCH_SIZE = 128
EPOCHS = 5


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=EPOCHS, type=int)
    parser.add_argument("--batch-size", default=BATCH_SIZE, type=int)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--local_rank", default=None, type=int,
                        help="accepted for the classic launcher argv "
                             "contract (--pass_local_rank); env LOCAL_RANK "
                             "is authoritative")
    parser.add_argument("--sync-bn", action="store_true")
    parser.add_argument("--max-steps", default=0, type=int)
    parser.add_argument("--evaluate", action="store_true",
                        help="run test-set evaluation after training")
    args = parser.parse_args(argv)
    # the example_mp twin's remaining options, at what the JAX example does
    args.dist_url, args.nodes, args.node_rank = None, 1, 0
    args.bf16, args.checkpoint_dir, args.resume = False, None, False
    args.checkpoint_every = 100
    return args


def train(args) -> dict:
    """Train (and with ``--evaluate`` evaluate) in the launcher's world;
    returns the ``example_mp`` twin's ``{"state", "ddp", "losses",
    "eval"}``."""
    from .example_mp import train as _train
    return _train(args)


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
