"""MNIST ConvNet under the launch CLI — the port's twin of
``examples/launch_dist.py`` (the reference tutorial's launcher-driven
script).

It takes the launcher's env contract (``RANK``/``LOCAL_RANK``/
``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, through
``init_method='env://'``) and the classic ``--local_rank`` argv, with the
JAX example's flags and hyperparameters (batch 100 per rank, SGD lr 1e-4,
seed 0, 10 epochs, a line every 100 steps), except that ``--device
cuda|cpu`` (default ``cuda``) takes the place of ``--backend``.  The
sampler shards by the GLOBAL rank (the reference's ``rank=local_rank`` bug
stays fixed, as in the JAX example)::

    python -m tpu_dist_torch.launch --nproc_per_node=1 --nnodes=2 \\
        --node_rank=0 --master_addr=HOST --master_port=22222 \\
        -m tpu_dist_torch.examples.launch_dist
    python -m tpu_dist_torch.launch --standalone --nproc_per_node=2 \\
        -m tpu_dist_torch.examples.launch_dist --device cpu --synthetic \\
        --max-steps 3

The training loop is the ``mpspawn_dist`` twin's (:func:`train` there), run
in the world the launcher made.
"""

from __future__ import annotations

import argparse

__all__ = ["parse_args", "train", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", default=10, type=int)  # ref: 10
    parser.add_argument("--batch-size", default=100, type=int)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--local_rank", default=None, type=int,
                        help="accepted for the classic launcher argv "
                             "contract (--pass_local_rank); env LOCAL_RANK "
                             "is authoritative")
    parser.add_argument("--max-steps", default=0, type=int)
    parser.add_argument("--evaluate", action="store_true",
                        help="run test-set evaluation after training")
    args = parser.parse_args(argv)
    args.lr, args.ref_logs = 1e-4, False   # the reference's SGD
    return args


def train(args) -> dict:
    """Train (and with ``--evaluate`` evaluate) in the launcher's world;
    returns the ``mpspawn_dist`` twin's ``{"state", "ddp", "losses",
    "eval"}``."""
    from .mpspawn_dist import train as _train
    return _train(args)


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
