"""``python -m tpu_dist_torch.run`` — torchrun-style alias of the launch
CLI: ``python -m tpu_dist_torch.launch ...`` and ``python -m
tpu_dist_torch.run ...`` are the same command (tpu_dist_torch/launch/cli.py).
"""

import sys

from .launch.cli import main

if __name__ == "__main__":
    sys.exit(main())
