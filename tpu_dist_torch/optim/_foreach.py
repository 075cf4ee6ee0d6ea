"""What the optimizers share: tensor lists grouped for the ``torch._foreach_*``
ops, the host update counter and the lr it selects."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def grouped(params: Dict[str, torch.Tensor], *trees) -> List[list]:
    """The parameters and the same-named leaves of each tree in ``trees``,
    as lists grouped by the parameter's device and dtype (the unit a
    multi-tensor launch takes): ``[[ps, *others], ...]``."""
    groups: dict = {}
    for name, p in params.items():
        lists = groups.setdefault((p.device, p.dtype),
                                  [[] for _ in range(1 + len(trees))])
        lists[0].append(p)
        for lst, tree in zip(lists[1:], trees):
            lst.append(tree[name])
    return list(groups.values())


def new_step() -> torch.Tensor:
    """The update count: a 0-d int32 tensor on the CPU (the dtype the JAX
    package checkpoints), so no update reads it back from the card."""
    return torch.zeros((), dtype=torch.int32)


def tick(opt_state: dict) -> int:
    """The update count before this update; advances it in place."""
    t = int(opt_state["step"])
    opt_state["step"].add_(1)
    return t


def lr_at(lr, t: int) -> float:
    """``lr`` at update count ``t``: a schedule is evaluated (in float32);
    a constant is taken as it is."""
    return float(lr(t)) if callable(lr) else lr


def f32(x) -> float:
    """``x`` rounded to float32, as the JAX package's on-device scalars are."""
    return float(np.float32(x))
