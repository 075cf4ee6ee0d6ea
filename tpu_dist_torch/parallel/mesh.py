"""The ``("data", "model")`` mesh of ranks — counterpart of
``tpu_dist/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` of devices; in the port a
rank drives one device and the mesh is the default process group's
(``dist.init_process_group(axis_names=, mesh_shape=)``: the ranks laid out
row-major, a ``torch.distributed`` group for each line).  :func:`get_mesh`
gives that layout for a world, with the JAX package's errors, and
:func:`mesh_shape_for` the dp × mp factorization of a rule binding.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

__all__ = ["Mesh", "get_mesh", "mesh_shape_for"]


def mesh_shape_for(rules: Dict[str, Optional[str]], world: int,
                   model_parallel: int = 1,
                   axis_names: Tuple[str, str] = ("data", "model")
                   ) -> Dict[str, int]:
    """dp×mp factorization of ``world`` for a rule binding: the model dim
    gets ``model_parallel`` only when some logical axis actually rides it
    (an all-``None`` table collapses to pure dp — editing only the rule
    table re-partitions the run)."""
    data_name, model_name = axis_names
    mp = model_parallel if any(m == model_name for m in rules.values()) \
        else 1
    if world % mp:
        raise ValueError(f"world {world} not divisible by model_parallel "
                         f"{mp}")
    return {data_name: world // mp, model_name: mp}


class Mesh(NamedTuple):
    """A mesh of ranks: ``axis_names`` and ``mesh_shape``, as
    ``dist.init_process_group`` takes them; ``ranks`` in row-major order."""
    axis_names: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    ranks: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.mesh_shape))


def get_mesh(dp: Optional[int] = None, mp: int = 1,
             axis_names: Sequence[str] = ("data", "model"),
             ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The (dp, mp) mesh over ``axis_names``.  ``ranks`` (default: the
    default group's, or this process alone) stand for the JAX package's
    devices; ``dp=None`` takes all of them: ``get_mesh(mp=2)`` at world 8
    is a 4×2 dp×tp mesh.  Raises ``ValueError`` when ``mp`` does not
    divide the ranks or they are too few for ``dp × mp``."""
    if ranks is None:
        from .. import dist
        n = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(n)
    ranks = tuple(int(r) for r in ranks)
    if dp is None:
        if len(ranks) % mp:
            raise ValueError(f"{len(ranks)} devices not divisible by "
                             f"mp={mp}")
        dp = len(ranks) // mp
    need = dp * mp
    if len(ranks) < need:
        raise ValueError(f"need {need} devices for a {dp}x{mp} mesh, "
                         f"have {len(ranks)}")
    return Mesh(tuple(axis_names), (dp, mp), ranks[:need])
