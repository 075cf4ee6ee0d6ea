"""Pipeline schedules as explicit per-stage op sequences — and the role
graph whose channel depths ARE the schedule's flow control (counterpart of
``tpu_dist/pipeline/schedule.py``: the same op lists, bounds, credits and
graphs for every schedule, stage count and microbatch count).

The host pipeline (tpu_dist_torch/pipeline/) runs each stage as a role whose
main loop executes a static list of :class:`Op` entries — ``F k`` (claim
microbatch *k*'s activations from the inbound channel, run forward, put
downstream) and ``B k`` (claim the gradient, run backward over the
stashed input, put upstream).  Two schedules:

- **GPipe** — every stage runs ``F 0..M-1`` then ``B 0..M-1``.  Peak
  activation stash: all ``M`` microbatch inputs.
- **1F1B** — stage *i* (0-based, *S* stages) runs a **warmup** of
  ``w_i = min(S - i, M)`` forwards, then alternates ``B k / F w_i+k``
  1-for-1, then drains the trailing backwards.  Peak stash: ``w_i``
  microbatch inputs — the standard 1F1B memory bound, here enforced by
  :func:`stash_bound` and asserted in the stage runtime.

Flow control falls out of channel depth + claim ordering rather than any
scheduler process.  On the activation edge ``stage i -> stage i+1`` the
claim discipline bounds in-flight messages by the invariant
``F_i <= w_i + B_i`` (stage *i* only forwards past its warmup after a
backward, and its backward *k* needs downstream to have claimed
activation *k*), so::

    inflight(act_i) = F_i - F_{i+1} <= w_i + B_{i+1} - F_{i+1} <= w_i

Setting ``depth(act_i) = w_i`` (the 1F1B "warmup = depth" shape; ``M``
for GPipe) means no put ever reaches the backpressure wall.  Gradient
edges carry at most ``M`` messages per step, so ``depth = M`` never
blocks.  These bounds are exported to the static verifier as
``ChannelSpec.credits`` annotations: the act/grad edges form a directed
cycle, and TD101 (:mod:`tpu_dist_torch.analysis.protocol`) admits it
exactly when every edge has ``depth >= credits``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

__all__ = ["Op", "SCHEDULES", "schedule_ops", "stash_bound",
           "act_credits", "grad_credits", "bubble_fraction",
           "build_pipeline_graph", "stage_role", "parse_stage_role",
           "act_channel", "grad_channel"]

SCHEDULES = ("gpipe", "1f1b")


class Op(NamedTuple):
    """One schedule slot: ``phase`` is ``"F"`` or ``"B"``, ``mb`` the
    microbatch index."""
    phase: str
    mb: int


def _check(schedule: str, stage: int, num_stages: int,
           num_microbatches: int) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")
    if not 0 <= stage < num_stages:
        raise ValueError(f"stage {stage} out of range for "
                         f"{num_stages} stages")
    if num_microbatches < 1:
        raise ValueError(f"need at least one microbatch, "
                         f"got {num_microbatches}")


def schedule_ops(schedule: str, stage: int, num_stages: int,
                 num_microbatches: int) -> List[Op]:
    """Stage ``stage``'s op sequence for one optimizer step.  Both
    schedules forward microbatches in increasing order and backward them
    in increasing order — so gradient accumulation order (and therefore
    the summed gradient, bitwise) is schedule-independent."""
    _check(schedule, stage, num_stages, num_microbatches)
    m = num_microbatches
    if schedule == "gpipe":
        return ([Op("F", k) for k in range(m)]
                + [Op("B", k) for k in range(m)])
    w = min(num_stages - stage, m)
    ops = [Op("F", k) for k in range(w)]
    for k in range(m - w):
        ops.append(Op("B", k))
        ops.append(Op("F", w + k))
    ops.extend(Op("B", k) for k in range(m - w, m))
    return ops


def stash_bound(schedule: str, stage: int, num_stages: int,
                num_microbatches: int) -> int:
    """Max microbatch inputs stage ``stage`` ever holds stashed (forwarded
    but not yet backwarded) — ``M`` for GPipe, ``min(S - stage, M)`` for
    1F1B.  The stage runtime asserts its live stash never exceeds this."""
    _check(schedule, stage, num_stages, num_microbatches)
    if schedule == "gpipe":
        return num_microbatches
    return min(num_stages - stage, num_microbatches)


def act_credits(schedule: str, src_stage: int, num_stages: int,
                num_microbatches: int) -> int:
    """In-flight bound on the activation edge ``src_stage ->
    src_stage + 1`` — equal to the producer's stash bound (see the module
    docstring's invariant)."""
    return stash_bound(schedule, src_stage, num_stages, num_microbatches)


def grad_credits(schedule: str, num_stages: int,
                 num_microbatches: int) -> int:
    """In-flight bound on any gradient edge: at most one gradient per
    microbatch per step, claimed before the next step's puts begin."""
    _check(schedule, 0, num_stages, num_microbatches)
    return num_microbatches


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """The schedule-independent ideal pipeline bubble ``(S - 1) / (M + S
    - 1)`` — both GPipe and 1F1B idle each stage for S-1 of the M+S-1
    microbatch slots (1F1B wins on memory, not bubble)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


# -- role-graph construction --------------------------------------------------


def stage_role(stage: int) -> str:
    return f"stage{stage}"


def parse_stage_role(role: Optional[str]) -> Optional[int]:
    """``"stage3"`` -> 3; None for any other role name."""
    if not role or not role.startswith("stage"):
        return None
    tail = role[len("stage"):]
    return int(tail) if tail.isdigit() else None


def act_channel(src_stage: int, lane: Optional[int] = None) -> str:
    base = f"act{src_stage}"
    return base if lane is None else f"{base}.l{lane}"


def grad_channel(dst_stage: int, lane: Optional[int] = None) -> str:
    base = f"grad{dst_stage}"
    return base if lane is None else f"{base}.l{lane}"


def build_pipeline_graph(num_stages: int, dp: int = 1,
                         num_microbatches: int = 4,
                         schedule: str = "gpipe",
                         act_depth: Optional[int] = None,
                         grad_depth: Optional[int] = None,
                         payload_bytes: Optional[int] = None):
    """The dp x pp role graph: roles ``stage0..stage{S-1}`` (``dp`` ranks
    each, gang restart — peers hold activations derived from every
    stage's weights, so a stage death restarts the pipeline as a unit)
    plus act/grad channels per hop.

    Channel depths default to the schedule's in-flight bounds and carry
    matching ``credits`` annotations, so the act/grad cycle verifies
    clean under TD101; pass ``act_depth``/``grad_depth`` to override (an
    under-credit override is refused by the launcher's ``--verify_graph``
    pre-flight with a witness).  With ``dp > 1`` each data lane gets its
    own single-rank channel pair (``act0.l1``, ...) so activations keep
    riding the p2p frame path (multi-consumer channels fall back to the
    store funnel).
    """
    from ..roles.graph import ChannelSpec, Role, RoleGraph

    if num_stages < 2:
        raise ValueError(f"a pipeline needs >= 2 stages, got {num_stages}")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    _check(schedule, 0, num_stages, num_microbatches)
    roles = [Role(stage_role(i), dp, restart="gang")
             for i in range(num_stages)]
    lanes = [None] if dp == 1 else list(range(dp))
    channels = []
    for i in range(num_stages - 1):
        a_credits = act_credits(schedule, i, num_stages, num_microbatches)
        g_credits = grad_credits(schedule, num_stages, num_microbatches)
        for lane in lanes:
            channels.append(ChannelSpec(
                act_channel(i, lane), src=stage_role(i),
                dst=stage_role(i + 1),
                depth=act_depth if act_depth is not None else a_credits,
                credits=a_credits, payload_bytes=payload_bytes))
            channels.append(ChannelSpec(
                grad_channel(i, lane), src=stage_role(i + 1),
                dst=stage_role(i),
                depth=grad_depth if grad_depth is not None else g_credits,
                credits=g_credits, payload_bytes=payload_bytes))
    return RoleGraph(roles, channels)
