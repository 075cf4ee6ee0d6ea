"""The port's collective sanitizer (``tpu_dist_torch.analysis.sanitizer``)
against the JAX package's (``tpu_dist.analysis.sanitizer``).

- Signatures equal JAX's for the same trees (a torch tree on the port's
  side, the same numpy tree on JAX's), the ``tree`` hash of the structure
  included: a mixed gang must not mismatch on every collective.
- World 2 in rank processes (the sanitized-call counters are per
  process): a rank-divergent eager ``all_reduce_host`` raises
  ``CollectiveMismatchError`` on both ranks, naming the ``leaves``
  divergence, before any payload moves; a rank that never announces is
  named by the deadline, as the JAX error names it.
- A mixed pair, one JAX rank and one port rank over one store, passes a
  matching collective and names a mismatched one on both sides.

Every comparison is exact."""

import collections
import json
import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_dist.analysis import sanitizer as jsan
from tpu_dist_torch.analysis import sanitizer as tsan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

Pair = collections.namedtuple("Pair", "left right")


def _sig(mod, value, **kw):
    # one line for both packages: the signature's call-site is this frame
    return mod._signature("all_reduce", 1, value=value, **kw)


def _trees():
    a = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    t = torch.from_numpy(a)
    return {
        "leaf": (a, t),
        "dict": ({"w": a, "b": np.arange(3)}, {"w": t, "b": torch.arange(3)}),
        "bf16": ({"x": a.astype(ml_dtypes.bfloat16)},
                 {"x": t.to(torch.bfloat16)}),
        "nested": ([a, (None, {"k": np.int32(2)}), [], ()],
                   [t, (None, {"k": np.int32(2)}), [], ()]),
        "single_tuple": ((a,), (t,)),
        "int_keys": ({0: a, 2: [a]}, {0: t, 2: [t]}),
        "namedtuple": (Pair(a, [a]), Pair(t, [t])),
        "scalars": ([1.5, 3, True], [1.5, 3, True]),
        "bool_u8": ([a > 0, a.astype(np.uint8)], [t > 0, t.to(torch.uint8)]),
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_signature_equals_jax(name):
    jtree, ttree = _trees()[name]
    for kw in ({"reduce_op": "SUM", "comm": "int8_block256"},
               {"src": 1}, {"dst": 0, "with_leaves": False}):
        assert _sig(tsan, ttree, **kw) == _sig(jsan, jtree, **kw)
    sig = _sig(tsan, ttree)
    assert sig["site"].startswith("test_torch_sanitizer.py:")
    assert len(sig["tree"]) == 12


def test_signature_of_a_cuda_shaped_leaf_reads_no_values():
    """A leaf's signature comes from its shape and dtype: a meta tensor,
    which has no values at all, signs like a real one."""
    meta = torch.empty((2, 5), dtype=torch.bfloat16, device="meta")
    real = torch.zeros((2, 5), dtype=torch.bfloat16)
    assert _sig(tsan, {"g": meta}) == _sig(tsan, {"g": real})
    assert _sig(tsan, {"g": meta})["leaves"] == [["bfloat16", [2, 5]]]


# -- rank processes over one store --------------------------------------------

_WORKER = textwrap.dedent("""
    import json, os, sys
    pkg, rank, port, scenario = sys.argv[1:5]
    rank, port = int(rank), int(port)
    if pkg == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import ml_dtypes
        from tpu_dist.analysis import sanitizer as san
        from tpu_dist.dist.store import TCPStore
        bf16 = lambda a: a.astype(ml_dtypes.bfloat16)
    else:
        import torch
        from tpu_dist_torch.analysis import sanitizer as san
        from tpu_dist_torch.dist.store import TCPStore
        bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    import numpy as np

    class G:
        num_processes = 2
    G.rank = rank
    store = TCPStore("127.0.0.1", port)
    out = {"rank": rank, "ok": [], "err": None}
    x = np.arange(8, dtype=np.float32)

    def check(value, op="all_reduce"):
        san.check_collective(G(), store, op, value=value, reduce_op="sum")
        out["ok"].append(op)

    try:
        if scenario == "eager":
            # the eager path: the check runs before any payload moves, so
            # the data plane never starts
            import importlib
            from tpu_dist_torch import collectives as C
            from tpu_dist_torch.collectives import transport
            importlib.import_module(
                "tpu_dist_torch.dist.rendezvous")._store = store
            C.all_reduce_host({"g": x}, group=G(), op="sum")
            out["ok"].append("all_reduce_host")
            # the next payload would ride the data plane
            os.environ["TPU_DIST_DP_THRESHOLD"] = "0"
            leaf = bf16(x) if rank == 1 else x
            try:
                C.all_reduce_host({"g": leaf}, group=G(), op="sum")
            finally:
                out["dataplane"] = transport._dp is not None
        elif scenario == "missing":
            if rank == 0:
                check(x, op="barrier")
        else:  # mixed: one matching collective, then rank 1 diverges
            check({"w": x, "b": [x[:2], None]})
            check({"w": bf16(x) if rank == 1 else x, "b": [x[:2], None]})
    except Exception as e:
        out["err"] = {"type": type(e).__name__, "msg": str(e),
                      "divergent": sorted(getattr(e, "divergent", {})),
                      "missing": getattr(e, "missing", None)}
    print(json.dumps(out))
    store.close()
""")


def _run_pair(tmp_path, pkgs, scenario):
    from tpu_dist_torch.dist.store import TCPStore
    script = tmp_path / "san_worker.py"
    script.write_text(_WORKER)
    store = TCPStore(is_master=True)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               TPU_DIST_SANITIZE="1", OMP_NUM_THREADS="1",
               # the deadline starts when a rank reaches the collective: a
               # generous one where both ranks come (a JAX rank imports
               # slowly under load), a short one where one never does
               TPU_DIST_SANITIZE_TIMEOUT="3" if scenario == "missing"
               else "120")
    env.pop("TPU_DIST_RESTART_COUNT", None)
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(script), pkg, str(r), str(store.port),
             scenario], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for r, pkg in enumerate(pkgs)]
        outs = []
        for p in procs:
            so, se = p.communicate(timeout=120)
            assert p.returncode == 0, se
            outs.append(json.loads(so.strip().splitlines()[-1]))
        return outs
    finally:
        store.close()


@pytest.mark.multiprocess
def test_world2_mismatch_named_on_both_ranks_before_payload(tmp_path):
    outs = _run_pair(tmp_path, ("port", "port"), "eager")
    for o in outs:
        assert o["ok"] == ["all_reduce_host"], o
        err = o["err"]
        assert err["type"] == "CollectiveMismatchError", o
        assert err["divergent"] == [1]
        assert "leaves:" in err["msg"] and "bfloat16" in err["msg"]
        assert "san_worker.py" in err["msg"]
        # the first collective rode the store; the refused one would
        # have been the first to start the data plane
        assert o["dataplane"] is False


@pytest.mark.multiprocess
def test_world2_missing_rank_named_by_deadline(tmp_path):
    outs = _run_pair(tmp_path, ("port", "port"), "missing")
    err = outs[0]["err"]
    assert err["type"] == "CollectiveMismatchError" and err["missing"] == [1]
    assert "never announced" in err["msg"] and "barrier" in err["msg"]
    assert outs[1]["err"] is None


@pytest.mark.multiprocess
@pytest.mark.parametrize("pkgs", [("jax", "port"), ("port", "jax")])
def test_mixed_pair_passes_a_match_and_names_a_mismatch(tmp_path, pkgs):
    outs = _run_pair(tmp_path, pkgs, "mixed")
    for o in outs:
        assert o["ok"] == ["all_reduce"], o
        assert o["err"]["type"] == "CollectiveMismatchError"
        assert o["err"]["divergent"] == [1]
        assert "leaves:" in o["err"]["msg"]
