"""The port's ``utils`` observability half (``memory``, ``profiler``,
``metrics``) against the JAX package's ``tpu_dist.utils``.

``memory_*`` on the CPU return what the JAX package's CPU platform does
(no allocator statistics: ``{}``, 0, ``(0, 0)``); ``trace()`` writes a
Chrome trace on the CPU; ``StepTimer`` summarizes the same durations the
same way (the clock is mocked); ``accuracy``/``topk_accuracy``/
``confusion_matrix`` equal the JAX package's exactly on the same seeded
logits; and the collective counters are the recorder's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist.utils as jutils
import tpu_dist_torch.utils as tutils
from tpu_dist.utils import memory as jmemory
from tpu_dist.utils import profiler as jprofiler
from tpu_dist_torch.obs import recorder as trecorder
from tpu_dist_torch.utils import memory as tmemory
from tpu_dist_torch.utils import profiler as tprofiler


def test_export_lists_match():
    assert sorted(tutils.__all__) == sorted(jutils.__all__)


# -- memory -------------------------------------------------------------------


def test_memory_on_the_cpu_equals_the_jax_cpu_platform():
    assert tmemory.memory_stats("cpu") == jmemory.memory_stats() == {}
    assert tmemory.memory_allocated("cpu") == jmemory.memory_allocated() == 0
    assert tmemory.max_memory_allocated("cpu") == \
        jmemory.max_memory_allocated() == 0
    assert tmemory.mem_get_info("cpu") == jmemory.mem_get_info() == (0, 0)
    tail = ": no allocator statistics published on this platform"
    assert tmemory.memory_summary("cpu") == "cpu" + tail
    assert jmemory.memory_summary().endswith(tail)


def test_memory_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tmemory.memory_stats, tmemory.memory_allocated,
               tmemory.max_memory_allocated, tmemory.mem_get_info,
               tmemory.memory_summary):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# -- profiler -----------------------------------------------------------------


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with tprofiler.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    (name,) = os.listdir(tmp_path)
    assert name.startswith("trace_r0_") and name.endswith(".json")
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_trace_skips_other_ranks(tmp_path, monkeypatch):
    from tpu_dist_torch import dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    with tprofiler.trace(str(tmp_path / "r1")) as prof:
        pass
    assert prof is None and not (tmp_path / "r1").exists()
    with tprofiler.trace(str(tmp_path / "all"),
                         host_only_on_rank0=False) as prof:
        pass
    assert prof is not None
    assert os.listdir(tmp_path / "all")[0].startswith("trace_r1_")


@pytest.mark.parametrize("warmup,durations", [
    (3, [0.5, 0.4, 0.3, 0.010, 0.012, 0.011, 0.030, 0.009, 0.013]),
    (0, [0.002, 0.001, 0.003]),
    (5, [0.1, 0.2]),
    (1, [1.0] + [0.001 * (i % 7 + 1) for i in range(40)])])
def test_step_timer_summarizes_like_jax(monkeypatch, warmup, durations):
    summaries = []
    for mod in (jprofiler, tprofiler):
        clock = iter(np.cumsum([0.0] + [d for d in durations for d in
                                        (d, 0.0)]).tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup=warmup)
        for _ in durations:
            with timer:
                pass
        summaries.append((timer.steps, timer.mean(), timer.percentile(50),
                          timer.percentile(95), timer.summary()))
        monkeypatch.undo()
    assert summaries[1] == summaries[0]
    assert summaries[1][0] == max(0, len(durations) - warmup)


# -- metrics ------------------------------------------------------------------


@pytest.mark.parametrize("shape,ks", [((64, 10), (1, 5)),
                                      ((4, 16, 33), (1, 2, 3, 33)),
                                      ((1000, 7), (7, 1))])
def test_accuracy_metrics_equal_jax_exactly(shape, ks):
    rng = np.random.default_rng(sum(shape))
    logits = rng.standard_normal(shape).astype(np.float32)
    targets = rng.integers(0, shape[-1], shape[:-1])
    jt = jutils.topk_accuracy(jnp.asarray(logits), jnp.asarray(targets),
                              ks=ks)
    tt = tutils.topk_accuracy(torch.from_numpy(logits),
                              torch.from_numpy(targets), ks=ks)
    assert [t.dtype for t in tt] == [torch.float32] * len(ks)
    assert [float(t) for t in tt] == [float(j) for j in jt]
    ja = jutils.accuracy(jnp.asarray(logits), jnp.asarray(targets))
    ta = tutils.accuracy(torch.from_numpy(logits), torch.from_numpy(targets))
    assert ta.dtype == torch.float32 and float(ta) == float(ja)


def test_topk_validation_like_jax():
    for ks in ((5,), (0,)):
        with pytest.raises(ValueError, match="k must be"):
            tutils.topk_accuracy(torch.zeros(4, 3), torch.zeros(4), ks=ks)
    with pytest.raises(ValueError, match="non-empty"):
        tutils.topk_accuracy(torch.zeros(4, 3), torch.zeros(4), ks=())


@pytest.mark.parametrize("n,c", [(6, 3), (500, 10), (64, 2)])
def test_confusion_matrix_equals_jax_exactly(n, c):
    rng = np.random.default_rng(n)
    # out-of-range entries on both sides: dropped, not clamped
    preds = rng.integers(-1, c + 2, n)
    tgt = rng.integers(-2, c + 1, n)
    jcm = np.asarray(jutils.confusion_matrix(jnp.asarray(preds),
                                             jnp.asarray(tgt), c))
    tcm = tutils.confusion_matrix(torch.from_numpy(preds),
                                  torch.from_numpy(tgt), c)
    assert tcm.dtype == torch.int32
    np.testing.assert_array_equal(tcm.numpy(), jcm)
    valid = (preds >= 0) & (preds < c) & (tgt >= 0) & (tgt < c)
    assert int(tcm.sum()) == int(valid.sum())
    np.testing.assert_array_equal(
        tutils.confusion_matrix(preds, tgt, c).numpy(), jcm)


def test_collective_counter_shims_are_the_recorders():
    tutils.reset_collective_counters()
    tutils.record_collective("all_reduce", "store", 1024, 0.5)
    tutils.record_collective("all_reduce", "store", 1024, 0.5)
    tutils.record_collective("broadcast", "dataplane", 4096, 0.001)
    got = tutils.collective_counters()
    assert got == trecorder.transport_counters()
    assert got["all_reduce/store"]["calls"] == 2
    assert got["all_reduce/store"]["bytes"] == 2048
    assert got["all_reduce/store"]["mb_per_s"] == 2048 / 1.0 / 1e6
    assert tutils.collective_counters(reset=True) == got
    assert tutils.collective_counters() == {}
