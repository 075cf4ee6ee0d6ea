"""The port's host-path pipeline (``tpu_dist_torch/pipeline/``) against the
JAX package's (``tpu_dist/pipeline/``) — the twin of
``tests/test_pipeline_host.py``.

- Partition: the owner map, an exact merge of the stages' trees, stage
  chains equal to the port's full forward bit for bit and to the JAX
  forward on the same weights (float32 ``atol`` 1e-5) for TransformerLM and
  the ConvNet; the refusals.
- Schedule: op lists, stash bounds, credits, bubble fractions and role
  graphs equal to the JAX package's, field by field, for every schedule
  and (S, M) of the JAX tests.
- Stage runtime: the int8_block wire's frames equal the JAX package's byte
  for byte; the contract checks.
- The serial oracle against the JAX package's ``SerialPipelineRunner``
  from the same weights (losses ``rtol`` 1e-5, merged parameters ``atol``
  1e-6) and against a plain microbatched step; the bench's smoke (GPipe ==
  1F1B == serial bit for bit, 1F1B's stash below GPipe's); ``obs
  diagnose`` naming a starved stage; the ``pipeline_train`` twin under the
  launcher: a SIGKILLed stage's gang restart resuming bit for bit the
  serial oracle, and dp × pp lanes; the host GPipe against the port's mesh
  GPipe (``rtol`` 1e-4, the JAX test's); ``build_tp_stage_fns`` on a pp 2
  × tp 2 grid against the JAX package's (losses ``rtol`` 1e-5, shards
  ``rtol`` 1e-5 / ``atol`` 2e-6).
"""

import json
import os
import pathlib
import queue
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from tpu_dist import nn as jnn
from tpu_dist import optim as joptim
from tpu_dist import pipeline as jpipe
from tpu_dist.models import ConvNet as JaxConvNet
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist_torch import nn as tnn
from tpu_dist_torch import optim as toptim
from tpu_dist_torch import pipeline as tpipe
from tpu_dist_torch.interop import jax_params, load_jax_params
from tpu_dist_torch.models import ConvNet as TorchConvNet
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.pipeline.partition import param_tree

REPO = pathlib.Path(__file__).resolve().parent.parent
VOCAB, DIM, DEPTH, HEADS, T = 31, 16, 4, 2, 12


def _jax_model(depth=DEPTH):
    return JaxLM(vocab_size=VOCAB, dim=DIM, depth=depth, num_heads=HEADS,
                 max_seq_len=T)


def _jax_tree(depth=DEPTH, seed=0):
    return jax.tree.map(np.array, _jax_model(depth).init(
        jax.random.key(seed)))


def _torch_model(depth=DEPTH, tree=None):
    model = TorchLM(VOCAB, dim=DIM, depth=depth, num_heads=HEADS,
                    max_seq_len=T, device="cpu")
    return load_jax_params(model, _jax_tree(depth) if tree is None else tree)


def _data(batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, (batch, T)).astype(np.int32)
    y = rng.integers(0, VOCAB, (batch, T)).astype(np.int32)
    return x, y


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# -- partitioner --------------------------------------------------------------


class TestPartition:
    def test_transformer_owner_map_contiguous(self):
        part = tpipe.partition_model(_torch_model(), 3)
        want = jpipe.partition_model(_jax_model(), 3)
        assert part.num_stages == 3 and part.spans == want.spans
        assert part.owner_of("tok") == 0
        assert part.owner_of("ln_f") == 2 and part.owner_of("head") == 2
        owners = [part.owner_of(f"block{j}") for j in range(DEPTH)]
        assert owners == [want.owner_of(f"block{j}") for j in range(DEPTH)]
        assert owners == sorted(owners) and set(owners) == {0, 1, 2}

    def test_merge_roundtrip_is_exact(self):
        model = _torch_model()
        full = param_tree(model)
        part = tpipe.partition_model(model, 3)
        shards = [part.stage_params(full, i) for i in range(3)]
        keys = [set(s) for s in shards]
        for i in range(3):
            for j in range(i + 1, 3):
                assert not (keys[i] & keys[j])
        merged = part.merge_params(shards)
        assert set(merged) == set(full) == set(_jax_tree())
        for p, lv in full.items():
            for k, v in lv.items():
                assert merged[p][k] is v

    def test_transformer_stage_chain_matches_full_forward(self):
        """Bit for bit the port's forward; the JAX forward within float32
        tolerance on the same weights."""
        model = _torch_model()
        full = param_tree(model)
        x, _ = _data(batch=4)
        with torch.no_grad():
            want = model(_t(x))
        jax_want = np.asarray(_jax_model().apply(_jax_tree(), x))
        for s in (2, 3):
            part = tpipe.partition_model(model, s)
            h = _t(x)
            with torch.no_grad():
                for i in range(s):
                    h = part.stage_fn(i)(part.stage_params(full, i), h)
            assert torch.equal(h, want)
            np.testing.assert_allclose(h.numpy(), jax_want, atol=1e-5)

    def test_convnet_stage_chain_matches_jax_apply(self):
        jmodel = JaxConvNet()
        tree = jax.tree.map(np.array, jmodel.init(jax.random.key(1)))
        rng = np.random.default_rng(3)
        x = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
        want = np.asarray(jmodel.apply(tree, x))
        model = load_jax_params(TorchConvNet(device="cpu"), tree)
        full = param_tree(model)
        part = tpipe.partition_model(model, 2)
        h = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        with torch.no_grad():
            for i in range(2):
                h = part.stage_fn(i)(part.stage_params(full, i), h)
            assert torch.equal(h, model(torch.from_numpy(
                x.transpose(0, 3, 1, 2).copy())))
        np.testing.assert_allclose(h.numpy(), want, atol=1e-5)

    def test_too_many_stages_refused(self):
        with pytest.raises(tpipe.PipelinePartitionError):
            tpipe.partition_model(_torch_model(), DEPTH + 1)

    def test_unknown_model_refused(self):
        with pytest.raises(tpipe.PipelinePartitionError,
                           match="supported"):
            tpipe.partition_model(tnn.Linear(2, 2, device="cpu"), 2)


# -- schedule algebra ---------------------------------------------------------


class TestSchedule:
    @pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
    @pytest.mark.parametrize("s,m", [(2, 4), (3, 4), (4, 8), (3, 2)])
    def test_ops_bounds_and_credits_equal_jax(self, schedule, s, m):
        for i in range(s):
            ops = tpipe.schedule_ops(schedule, i, s, m)
            assert [tuple(o) for o in ops] == [
                tuple(o) for o in jpipe.schedule_ops(schedule, i, s, m)]
            assert tpipe.stash_bound(schedule, i, s, m) == \
                jpipe.stash_bound(schedule, i, s, m)
            assert tpipe.act_credits(schedule, i, s, m) == \
                jpipe.act_credits(schedule, i, s, m)
            live, peak = set(), 0
            for op in ops:
                (live.add if op.phase == "F" else live.remove)(op.mb)
                peak = max(peak, len(live))
            assert peak == tpipe.stash_bound(schedule, i, s, m)
            assert [o.mb for o in ops if o.phase == "B"] == list(range(m))
        assert tpipe.grad_credits(schedule, s, m) == \
            jpipe.grad_credits(schedule, s, m)
        assert tpipe.bubble_fraction(s, m) == jpipe.bubble_fraction(s, m)

    def test_role_names_and_channels(self):
        for f in ("stage_role", "act_channel", "grad_channel"):
            assert getattr(tpipe, f)(2) == getattr(jpipe, f)(2)
        assert tpipe.act_channel(0, 1) == jpipe.act_channel(0, 1)
        for name in ("stage11", "learner", "stage", None):
            assert tpipe.parse_stage_role(name) == \
                jpipe.parse_stage_role(name)
        with pytest.raises(ValueError, match="schedule must be one of"):
            tpipe.schedule_ops("zb", 0, 2, 4)

    @pytest.mark.parametrize("kw", [
        dict(num_stages=3, num_microbatches=6, schedule="1f1b"),
        dict(num_stages=2, dp=2, num_microbatches=4),
        dict(num_stages=3, num_microbatches=4, act_depth=1),
        dict(num_stages=4, num_microbatches=8, schedule="gpipe",
             payload_bytes=4096)])
    def test_build_graph_equals_jax(self, kw):
        got = tpipe.build_pipeline_graph(**kw)
        want = jpipe.build_pipeline_graph(**kw)
        assert [(r.name, r.world, r.restart) for r in got.roles] == \
            [(r.name, r.world, r.restart) for r in want.roles]
        fields = ("name", "src", "dst", "depth", "kind", "payload_bytes",
                  "drain", "credits")
        assert [tuple(getattr(c, f) for f in fields) for c in got.channels] \
            == [tuple(getattr(c, f) for f in fields) for c in want.channels]
        assert json.loads(got.to_json()) == json.loads(want.to_json())

    def test_underdepth_graph_flagged_by_verifier(self):
        """The twin of the JAX test: the port's verifier refuses the
        under-depth act ring (TD101 "under-depth") with the JAX
        verifier's findings, and both schedules verify clean."""
        from tpu_dist.analysis import verify_graph as jverify
        from tpu_dist_torch.analysis import verify_graph
        kw = dict(num_microbatches=4, act_depth=1)
        g = tpipe.build_pipeline_graph(3, **kw)
        errs = [f for f in verify_graph(g) if f.severity == "error"]
        assert errs and all(f.rule == "TD101" for f in errs)
        assert "under-depth" in errs[0].message
        assert [(f.rule, f.message) for f in verify_graph(g)] == [
            (f.rule, f.message)
            for f in jverify(jpipe.build_pipeline_graph(3, **kw))]
        # the well-depthed graphs verify clean, both schedules
        for schedule in ("gpipe", "1f1b"):
            g = tpipe.build_pipeline_graph(3, num_microbatches=4,
                                           schedule=schedule)
            assert verify_graph(g) == []


# -- stage runtime ------------------------------------------------------------


class TestStageRuntime:
    def test_split_microbatches(self):
        x = torch.arange(12).reshape(6, 2)
        mbs = tpipe.split_microbatches(x, 3)
        assert len(mbs) == 3 and all(m.shape == (2, 2) for m in mbs)
        assert torch.equal(torch.cat(mbs), x)
        with pytest.raises(ValueError):
            tpipe.split_microbatches(x, 4)

    def test_int8_frames_equal_jax(self):
        ours = tpipe.PipelineStage(tpipe.StageFns(), 0, 2, 4,
                                   compress="int8_block64")
        theirs = jpipe.PipelineStage(jpipe.StageFns(), 0, 2, 4,
                                     compress="int8_block64")
        rng = np.random.default_rng(5)
        h = rng.standard_normal((4, 96)).astype(np.float32)
        idx = np.arange(6, dtype=np.int32)
        enc = ours._encode({"h": torch.from_numpy(h),
                            "idx": torch.from_numpy(idx)})
        want = theirs._encode({"h": h, "idx": idx})
        assert enc["h"]["__pipeq__"] and enc["h"]["q"].dtype == np.int8
        assert enc["h"]["q"].tobytes() == want["h"]["q"].tobytes()
        assert enc["h"]["s"].tobytes() == want["h"]["s"].tobytes()
        assert {k: enc["h"][k] for k in ("shape", "dtype", "block")} == \
            {k: want["h"][k] for k in ("shape", "dtype", "block")}
        assert torch.equal(enc["idx"], torch.from_numpy(idx))
        dec = ours._decode(enc)
        assert dec["h"].shape == (4, 96) and dec["h"].dtype == torch.float32
        np.testing.assert_array_equal(dec["h"].numpy(),
                                      theirs._decode(want)["h"])
        np.testing.assert_allclose(dec["h"].numpy(), h, atol=0.05)

    def test_bad_compress_scheme_refused(self):
        with pytest.raises(ValueError):
            tpipe.PipelineStage(tpipe.StageFns(), 0, 2, 4,
                                compress="fp4_magic")

    def test_microbatch_contract_enforced(self):
        stage = tpipe.PipelineStage(tpipe.StageFns(), 0, 2, 4)
        with pytest.raises(tpipe.PipelineScheduleError):
            stage.run_step({}, x_mb=[1, 2])


# -- the serial oracle --------------------------------------------------------


def test_serial_oracle_matches_jax_serial_runner():
    """The port's oracle against the JAX package's on the same weights:
    three SGD steps at 2 stages and 4 microbatches."""
    x, y = _data(batch=8)
    ref = jpipe.SerialPipelineRunner(_jax_model(), joptim.SGD(lr=1e-2),
                                     jnn.CrossEntropyLoss(), num_stages=2,
                                     num_microbatches=4)
    tree = _jax_tree()
    ours = tpipe.SerialPipelineRunner(
        TorchLM(VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS, max_seq_len=T,
                device="cpu"), toptim.SGD(lr=1e-2),
        tnn.CrossEntropyLoss(), num_stages=2, num_microbatches=4,
        init_params=lambda m: load_jax_params(m, tree))
    for _ in range(3):
        np.testing.assert_allclose(ours.step(_t(x), _t(y)), ref.step(x, y),
                                   rtol=1e-5)
    model = TorchLM(VOCAB, dim=DIM, depth=DEPTH, num_heads=HEADS,
                    max_seq_len=T, device="cpu")
    with torch.no_grad():
        for p, lv in ours.merged_params().items():
            for k, v in lv.items():
                model.get_parameter(f"{p}.{k}").copy_(v)
    got, want = jax_params(model), ref.merged_params()
    for p, lv in want.items():
        for k, v in lv.items():
            np.testing.assert_allclose(got[p][k], np.asarray(v), atol=1e-6,
                                       err_msg=f"{p}.{k}")


def test_serial_oracle_matches_plain_microbatched_reference():
    """Same partition + stage fns run serially == the plain model at
    matched math (per-microbatch gradients, /M, SGD): loss floats equal."""
    ref = _torch_model()
    ce = tnn.CrossEntropyLoss()
    m = 4
    x, y = _data(batch=8)
    runner = tpipe.SerialPipelineRunner(
        _torch_model(), toptim.SGD(lr=1e-2), ce, num_stages=2,
        num_microbatches=m, init_params=lambda mm: load_jax_params(
            mm, _jax_tree()))
    params = dict(ref.named_parameters())
    for _ in range(3):
        losses, acc = [], None
        for xm, ym in zip(tpipe.split_microbatches(_t(x), m),
                          tpipe.split_microbatches(_t(y), m)):
            loss = ce(ref(xm).reshape(-1, VOCAB), ym.reshape(-1))
            g = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
        with torch.no_grad():
            for p, a in zip(params.values(), acc):
                p -= 1e-2 * (a / m)
        got = runner.step(_t(x), _t(y))
        assert got == pytest.approx(float(np.mean(np.float32(losses))),
                                    rel=1e-6)
    merged = runner.merged_params()
    for k, p in params.items():
        path, _, leaf = k.rpartition(".")
        np.testing.assert_allclose(merged[path][leaf].numpy(),
                                   p.detach().numpy(), atol=1e-6)


# -- bench smoke --------------------------------------------------------------


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "TPU_DIST_STORE_ADDR", "TPU_DIST_CHAOS"):
        env.pop(var, None)
    return env


def test_bench_pipeline_smoke():
    """Real store-backed channels, one thread a stage: GPipe == 1F1B ==
    serial bit for bit, and 1F1B's stage-0 stash watermark strictly below
    GPipe's."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.benchmarks.bench_pipeline",
         "--device", "cpu", "--smoke"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    rows = [json.loads(line) for line in r.stdout.splitlines()]
    assert rows[-1]["parity"] == "bitwise"
    gp, f1 = rows[0], rows[1]
    assert gp["schedule"] == "gpipe" and f1["schedule"] == "1f1b"
    assert f1["stash_peak_bytes"][0] < gp["stash_peak_bytes"][0]


# -- obs: a starved stage is named --------------------------------------------


def test_diagnose_names_starved_stage():
    from tpu_dist_torch import obs
    dumps = [{"rank": 0, "role": "stage0", "role_rank": 0, "world": 2,
              "events": [{"kind": "pipeline", "op": "claim-grad",
                          "outcome": "pending", "stage": 0, "mb": 1,
                          "phase": "bwd", "t0": 1, "t1": 2}]},
             {"rank": 1, "role": "stage1", "role_rank": 0, "world": 2,
              "events": []}]
    d = obs.diagnose(dumps)
    assert d["pipeline_stalls"] == [
        {"rank": 0, "role": "stage0[0]", "stage": 0, "mb": 1,
         "phase": "bwd", "op": "claim-grad"}]
    text = obs.render_diagnosis(d)
    assert "stalled pipeline stage" in text
    assert "blocked claiming gradients that stage1 never produced" in text


# -- the pipeline_train twin under the launcher -------------------------------


def _serial_example_losses(steps, batch):
    from tpu_dist_torch.examples import pipeline_train as ex
    model = TorchLM(vocab_size=ex.VOCAB, dim=ex.DIM, depth=ex.DEPTH,
                    num_heads=ex.HEADS, max_seq_len=ex.SEQ, device="cpu")
    runner = tpipe.SerialPipelineRunner(model, toptim.SGD(lr=1e-2),
                                        tnn.CrossEntropyLoss(),
                                        num_stages=2, num_microbatches=4)
    out = {}
    for step in range(steps):
        x, y = ex.batch_for_step(step, 0, batch)
        out[str(step)] = runner.step(_t(x), _t(y))
    return out


def _launch(tmp_path, roles, extra, env_extra=None):
    env = dict(_env(), **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_dist_torch.launch", "--roles", roles]
        + extra, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_launched_twin_stage_death_and_dp_lanes(tmp_path):
    """Two launches at once.  (a) SIGKILL the last stage after its step-2
    checkpoint: one gang restart, generation 1 resumes at step 3 and its
    losses equal the uninterrupted serial oracle float for float; the
    launcher's automatic verifier pre-flight ran first.  (b) 2
    lanes × 2 stages: per-lane channels carry distinct batches, the stage
    sub-groups run the bucketed grad sync, both lanes record every step."""
    out, ckpt, out_dp = tmp_path / "out", tmp_path / "ckpt", tmp_path / "dp"
    steps, batch = 5, 8
    kill = _launch(tmp_path, "stage0:1,stage1:1",
                   ["--max_restarts", "1", "-m",
                    "tpu_dist_torch.examples.pipeline_train",
                    "--device", "cpu", "--steps", str(steps),
                    "--batch-size", str(batch), "--out", str(out),
                    "--state-root", str(ckpt), "--save-every", "1"],
                   {"TPU_DIST_CHAOS": "kill:rank=1,step=2"})
    lanes = _launch(tmp_path, "stage0:2,stage1:2",
                    ["-m", "tpu_dist_torch.examples.pipeline_train",
                     "--device", "cpu", "--steps", "3", "--dp", "2",
                     "--out", str(out_dp)], {"PIPELINE_DP": "2"})
    try:
        k_out, k_err = kill.communicate(timeout=300)
        l_out, l_err = lanes.communicate(timeout=300)
    finally:
        for p in (kill, lanes):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert kill.returncode == 0, f"stdout:\n{k_out}\nstderr:\n{k_err}"
    assert "gang restart" in k_err
    assert "--verify_graph: note: graph from the --roles spec" in k_err
    assert "without the verifier's pre-flight" not in k_err
    g1 = json.load(open(out / "stage1_l0_g1.json"))
    assert g1["generation"] == 1 and g1["restart_count"] == 1
    assert g1["start"] == 3 and set(g1["losses"]) == {"3", "4"}
    ref = _serial_example_losses(steps, batch)
    assert g1["losses"] == {k: ref[k] for k in g1["losses"]}

    assert lanes.returncode == 0, f"stdout:\n{l_out}\nstderr:\n{l_err}"
    got = [json.load(open(out_dp / f"stage1_l{lane}_g0.json"))
           for lane in (0, 1)]
    for lane in got:
        assert set(lane["losses"]) == {"0", "1", "2"}
    assert got[0]["losses"] != got[1]["losses"]


# -- the host GPipe against the port's mesh GPipe -----------------------------


def test_host_gpipe_matches_mesh_gpipe():
    """The host pipeline (4 stages, serial) and the port's mesh pipeline
    (``PipelineParallel``, a pipe axis of one rank here) implement the same
    schedule's math: three SGD steps' losses within the JAX test's 1e-4."""
    from tpu_dist_torch import dist
    from tpu_dist_torch.parallel import PipelineParallel
    x, y = _data(batch=8)
    tree = _jax_tree()
    dist.init_process_group(device="cpu", axis_names=("pipe",))
    try:
        pp = PipelineParallel(_torch_model(), optimizer=toptim.SGD(lr=0.1),
                              loss_fn=tnn.CrossEntropyLoss(),
                              num_microbatches=4)
        state = pp.init(seed=0, init_params=lambda m: load_jax_params(
            m, tree))
        # the rank's state holds the weights; the module gave its up
        assert all(p.is_meta for p in pp.model.parameters())
        mesh = []
        for _ in range(3):
            state, metrics = pp.train_step(state, x, y)
            mesh.append(float(metrics["loss"]))
    finally:
        dist.destroy_process_group()
    runner = tpipe.SerialPipelineRunner(
        _torch_model(), toptim.SGD(lr=0.1), tnn.CrossEntropyLoss(),
        num_stages=4, num_microbatches=4,
        init_params=lambda m: load_jax_params(m, tree))
    host = [runner.step(_t(x), _t(y)) for _ in range(3)]
    np.testing.assert_allclose(host, mesh, rtol=1e-4)


# -- dp × tp × pp: build_tp_stage_fns against the JAX package's ---------------


class _QChan:
    def __init__(self):
        self._q = queue.Queue()

    def put(self, tree, timeout=None):
        self._q.put(tree)

    def get(self, timeout=None):
        return self._q.get(timeout=timeout)


TP_VOCAB, TP_DIM, TP_DEPTH, TP_HEADS, TP_SEQ = 64, 32, 2, 4, 8


def _tp_grid(pkg, steps=2, pp_n=2, tp_n=2):
    """A pp × tp grid of ``build_tp_stage_fns`` stages of package ``pkg``
    (``"jax"`` or ``"port"``) on threads, GPipe M = 1, SGD 0.1 on each
    shard, from the JAX init: each step's last-stage losses and the final
    shards (numpy, JAX layouts)."""
    from tpu_dist.parallel import tensor as jtensor
    from tpu_dist_torch.parallel import tensor as ttensor
    from tpu_dist_torch.parallel.rules import DEFAULT_RULES
    jm = JaxLM(vocab_size=TP_VOCAB, dim=TP_DIM, depth=TP_DEPTH,
               num_heads=TP_HEADS, max_seq_len=TP_SEQ)
    full = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if pkg == "jax":
        T_, P_, model = jtensor, jpipe, jm
        ce = jnn.CrossEntropyLoss()
        opt = joptim.SGD(lr=0.1)
    else:
        T_, P_ = ttensor, tpipe
        model = load_jax_params(TorchLM(
            TP_VOCAB, dim=TP_DIM, depth=TP_DEPTH, num_heads=TP_HEADS,
            max_seq_len=TP_SEQ, device="cpu"), full)
        ce = tnn.CrossEntropyLoss()
        opt = toptim.SGD(lr=0.1)

    def loss_fn(logits, y):
        return ce(logits.reshape(-1, TP_VOCAB), y.reshape(-1))

    part = P_.partition_model(model, pp_n)
    combiners = [T_.LocalCombiner(tp_n) for _ in range(pp_n)]
    act = [_QChan() for _ in range(tp_n)]
    grad = [_QChan() for _ in range(tp_n)]
    stages, params, opt_states = {}, {}, {}
    for s in range(pp_n):
        for t in range(tp_n):
            fns = T_.build_tp_stage_fns(part, s, loss_fn,
                                        combiners[s].bound(t),
                                        rules=DEFAULT_RULES)
            stages[(s, t)] = P_.PipelineStage(
                fns, s, pp_n, num_microbatches=1,
                out_act=act[t] if s == 0 else None,
                in_act=act[t] if s == 1 else None,
                in_grad=grad[t] if s == 0 else None,
                out_grad=grad[t] if s == 1 else None)
            shard = T_.tp_shard_params(model, part.stage_params(full, s), t,
                                       tp_n, DEFAULT_RULES)
            if pkg == "port":
                shard = ttensor._to_device(shard, "cpu")
                opt_states[(s, t)] = opt.init(ttensor._flat_keys(shard))
            else:
                opt_states[(s, t)] = opt.init(shard)
            params[(s, t)] = shard
    losses = []
    try:
        for step in range(steps):
            rng = np.random.default_rng(step)
            x = rng.integers(0, TP_VOCAB, (4, TP_SEQ))
            y = rng.integers(0, TP_VOCAB, (4, TP_SEQ))
            if pkg == "port":
                x, y = torch.from_numpy(x), torch.from_numpy(y)
            results, errs = {}, []

            def run(s, t):
                try:
                    results[(s, t)] = stages[(s, t)].run_step(
                        params[(s, t)], x_mb=[x] if s == 0 else None,
                        y_mb=[y] if s == pp_n - 1 else None)
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            ths = [threading.Thread(target=run, args=(s, t), daemon=True)
                   for s in range(pp_n) for t in range(tp_n)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(120)
            assert not errs, errs
            losses.append([float(results[(pp_n - 1, t)].losses[0])
                           for t in range(tp_n)])
            for key, res in results.items():
                if pkg == "port":
                    opt.update(ttensor._flat_keys(res.grads),
                               opt_states[key],
                               ttensor._flat_keys(params[key]))
                else:
                    new_p, opt_states[key] = opt.update(
                        res.grads, opt_states[key], params[key])
                    params[key] = jax.tree.map(np.asarray, new_p)
    finally:
        for st in stages.values():
            st.close()
    shards = {key: {p: {n: np.asarray(v) for n, v in lv.items()}
                    for p, lv in tree.items()}
              for key, tree in params.items()}
    return losses, shards


def test_build_tp_stage_fns_pp2_tp2_matches_jax():
    """dp × tp × pp on the host route: the port's pp 2 × tp 2 grid against
    the JAX package's, two steps from the same weights."""
    got_l, got = _tp_grid("port")
    want_l, want = _tp_grid("jax")
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for key, tree in want.items():
        assert set(got[key]) == set(tree)
        for p, lv in tree.items():
            for n, v in lv.items():
                np.testing.assert_allclose(got[key][p][n], v, rtol=1e-5,
                                           atol=2e-6, err_msg=f"{key} {p}.{n}")
