"""The port's heartbeat watchdog and rendezvous parsing against the JAX
package's: a rank beating through either package's ``Heartbeat`` is read
alike by either package's ``HeartbeatMonitor`` (healthy, silent and named,
never beaten, finished, another generation's, stuck at one step) with the
same ``RankLostError`` text; ``parse_init_method`` resolves the same
``(coordinator, num_processes, process_id)`` or refuses the same
configurations; ``python -m tpu_dist_torch.serve gateway`` needs a backend
or a store.  Deadlines are short and every wait bounded."""

import importlib
import os
import subprocess
import sys
import time

import pytest

from tpu_dist.resilience import heartbeat as jhb
from tpu_dist_torch.dist.store import TCPStore
from tpu_dist_torch.resilience import heartbeat as thb

# the packages' ``dist.rendezvous`` names the function; these are modules
jrdzv = importlib.import_module("tpu_dist.dist.rendezvous")
trdzv = importlib.import_module("tpu_dist_torch.dist.rendezvous")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": thb, "jax": jhb}


@pytest.fixture
def store():
    s = TCPStore(is_master=True, timeout=10)
    yield s
    s.close()


def _poll_until(monitor, pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        lost = monitor.poll()
        if pred(lost):
            return lost
        time.sleep(0.05)
    return monitor.poll()


@pytest.mark.parametrize("beater", ["port", "jax"])
@pytest.mark.parametrize("watcher", ["port", "jax"])
def test_either_monitor_reads_either_heartbeat(store, beater, watcher):
    B, W = PKGS[beater], PKGS[watcher]
    assert B.hb_key(3, 1) == W.hb_key(3, 1) == "tpu_dist/hb/3/1"
    hb = B.Heartbeat(rank=0, store=store, interval=0.05,
                     generation=0).start()
    other = B.Heartbeat(rank=1, store=store, interval=0.05, generation=0)
    # a beat every 0.05 s against a 1.5 s deadline: a loaded host's stalls
    # do not make rank 0 look lost
    mon = W.HeartbeatMonitor(store, 3, timeout=1.5, generation=0,
                             startup_grace=2.0)
    try:
        hb.set_step(4)
        other.start()
        other.set_step(7)
        assert mon.poll() == []
        other.stop(final=False)   # alive no more, no exit beat
        lost = _poll_until(mon, lambda l: len(l) == 2)
        # rank 2 never beat; rank 1 went silent at step 7
        assert sorted(e.rank for e in lost) == [1, 2]
        one = next(e for e in lost if e.rank == 1)
        assert one.last_step == 7 and "heartbeat silent" in str(one)
        assert "last beat: pid=" in str(one) and "step=7" in str(one)
        two = next(e for e in lost if e.rank == 2)
        assert "never published a beat" in str(two)
        # a clean stop's exit beat reads as done, not lost
        hb.stop()
        mon.mark_done(2)
        mon.mark_done(1)
        assert mon.poll() == []
    finally:
        hb.stop()
        other.stop(final=False)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_generation_scoping_and_progress_timeout(store, pkg):
    """A beat of generation 1 does not feed a generation-0 monitor; a rank
    that beats without its step moving is lost by ``progress_timeout``."""
    M = PKGS[pkg]
    stale = thb.Heartbeat(rank=0, store=store, interval=0.05,
                          generation=1).start()
    fresh = thb.Heartbeat(rank=0, store=store, interval=0.05,
                          generation=2).start()
    try:
        stale.set_step(1)
        fresh.set_step(5)
        g0 = M.HeartbeatMonitor(store, 1, timeout=0.3, generation=0,
                                startup_grace=0.3)
        lost = _poll_until(g0, lambda l: bool(l))
        assert [e.rank for e in lost] == [0]
        stuck = M.HeartbeatMonitor(store, 1, timeout=5.0, generation=2,
                                   progress_timeout=0.4)
        lost = _poll_until(stuck, lambda l: bool(l))
        assert "no step progress" in str(lost[0]) and lost[0].last_step == 5
    finally:
        stale.stop()
        fresh.stop()


def test_heartbeat_disabled_without_a_store(monkeypatch):
    monkeypatch.delenv("TPU_DIST_STORE_ADDR", raising=False)
    hb = thb.Heartbeat()
    assert not hb.enabled
    hb.start()
    hb.set_step(1)
    hb.stop()
    with pytest.raises(ValueError, match="timeout"):
        thb.HeartbeatMonitor(None, 1, timeout=0)


ENV_CASES = [
    ({}, None, -1, -1),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4",
      "RANK": "2"}, "env://", -1, -1),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4",
      "RANK": "2"}, None, -1, -1),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "1"}, "env://",
     -1, -1),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1"}, "env://", 3, 1),
    ({}, "tcp://127.0.0.1:23456", 2, 1),
    ({"MASTER_ADDR": "h"}, "env://", -1, -1),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1"}, "env://", -1, -1),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "2"}, "env://",
     -1, -1),
    ({}, "tcp://127.0.0.1:23456", -1, -1),
    ({}, "tcp://nohostport", 2, 0),
    ({}, "file:///tmp/x", 2, 0),
]


@pytest.mark.parametrize("env,method,world,rank", ENV_CASES)
def test_parse_init_method_matches_jax(monkeypatch, env, method, world,
                                       rank):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = []
    for mod in (jrdzv, trdzv):
        try:
            outs.append(("ok", mod.parse_init_method(method, world, rank)))
        except ValueError as e:
            outs.append(("ValueError", str(e).split(" (")[0]))
    assert outs[0][0] == outs[1][0]
    if outs[0][0] == "ok":
        assert outs[0] == outs[1]


def test_generation_reads_the_restart_count(monkeypatch):
    for value, want in (("3", 3), ("", 0), ("x", 0)):
        monkeypatch.setenv("TPU_DIST_RESTART_COUNT", value)
        assert trdzv.generation() == jrdzv.generation() == want


def test_gateway_cli_needs_a_backend_or_a_store():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("TPU_DIST_STORE_ADDR", None)
    r = subprocess.run([sys.executable, "-m", "tpu_dist_torch.serve",
                        "gateway"], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2
    assert "gateway needs --backend or TPU_DIST_STORE_ADDR" in r.stderr
