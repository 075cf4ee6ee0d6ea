"""The port's serving gateway and backend registry
(``tpu_dist_torch.serve.Gateway``, ``Frontend(store=)``,
``register_backend``/``list_backends``) against the JAX package's: the
port's gateway in front of a JAX ``Frontend`` and the JAX gateway in front
of a port ``Frontend(store=)``, each resolving its backend through the
other package's registry entries in one control-plane store; the tokens
equal JAX ``generate`` on the same weights (carried by
``interop.load_jax_params``); the ``stats`` frames of ``collect_stats``
have the same layout either way; a submit with no backend fails with
``BackendUnavailableError``, one whose backend dies with
``BackendGoneError``; and least-outstanding routing spreads requests over
two backends.

The tiny model (vocab 251, dim 64, depth 2, heads 2, ``max_seq_len`` 64)
carries the weights of JAX ``model.init(jax.random.key(0))``.  Every
socket and every wait has its own timeout."""

import time

import jax
import numpy as np
import pytest

from tpu_dist import serve as jserve
from tpu_dist.dist import store as jstore
from tpu_dist.models import TransformerLM as JaxLM
from tpu_dist.serve import frontend as jfrontend
from tpu_dist_torch import serve
from tpu_dist_torch.dist import store as tstore
from tpu_dist_torch.interop import load_jax_params
from tpu_dist_torch.models import TransformerLM as TorchLM
from tpu_dist_torch.serve import frontend

pytestmark = pytest.mark.serve

CFG = dict(vocab_size=251, dim=64, depth=2, num_heads=2, max_seq_len=64)


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.key(0))
    tree = {p: {k: np.asarray(v) for k, v in leaves.items()}
            for p, leaves in params.items()}
    return jm, params, load_jax_params(TorchLM(**CFG, device="cpu"), tree)


def _jax_ref(jm, params, prompt, n):
    out = jm.generate(params, np.asarray(prompt)[None], n)
    return np.asarray(out)[0, len(prompt):].tolist()


def _requests(seed, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 251, int(rng.integers(3, 12))).tolist(),
             int(rng.integers(2, 8))) for _ in range(n)]


class _Backend:
    """A serving backend of either package registered in ``store``."""

    def __init__(self, pkg, lm, store, name="default", slots=4):
        jm, params, tm = lm
        if pkg == "jax":
            self.sched = jserve.Scheduler(
                jserve.SlotEngine(jm, params, num_slots=slots),
                batch_window=0.002)
            self.fe = jserve.Frontend(self.sched, port=0, store=store,
                                      backend_name=name)
        else:
            self.sched = serve.Scheduler(
                serve.SlotEngine(tm, num_slots=slots, device="cpu"),
                batch_window=0.002)
            self.fe = serve.Frontend(self.sched, port=0, store=store,
                                     backend_name=name)

    def close(self):
        self.fe.close()
        self.sched.close()


@pytest.fixture
def stores():
    """One control-plane server (the port's) and a client of each
    package to it."""
    server = tstore.TCPStore(is_master=True, timeout=10)
    theirs = jstore.TCPStore("127.0.0.1", server.port, timeout=10)
    yield server, theirs
    theirs.close()
    server.close()


@pytest.mark.parametrize("gateway,backend", [("port", "jax"),
                                             ("jax", "port")],
                         ids=["port-gateway-jax-frontend",
                              "jax-gateway-port-frontend"])
def test_gateway_fronts_the_other_packages_frontend(lm, stores, gateway,
                                                     backend):
    jm, params, _ = lm
    ours, theirs = stores
    be = _Backend(backend, lm, theirs if backend == "jax" else ours)
    gw_store = ours if gateway == "port" else theirs
    gw = (serve.Gateway(host="127.0.0.1", port=0, store=gw_store,
                        backend_timeout=10) if gateway == "port" else
          jfrontend.Gateway(host="127.0.0.1", port=0, store=gw_store,
                            backend_timeout=10))
    client_cls = serve.ServeClient if gateway == "jax" else \
        jserve.ServeClient
    try:
        # the registry reads alike through either package
        want = {"default": be.fe.addr}
        assert frontend.list_backends(ours) == want
        assert jfrontend.list_backends(theirs) == want
        assert ours.get(frontend.GATEWAY_KEY).decode() == gw.addr
        with client_cls("127.0.0.1", gw.port, connect_retry=10) as cli:
            reqs = _requests(3)
            handles = [cli.submit(p, max_new_tokens=n) for p, n in reqs]
            for (p, n), h in zip(reqs, handles):
                assert h.wait_done(120.0) == _jax_ref(jm, params, p, n)
            st = cli.stats(timeout=30.0)
        assert set(st) == {"gateway", "backends"}
        assert set(st["gateway"]) == {"default"}
        assert set(st["gateway"]["default"]) == {"addr", "inflight"}
        assert st["gateway"]["default"]["inflight"] == 0
        assert st["backends"]["default"]["backend"] == "default"
        assert st["backends"]["default"]["completed"] == len(reqs)
    finally:
        gw.close()
        be.close()


def test_stats_frames_match_the_jax_gateway(lm, stores):
    """``collect_stats`` of either gateway over the same port backend:
    the same keys at every level."""
    ours, theirs = stores
    be = _Backend("port", lm, ours)
    gws = [serve.Gateway(host="127.0.0.1", port=0, store=ours),
           jfrontend.Gateway(host="127.0.0.1", port=0, store=theirs)]
    try:
        shapes = []
        for gw in gws:
            gw.pick_link(time.monotonic() + 10)
            st = gw.collect_stats(timeout=10)
            shapes.append((sorted(st), sorted(st["gateway"]["default"]),
                           sorted(st["backends"]["default"])))
        assert shapes[0] == shapes[1]
    finally:
        for gw in gws:
            gw.close()
        be.close()


def test_no_backend_is_a_named_error(stores):
    ours, _ = stores
    gw = serve.Gateway(host="127.0.0.1", port=0, store=ours,
                       backend_timeout=0.5)
    try:
        with serve.ServeClient("127.0.0.1", gw.port, connect_retry=10) as c:
            with pytest.raises(serve.RequestFailedError) as e:
                c.submit([1, 2, 3], max_new_tokens=2).wait_done(30.0)
            assert e.value.error == "BackendUnavailableError"
    finally:
        gw.close()


def test_backend_death_mid_request_is_backend_gone(lm, stores):
    ours, _ = stores
    be = _Backend("port", lm, ours, slots=1)
    gw = serve.Gateway(host="127.0.0.1", port=0, store=ours,
                       backend_timeout=2)
    try:
        with serve.ServeClient("127.0.0.1", gw.port, connect_retry=10) as c:
            h = c.submit(list(range(1, 9)), max_new_tokens=50)
            next(iter(h.iter_tokens(timeout=60.0)))
            be.close()
            with pytest.raises(serve.RequestFailedError) as e:
                h.wait_done(30.0)
            assert e.value.error == "BackendGoneError"
            # the next submit finds no backend: named, bounded
            with pytest.raises(serve.RequestFailedError) as e:
                c.submit([1, 2], max_new_tokens=2).wait_done(30.0)
            assert e.value.error == "BackendUnavailableError"
            # a new incarnation under the same name serves the same tokens
            be = _Backend("port", lm, ours, slots=1)
            jm, params, _ = lm
            got = c.submit([5, 6, 7], max_new_tokens=4).wait_done(60.0)
            assert got == _jax_ref(jm, params, [5, 6, 7], 4)
    finally:
        gw.close()
        be.close()


def test_least_outstanding_routing_over_two_backends(lm, stores):
    """Two replicas, one of each package, registered under their own
    names: four long requests in flight at once land two on each."""
    jm, params, _ = lm
    ours, theirs = stores
    bes = [_Backend("port", lm, ours, name="replica0", slots=2),
           _Backend("jax", lm, theirs, name="replica1", slots=2)]
    gw = serve.Gateway(host="127.0.0.1", port=0, store=ours)
    try:
        assert frontend.list_backends(ours) == {
            "replica0": bes[0].fe.addr, "replica1": bes[1].fe.addr}
        gw._dial_new()
        with serve.ServeClient("127.0.0.1", gw.port, connect_retry=10) as c:
            reqs = [(list(range(1 + i, 6 + i)), 40) for i in range(4)]
            hs = [c.submit(p, max_new_tokens=n) for p, n in reqs]
            for (p, n), h in zip(reqs, hs):
                assert h.wait_done(120.0) == _jax_ref(jm, params, p, n)
        done = [b.sched.engine.stats()["completed"] for b in bes]
        assert done == [2, 2]
    finally:
        gw.close()
        for b in bes:
            b.close()
