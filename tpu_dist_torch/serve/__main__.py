"""``python -m tpu_dist_torch.serve gateway`` — run the client-facing
gateway role (counterpart of ``tpu_dist/serve/__main__.py``).

The launcher's ``--serve`` flag spawns exactly this process beside the
model ranks: it owns the stable public port, resolves the current backends
through the control-plane store (``TPU_DIST_STORE_ADDR``, the launcher's
contract), and keeps client traffic flowing across supervised model-rank
restarts.  Used alone (no store) it takes ``--backend host:port``.  It
touches no device.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpu_dist_torch.serve")
    sub = p.add_subparsers(dest="role", required=True)
    g = sub.add_parser("gateway", help="client-facing proxy role")
    g.add_argument("--host", default="0.0.0.0")
    g.add_argument("--port", type=int, default=0,
                   help="client-facing port (0 = ephemeral, printed)")
    g.add_argument("--backend", default=None,
                   help="host:port of the model rank's frontend (default: "
                        "resolve via the control-plane store)")
    g.add_argument("--backend_timeout", type=float, default=60.0,
                   help="seconds a submit may wait for a (re)starting "
                        "backend before failing with a named error")
    args = p.parse_args(argv)

    from .frontend import Gateway, store_from_env
    store = store_from_env()
    if store is None and args.backend is None:
        sys.stderr.write("gateway needs --backend or TPU_DIST_STORE_ADDR\n")
        return 2
    gw = Gateway(host=args.host, port=args.port, store=store,
                 backend=args.backend, backend_timeout=args.backend_timeout)
    print(f"[tpu_dist_torch.serve] gateway listening on {gw.addr}",
          flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    while not stop.wait(0.5):
        pass
    gw.close()
    if store is not None:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
