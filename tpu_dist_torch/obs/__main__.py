"""``python -m tpu_dist_torch.obs`` — merge flight-recorder dumps, diagnose hangs.

Subcommands (all read the dump directory, default ``TPU_DIST_OBS_DIR``):

- ``merge``     per-rank dumps → one Chrome ``trace_event`` JSON timeline
  (open in chrome://tracing or ui.perfetto.dev); one track per rank,
  collectives aligned by their lockstep sequence numbers.
- ``diagnose``  print which rank is behind, at which collective sequence
  number and call-site, and which ranks were already waiting on it.
  Exit code: 0 healthy, 1 no dumps, 3 hang found (scriptable).
- ``show``      print one rank's recent events (quick look without a UI).

The dumps and this CLI are the JAX package's (``python -m tpu_dist.obs``):
either reads the other's dumps.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import trace as _trace
from .recorder import default_dump_dir


def _add_common(p):
    p.add_argument("--dir", default=None,
                   help="dump directory (default: TPU_DIST_OBS_DIR)")
    p.add_argument("--generation", type=int, default=None,
                   help="gang generation to read (default: newest present)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.obs", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge per-rank dumps into a Chrome "
                                      "trace_event JSON timeline")
    _add_common(mp)
    mp.add_argument("--out", default="-",
                    help="output path ('-' = stdout, the default)")
    dp = sub.add_parser("diagnose", help="name the straggler rank, its "
                                         "collective seq and call-site")
    _add_common(dp)
    dp.add_argument("--json", action="store_true",
                    help="machine-readable diagnosis")
    sp = sub.add_parser("show", help="print one rank's recent events")
    _add_common(sp)
    sp.add_argument("--rank", type=int, default=None,
                    help="rank to show (default: every rank)")
    sp.add_argument("-n", type=int, default=20,
                    help="events per rank (default 20)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    where = args.dir or default_dump_dir()
    dumps = _trace.read_dumps(where, generation=args.generation)
    if not dumps:
        sys.stderr.write(f"no flight-recorder dumps found in {where}\n")
        return 1

    if args.cmd == "merge":
        obj = _trace.merge_trace(dumps)
        if args.out == "-":
            json.dump(obj, sys.stdout)
            sys.stdout.write("\n")
        else:
            with open(args.out, "w") as f:
                json.dump(obj, f)
        n_ev = sum(len(d["events"]) for d in dumps)
        sys.stderr.write(
            f"merged {len(dumps)} rank(s), {n_ev} events "
            f"(generation {dumps[0].get('generation', 0)})"
            + (f" -> {args.out}" if args.out != "-" else "") + "\n")
        return 0

    if args.cmd == "diagnose":
        diag = _trace.diagnose(dumps)
        if args.json:
            # the JAX package's versioned envelope, so scripts read
            # .diagnosis from either package's tool
            doc = {"version": 1, "tool": "diagnose", "path": where,
                   "generation": dumps[0].get("generation", 0),
                   "ranks": sorted(d.get("rank", -1) for d in dumps),
                   "diagnosis": diag}
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            print(_trace.render_diagnosis(diag))
        ok = diag.get("verdict") == "healthy" or (
            # no collectives recorded is only benign when every rank
            # dumped through a clean exit, not a crash/signal path
            diag.get("verdict") == "no-collectives"
            and diag.get("clean_exit"))
        return 0 if ok else 3

    # show
    for d in dumps:
        if args.rank is not None and d.get("rank") != args.rank:
            continue
        print(f"== rank {d.get('rank')} (generation "
              f"{d.get('generation', 0)}, reason {d.get('reason')!r}, "
              f"{len(d['events'])} events) ==")
        for e in d["events"][-args.n:]:
            coll = f" coll#{e['coll']}" if e.get("coll") is not None else ""
            site = f" at {e['site']}" if e.get("site") else ""
            print(f"  #{e.get('seq')} [{e.get('kind')}] {e.get('op')}"
                  f"{coll} {e.get('outcome')}{site}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
