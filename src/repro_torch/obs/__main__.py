"""``python -m repro_torch.obs`` — read traced fits from the command line.

Port of `repro/obs/__main__.py`, with the same output:

  summarize DIR     one JSON summary of a trace directory (rounds,
                    k-scans, span timings, first-seen round keys,
                    utilization)
  tail DIR [-n N]   the last N merged events, one JSON line each
  merge DIR [-o F]  merge per-process files into one time-ordered
                    JSONL stream (stdout or -o FILE)

Pure reader: imports no torch, touches no devices, and reads a directory
written by either package.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.trace import read_events, summarize, tail_events


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="summarize / tail / merge repro trace directories")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("summarize", help="aggregate a trace directory")
    ps.add_argument("trace_dir")

    pt = sub.add_parser("tail", help="last N merged events")
    pt.add_argument("trace_dir")
    pt.add_argument("-n", type=int, default=20, metavar="N")

    pm = sub.add_parser("merge",
                        help="merged time-ordered JSONL event stream")
    pm.add_argument("trace_dir")
    pm.add_argument("-o", "--out", default=None,
                    help="write to FILE instead of stdout")

    args = p.parse_args(argv)
    try:
        if args.cmd == "summarize":
            print(json.dumps(summarize(read_events(args.trace_dir)),
                             indent=2, sort_keys=True))
        elif args.cmd == "tail":
            for e in tail_events(args.trace_dir, args.n):
                print(json.dumps(e, separators=(",", ":")))
        elif args.cmd == "merge":
            events = read_events(args.trace_dir)
            out = (open(args.out, "w", encoding="utf-8")
                   if args.out else sys.stdout)
            try:
                for e in events:
                    out.write(json.dumps(e, separators=(",", ":")) + "\n")
            finally:
                if args.out:
                    out.close()
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
