"""CLI: ``python -m repro_torch.obs summarize RUN.jsonl [--json OUT.json]``.

Host-only (stdlib + numpy): run logs are read on machines without a card.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.summary import summarize_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="render a run-log report")
    s.add_argument("runlog", help="path to RUN.jsonl")
    s.add_argument("--json", default=None, help="also write the summary dict")
    args = ap.parse_args(argv)

    try:
        text, data = summarize_path(args.runlog)
    except OSError as e:
        print(f"cannot read {args.runlog}: {e}", file=sys.stderr)
        return 2
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(data, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
