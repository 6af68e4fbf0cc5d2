#!/usr/bin/env python3
"""Compare the output digests of two ``chip_smoke.py`` runs, phase by phase.

    python3 scripts/smoke_digests.py parent.txt change.txt [--phases 3-15]

Each phase prints the sha256 digests of its outputs (16 hex digits) on its
own ``[N ...]`` lines; the kernels equal their plain versions bit for bit,
so two commits whose kernels compute the same bits print the same digests.
This prints the digests each phase printed in each run and whether they
are equal, and exits non-zero if any phase in the range differs or printed
none in either run.
"""

from __future__ import annotations

import argparse
import re
import sys

DIGEST = re.compile(r"\b[0-9a-f]{16}\b")
PHASE = re.compile(r"^\[(\d+)[ \]]")


def digests(path: str) -> dict:
    """{phase: [digests in the order printed]} of a chip_smoke output (the
    hex strings on lines that say "digest")."""
    out: dict = {}
    with open(path, errors="replace") as f:
        for line in f:
            m = PHASE.match(line)
            if m and "digest" in line:
                out.setdefault(int(m.group(1)), []).extend(
                    DIGEST.findall(line))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--phases", default="3-15",
                   help="inclusive range of phases to compare")
    args = p.parse_args(argv)
    lo, hi = (int(v) for v in args.phases.split("-"))
    a, b = digests(args.parent), digests(args.change)
    ok = True
    for phase in range(lo, hi + 1):
        da, db = a.get(phase, []), b.get(phase, [])
        if not da and not db:
            continue
        same = da == db and bool(da)
        ok &= same
        print(f"phase {phase}: {len(da)} / {len(db)} digests, "
              f"{'equal' if same else 'DIFFER'}")
        if not same:
            print(f"  parent {da}\n  change {db}")
    print(f"phases {lo}-{hi}: {'all equal' if ok else 'NOT all equal'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
