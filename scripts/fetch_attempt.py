#!/usr/bin/env python
"""Attempt to fetch real datasets (OGB / SuiteSparse) and record the
outcome — the per-round evidence trail for why the sweep runs on
synthetic structure (no network is an environment fact, recorded
each time it is retried).

Appends one line per attempt to ``sweep_logs/fetch_attempts.log``.
"""
from __future__ import annotations

import datetime
import os
import socket
import sys
import urllib.request

TARGETS = {
    "ogbn-arxiv": ("http://snap.stanford.edu/ogb/data/nodeproppred/"
                   "arxiv.zip"),
    "suitesparse-index": ("https://sparse.tamu.edu/files/"
                          "ssstats.csv"),
    "suitesparse-chesapeake": ("https://suitesparse-collection-website."
                               "herokuapp.com/MM/DIMACS10/"
                               "chesapeake.tar.gz"),
}


def attempt(name: str, url: str, timeout: float = 8.0) -> str:
    try:
        req = urllib.request.Request(url, method="HEAD")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return f"OK status={r.status}"
    except Exception as e:
        return f"FAIL {type(e).__name__}: {str(e)[:120]}"


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "sweep_logs"
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, "fetch_attempts.log")
    socket.setdefaulttimeout(8.0)
    stamp = datetime.datetime.now(datetime.timezone.utc).isoformat()
    lines = []
    for name, url in TARGETS.items():
        res = attempt(name, url)
        lines.append(f"{stamp} {name} {url} -> {res}")
        print(lines[-1])
    with open(log, "a") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
