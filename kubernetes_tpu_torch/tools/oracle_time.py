"""Wall time of the serial oracle's ``solve_serial`` on the north_star
cluster (5,000 nodes, 10,000 bound pods, 8 services) for the first K
pending pods, on this host's CPU. ``chip_smoke.py`` phase 11b holds the
kernel against the oracle on the largest K that stays within a time
limit; this script is how that K is chosen.

    PYTHONPATH=. python3 kubernetes_tpu_torch/tools/oracle_time.py 256 288
    PYTHONPATH=. python3 kubernetes_tpu_torch/tools/oracle_time.py \\
        --limit-s 60 --repeats 3 256 272 288

Prints one JSON line per K (its seconds for each repeat and their
median) and, with ``--limit-s``, the largest K whose median is within
the limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pods", nargs="+", type=int, help="values of K")
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--pending", type=int, default=10_000)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--limit-s", type=float, default=None)
    args = ap.parse_args(argv)

    from kubernetes_tpu_torch.models import oracle
    from kubernetes_tpu_torch.models.fixtures import build_cluster

    nodes, existing, pending, services = build_cluster(args.nodes,
                                                       args.pending)
    fits = []
    for k in args.pods:
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            oracle.solve_serial(nodes, existing, pending[:k], services)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(json.dumps({"nodes": args.nodes, "existing": len(existing),
                          "k": k, "seconds": times, "median_s": med,
                          "cpus": os.cpu_count()}), flush=True)
        if args.limit_s is not None and med <= args.limit_s:
            fits.append(k)
    if args.limit_s is not None:
        print(json.dumps({"limit_s": args.limit_s,
                          "largest_k": max(fits) if fits else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
