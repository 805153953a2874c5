#!/usr/bin/env python3
"""Time an apiserver binary's write path on north_star's objects.

Each turn starts ``python -m <module> --port N`` (default flags) as a
process of its own and, through the port's HTTP client, creates
north_star's 5,000 nodes and 8 services and its 10,000 resident pods
unbound from ``--threads`` threads, then binds those pods with
``bindings:batch`` in batches of 1,024 (a scheduler wave's commit), and
fails unless every bind succeeded and a list reads every pod back bound.
With several ``--module`` values the turns alternate in the order a, b,
b, a, ... so each binary runs first in half the pairs. Prints one JSON
line (each turn's creates/s and binds/s, each module's medians, the
card's name and power limit) and writes it to
``chiprun_out/apiserver_time.json``.

    PYTHONPATH=. python3 kubernetes_tpu_torch/tools/apiserver_time.py \\
        --module kubernetes_tpu_torch.cmd.apiserver --turns 2

Needs no card: the apiserver is host code. ``--nodes`` shrinks the
cluster for a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.http import HTTPTransport
from kubernetes_tpu_torch.models.fixtures import build_cluster
from kubernetes_tpu_torch.runtime.clone import deep_clone

BATCH = 1_024


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not measured"
    except OSError:
        return "not measured"


def _start(module: str, log_path: str):
    port = _free_port()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", module, "--port",
                                 str(port)], stdout=log,
                                stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    client = Client(HTTPTransport(url, timeout=60.0))
    deadline = time.monotonic() + 120
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"{module} exited with {proc.returncode}")
        try:
            client.nodes().list()
            return proc, client
        except OSError:
            if time.monotonic() > deadline:
                proc.kill()
                raise
            time.sleep(0.1)


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def turn(module: str, n_nodes: int, threads: int, log_path: str) -> dict:
    """One apiserver process, seeded and bound once -> its rates."""
    nodes, existing, _pending, services = build_cluster(n_nodes, 0)
    unbound = []
    for p in existing:
        q = deep_clone(p)
        q.spec.host = q.status.host = ""
        unbound.append(q)
    proc, client = _start(module, log_path)
    try:
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda n: client.nodes().create(n), nodes))
            for svc in services:
                client.services(svc.metadata.namespace).create(svc)
            nodes_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            list(pool.map(lambda p: client.pods().create(p), unbound))
            pods_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for k in range(0, len(existing), BATCH):
            res = client.pods().bind_many(api.BindingList(items=[
                api.Binding(metadata=api.ObjectMeta(
                    name=p.metadata.name, namespace=p.metadata.namespace),
                    pod_name=p.metadata.name, host=p.spec.host)
                for p in existing[k:k + BATCH]]))
            bad = [r for r in res.items if r.error]
            if bad:
                raise AssertionError(f"{module}: bind failed: {bad[0]}")
        bind_s = time.perf_counter() - t0
        final = client.pods("").list().items
    finally:
        _stop(proc)
    if len(final) != len(existing) or any(not p.spec.host for p in final):
        raise AssertionError(f"{module}: pods not read back bound")
    n_creates = len(nodes) + len(services) + len(existing)
    return {"module": module, "nodes": len(nodes), "pods": len(existing),
            "threads": threads, "nodes_s": nodes_s, "pods_s": pods_s,
            "bind_s": bind_s,
            "creates_per_s": n_creates / (nodes_s + pods_s),
            "binds_per_s": len(existing) / bind_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--module", action="append", required=True,
                    help="an apiserver binary to run with python -m "
                         "(repeat to alternate several)")
    ap.add_argument("--turns", type=int, default=2,
                    help="turns per module")
    ap.add_argument("--nodes", type=int, default=5_000)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    mods = args.module
    order = []
    for i in range(args.turns):
        order += mods if i % 2 == 0 else mods[::-1]
    os.makedirs("chiprun_out", exist_ok=True)
    runs = []
    for i, m in enumerate(order):
        r = turn(m, args.nodes, args.threads,
                 os.path.join("chiprun_out", f"apiserver_time_{i}.log"))
        runs.append(r)
        print(f"turn {i} {m}: {r['creates_per_s']:.1f} creates/s, "
              f"{r['binds_per_s']:.1f} binds/s", file=sys.stderr, flush=True)
    medians = {m: {k: statistics.median(r[k] for r in runs
                                        if r["module"] == m)
                   for k in ("creates_per_s", "binds_per_s")}
               for m in mods}
    record = {"card": _card(), "runs": runs, "medians": medians}
    with open(os.path.join("chiprun_out", "apiserver_time.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
