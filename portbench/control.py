"""The readings the check's limits are set from, taken through the
harness's own run and comparison, at a cell's own size.

    python3 portbench/control.py --workload north_star.burst \
        --seed 5000000001 --seeds 12 --faults 3 --seconds 6

For each of ``--seeds`` seeds (``--seed``, ``--seed`` + 1, ...) it runs
the cell through ``harness.run_cell`` with a window of ``--seconds`` and
records the numbers the check compares: the lower readings. On the first
``--faults`` seeds it runs the cell again with each of ``PLANTED`` under
``batch_solver.solve``, and records the same numbers: the upper readings.

- ``block32``, the control: the plain reference in the program's place,
  each block of 32 pods decided against the state at the block's start
  (decisions made in parallel, the step that would tempt a faster
  solver; it breaks the sequential commit the configuration states);
- ``state_unchanged``: the reference in the program's place, every pod
  decided against the wave's initial state (a step that returns its
  state unchanged);
- ``half_left_out``: the program, the second half of each wave left
  undecided;
- ``answer_altered``: the program, one decision a wave moved to the next
  node.

Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness, manifest  # noqa: E402
from portbench.reference import scheduler as reference  # noqa: E402

PLANTED = ("block32", "state_unchanged", "half_left_out", "answer_altered")


@contextlib.contextmanager
def planted(which: str):
    """``batch_solver.solve`` replaced by ``which`` while the block runs.
    The reference in the program's place reads the plain description of
    the burst the generator made last, which is the burst being solved."""
    from kubernetes_tpu_torch.models import batch_solver as bs

    real_solve, real_module = bs.solve, manifest.module
    last = {}

    def module(kind, name):
        mod = real_module(kind, name)
        if kind == "generators":
            make = mod.wave

            def wave(base, *args):
                burst = make(base, *args)
                last["cluster"], last["wave"] = base.plain, burst.plain
                return burst
            mod.wave = wave
        return mod

    def solve(snap, **kw):
        if which in ("block32", "state_unchanged"):
            wave = last["wave"]
            block = 32 if which == "block32" else len(wave.keys)
            chosen = reference.solve(last["cluster"], wave,
                                     commit_block=block)[0]
            return chosen, np.zeros(len(chosen), np.int64)
        chosen, scores = real_solve(snap, **kw)
        chosen = np.array(chosen, copy=True)
        if which == "half_left_out":
            chosen[len(chosen) // 2:] = -1
        else:
            i = int(np.flatnonzero(chosen >= 0)[0])
            chosen[i] = (chosen[i] + 1) % snap.n_nodes
        return chosen, scores

    bs.solve, manifest.module = solve, module
    try:
        yield
    finally:
        bs.solve, manifest.module = real_solve, real_module


def readings(name: str, seed: int, seeds: int, faults: int,
             seconds: float, device: str = "cuda", overrides=None,
             log=print) -> dict:
    """-> {"program": [checks of each seed], <planted>: [...], ...}."""

    def run(s):
        r = harness.run_cell(name, s, seconds, False, time.perf_counter(),
                             device=device, overrides=overrides, log=log)
        return {k: c["value"] for k, c in r["checks"].items()} | {
            "correct": r["correct"]}

    out = {"cell": name, "seeds": list(range(seed, seed + seeds)),
           "program": []}
    for s in out["seeds"]:
        out["program"].append(run(s))
    for which in PLANTED:
        with planted(which):
            out[which] = [run(s) for s in out["seeds"][:faults]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = readings(args.workload, args.seed, args.seeds, args.faults,
                   args.seconds)
    res["seconds"] = time.perf_counter() - t0
    text = json.dumps(res)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
