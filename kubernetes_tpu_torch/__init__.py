"""kubernetes_tpu_torch — the PyTorch/CUDA port of the batch scheduler.

The JAX package ``kubernetes_tpu`` is the reference; this package runs the
same scheduling wave (encode -> sequential-commit solve -> node names) on
an NVIDIA H100, with the solve in a hand-written CUDA kernel
(``ops/csrc/commit_solve.cuh``), and the host code around it: the
scheduler's loops and binary, the solver daemon and the apiserver
(``cmd/apiserver.py``). It imports torch and numpy, never jax, and
nothing of ``kubernetes_tpu``: every module it needs is copied here under
the reference's own path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
CPU runs each kernel's plain PyTorch version.
"""

# Race-probe hook — the -race build flag analog (ref: hack/test-go.sh:50).
# With KTPU_RACE set, forcing a ~1us thread switch interval HERE means
# every component binary the port spawns (cmd.apiserver, cmd.solverd,
# cmd.scheduler) runs under the same aggressive preemption as the process
# that spawned it, so server-side check-then-act races are probed too.
# No-op unless KTPU_RACE is set.
import os as _os

if _os.environ.get("KTPU_RACE"):
    import sys as _sys

    _sys.setswitchinterval(1e-6)

    # Lock-order sanitizer (util/locksmith.py), armed in every process
    # that imports the package under the flag. A child has no test-session
    # hook, so cycles are reported at interpreter exit on stderr (exit
    # code untouched: the parent's own locksmith run is the gating one).
    import atexit as _atexit

    from kubernetes_tpu_torch.util import locksmith as _locksmith

    _locksmith.arm()

    def _locksmith_exit_report() -> None:
        reps = _locksmith.reports()
        if reps:
            print("[locksmith] potential deadlocks in this process:",
                  file=_sys.stderr)
            for _r in reps:
                print(_locksmith.format_report(_r), file=_sys.stderr)

    _atexit.register(_locksmith_exit_report)
