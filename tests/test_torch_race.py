"""The port's ``KTPU_RACE`` hook (``kubernetes_tpu_torch/__init__.py``),
each case in a child interpreter since the hook runs at import:

- with ``KTPU_RACE=1``, importing the package sets the thread switch
  interval to 1 µs and arms locksmith (``threading.Lock`` hands out
  tracked locks);
- a deliberate AB/BA lock order in such a process prints a
  ``[locksmith]`` report on stderr at exit, and leaves the exit code 0;
- without the variable, neither happens.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys, threading
import kubernetes_tpu_torch
from kubernetes_tpu_torch.util import locksmith
print(sys.getswitchinterval(), locksmith.armed(),
      type(threading.Lock()).__name__)
"""

INVERSION = """
import threading
import kubernetes_tpu_torch
a, b = threading.Lock(), threading.Lock()

def ab():
    with a:
        with b:
            pass

def ba():
    with b:
        with a:
            pass

for fn in (ab, ba):        # one after the other: the order, not a hang
    t = threading.Thread(target=fn)
    t.start()
    t.join()
print("done")
"""


def _run(code: str, race: bool) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "KTPU_RACE"}
    if race:
        env["KTPU_RACE"] = "1"
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_race_flag_sets_the_switch_interval_and_arms_locksmith():
    proc = _run(PROBE, race=True)
    assert proc.returncode == 0, proc.stderr
    interval, armed, lock_type = proc.stdout.split()
    assert float(interval) == 1e-6
    assert armed == "True" and lock_type == "TrackedLock"
    assert "[locksmith]" not in proc.stderr


def test_lock_order_inversion_is_reported_at_exit():
    proc = _run(INVERSION, race=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "done"
    assert "[locksmith] potential deadlocks in this process:" in proc.stderr
    assert "lock-order cycle" in proc.stderr
    # the report carries both acquisition stacks of the cycle
    assert " in ab" in proc.stderr and " in ba" in proc.stderr


def test_without_the_flag_nothing_is_armed_or_reported():
    proc = _run(PROBE, race=False)
    assert proc.returncode == 0, proc.stderr
    interval, armed, lock_type = proc.stdout.split()
    assert float(interval) == sys.getswitchinterval()
    assert armed == "False" and lock_type != "TrackedLock"
    inv = _run(INVERSION, race=False)
    assert inv.returncode == 0 and "[locksmith]" not in inv.stderr


def test_chip_smoke_race_phase_runs_on_the_cpu():
    """chip_smoke.py phase 12 at a small size with ``--device cpu``: both
    binaries under KTPU_RACE=1 and KTPU_DEBUG=1 bind every pod through
    load and churn, exit cleanly, and print no locksmith report and no
    failed check; the scheduler's waves solved on the CPU."""
    import chip_smoke
    r = chip_smoke._race_binary_phase("cpu", n_nodes=30, n_pending=150,
                                      n_deleted=15, n_added=30, seeders=2)
    assert r["solves"]["cpu"] > 0 and r["solves"]["cuda"] == 0
    assert r["pods_per_s"] > 0
