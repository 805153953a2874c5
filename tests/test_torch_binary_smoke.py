"""chip_smoke.py's phases 9 and 9b at a small size, on the plain version.

Phase 9 seeds a cluster through the port's HTTP client into the port's
apiserver (a separate process), watching every create, runs the port's scheduler
binary in a thread with ``--device cpu --prewarm`` and checks every bind,
capacity and host port, and each wave against solve(encode_snapshot(...))
of its state; phase 9b runs the binary as a process whose Policy forces
the fallback to serial and checks each placement against the port's
GenericScheduler. Launches are not counted here (the plain version runs
instead of the kernel).
"""

import chip_smoke


def test_chip_smoke_binary_phases_run_on_the_cpu():
    b = chip_smoke._binary_phase("cpu", n_nodes=40, n_pending=240,
                                 seeders=4, creators=2,
                                 count_launches=False)
    assert b["pending"] == 240 and b["waves"]
    assert sum(w["bound"] for w in b["waves"]) == 240
    assert b["prewarm_s"] is not None and b["health"]["healthy"] is True
    assert b["window_start_s"] < b["window_end_s"]
    assert b["creates_per_s"] > 0
    f = chip_smoke._fallback_phase("cpu", n_nodes=20, n_pending=60)
    assert "falling back to serial" in f["fallback_line"]
    assert f["pending"] == 60
