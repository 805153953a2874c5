"""The commit_solve kernel's share of its roofline, in percent: over the
waves checked against the reference, the sum of each wave's least time
(metrics/_roofline.py, with the reference's count of feasible pairs) over
the sum of its kernel time from the profiler's trace."""

from portbench import manifest

_roofline = manifest.module("metrics", "_roofline")
_kernel = manifest.module("metrics", "kernel_ms")


def read(rec):
    tr = rec.get("trace")
    if tr is None or len(tr.kernels) != len(rec["waves"]):
        return None
    least = spent = 0.0
    for c in rec["compared"]:
        t = _kernel.kernel_s(tr.kernels[c["index"]])
        if t <= 0:
            continue
        d = _roofline.dims(c["cluster"], c["wave"])
        least += _roofline.bound(d, c["feasible_pairs"])[0] * 1e-3
        spent += t
    return least / spent * 100 if spent > 0 else None
