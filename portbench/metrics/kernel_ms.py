"""Device time of the kernels whose names begin ``commit_solve``, mean
milliseconds a wave, from the profiler's trace. Nothing without a trace
or without such a kernel in it."""


def kernel_s(per_wave: dict) -> float:
    return sum(s for k, s in per_wave.items() if k.startswith("commit_solve"))


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr.waves:
        return None
    total = sum(kernel_s(k) for k in tr.kernels)
    return total / len(tr.waves) * 1e3 if total > 0 else None
