"""Mean time of ``batch_solver.solve`` a wave (host inputs, ship, prolog,
kernel, readback, gang post-pass), from the harness's span."""


def read(rec):
    waves = rec["waves"]
    return sum(w["solve_s"] for w in waves) / len(waves) * 1e3
