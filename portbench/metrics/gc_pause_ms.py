"""The cyclic collector's pauses inside waves, mean milliseconds a wave,
from ``gc.callbacks``."""


def read(rec):
    waves = rec["waves"]
    return sum(w["gc_s"] for w in waves) / len(waves) * 1e3
