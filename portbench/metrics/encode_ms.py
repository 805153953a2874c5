"""Mean time of ``encode_snapshot`` a wave, from the harness's span."""


def read(rec):
    waves = rec["waves"]
    return sum(w["encode_s"] for w in waves) / len(waves) * 1e3
