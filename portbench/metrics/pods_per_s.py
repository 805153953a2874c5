"""Every pod decided in the window over the window's time: the sum of the
waves' pods over the sum of the waves' times."""


def read(rec):
    waves = rec["waves"]
    return sum(w["pods"] for w in waves) / sum(w["wave_s"] for w in waves)
