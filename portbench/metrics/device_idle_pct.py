"""The share of the waves' time in which the profiler shows no kernel,
copy or memset on the card, in percent."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr.waves:
        return None
    window = sum(e - s for s, e in tr.waves)
    busy = sum(tr.busy_s)
    return 100 * (1 - busy / window) if busy > 0 else None
