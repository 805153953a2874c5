"""Process start to the first timed wave: imports, the CUDA context, the
kernel library (built on a checkout's first run), the base cluster and
one warm wave of the cell's shape."""


def read(rec):
    return rec["setup_s"]
