"""Share of the profiled slice's wall time in which no operation ran on
the device: 1 - busy_s / window_s."""


def read(rec):
    p = rec.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
