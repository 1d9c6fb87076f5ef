"""Share of the roofline of the element-Jacobian calls: the frozen least
time of one call (``counts/jacobian.py``) over the device time of all
operations the calls of the profiled slice ran, per call."""

import harness


def read(rec):
    p = rec.profile
    if not p or p["device_s"] <= 0:
        return None
    counts = harness.load_module("counts", "jacobian")
    least, _ = counts.least_seconds(rec.cfg, rec.cfg["precision"]["assemble"])
    return 100.0 * least / (p["device_s"] / p["units"])
