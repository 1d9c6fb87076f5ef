"""Mean device milliseconds of a V-cycle from the finest level, by CUDA
events around each ``vcycle(0, ...)`` call of the traced window."""


def read(rec):
    t = rec.spans.get("vcycle0")
    return 1e3 * sum(t) / len(t) if t else None
