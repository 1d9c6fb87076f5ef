"""Mean device milliseconds of a block-LDU apply, by CUDA events around
each ``solvers.ldu_apply`` call of the traced window."""


def read(rec):
    t = rec.spans.get("ldu_apply")
    return 1e3 * sum(t) / len(t) if t else None
