"""Seconds per unit of the dense dual-Schur factor: K's builds and Sigma's
refreshes, from the program's synchronised phases ``ldu/sigma_K`` and
``ldu/sigma_refresh`` over the traced window."""


def read(rec):
    t = rec.counters.get("sigma_factor_s")
    return sum(t) / len(t) if t else None
