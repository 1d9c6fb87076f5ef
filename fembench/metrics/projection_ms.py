"""Milliseconds per volume projection (the bisection of the latent's
shift), from the program's synchronised phase ``topopt/volume`` over the
traced window."""


def read(rec):
    n = sum(rec.counters.get("projections", []))
    return 1e3 * sum(rec.counters["projection_s"]) / n if n else None
