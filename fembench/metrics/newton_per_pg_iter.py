"""Newton iterations per PG iteration over the traced window, from
``PGResult.newton_iters``."""


def read(rec):
    c = rec.counters.get("newton_per_pg_iter")
    return sum(c) / len(c) if c else None
