"""FGMRES iterations per Newton direction of the lumped LDU path over the
traced window, from the counts the program returns
(``NewtonResult.lin_iters``)."""


def read(rec):
    c = rec.counters.get("fgmres_per_direction")
    return sum(c) / len(c) if c else None
