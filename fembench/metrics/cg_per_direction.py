"""CG iterations per Newton direction over the traced window (for the
Schur direction, its refinement pass included), from the counts the
program returns."""


def read(rec):
    c = rec.counters.get("cg_per_direction")
    return sum(c) / len(c) if c else None
