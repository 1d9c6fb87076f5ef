"""CG iterations of the state solve per design iteration over the traced
window, from the counts the program returns
(``TopoptResult.cg_iterations``)."""


def read(rec):
    c = rec.counters.get("state_cg_per_iter")
    return sum(c) / len(c) if c else None
