"""Milliseconds per design iteration of its two filter solves, the filter
and the adjoint filter, from the program's synchronised phases
``topopt/filter`` and ``topopt/adjoint`` over the traced window."""


def read(rec):
    n = sum(rec.counters.get("design_iterations", []))
    return 1e3 * sum(rec.counters["filter_solve_s"]) / n if n else None
