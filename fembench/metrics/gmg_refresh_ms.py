"""Milliseconds per refresh of the state's GMG (every level's
field-backed state and diagonal at the injected design, and the coarse
inverse), from the program's synchronised phase ``topopt/gmg_refresh``
over the traced window."""


def read(rec):
    n = sum(rec.counters.get("gmg_refreshes", []))
    return 1e3 * sum(rec.counters["gmg_refresh_s"]) / n if n else None
