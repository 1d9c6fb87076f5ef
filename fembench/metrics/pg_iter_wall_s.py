"""Seconds per PG iteration: the traced window over the PG iterations it
completed (host clock; the window's spans and counters on)."""


def read(rec):
    return rec.window_s / rec.work if rec.work else None
