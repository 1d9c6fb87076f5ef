"""Seconds per Newton solve: the window over the solves it completed."""


def read(rec):
    return rec.window_s / rec.work
