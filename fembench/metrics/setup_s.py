"""Seconds from the start of the process to the first timed unit:
building, inputs, kernel builds or loads, warm-up."""


def read(rec):
    return rec.setup_s
