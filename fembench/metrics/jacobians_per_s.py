"""Element Jacobians per second: the elements of every call in the window
over the window, which closes on a synchronize."""


def read(rec):
    return rec.work / rec.window_s
