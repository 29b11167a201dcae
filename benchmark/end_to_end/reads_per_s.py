"""Reads aligned a second: every read of the window over the time from its
start to the last batch's SAM."""


def read(w):
    return w.reads / w.window_s
