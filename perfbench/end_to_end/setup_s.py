"""Seconds from the process's start to the window's opening: imports, the
kernels' build or load, the ring of inputs, the warm-up frames."""


def read(win):
    return win.setup_s
