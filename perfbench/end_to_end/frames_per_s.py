"""Frames completed in the window over the window's length (host clock)."""


def read(win):
    return len(win.latencies_s) / win.window_s if win.latencies_s else None
