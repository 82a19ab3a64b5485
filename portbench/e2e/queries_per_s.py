"""Query rows answered in the window, divided by the window's seconds."""


def read(run):
    return run.rows / run.window_s
