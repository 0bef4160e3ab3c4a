"""Stereo pairs fully matched a minute: every pair the window completed
over all of the window's time."""


def read(run):
    if not run.items or not hasattr(run.loop, "pairs"):
        return None
    return 60.0 * len(run.items) / run.window_s
