"""% of the traced window in which no kernel or copy ran on the card."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
