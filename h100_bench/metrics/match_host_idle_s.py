"""Seconds a pair in which the card idled while the innermost range
spanning the gap was the matcher's own (`match` or `match.*`: the
port's Python with nothing queued), over the traced window's pairs;
nothing without a trace, or where the program records no `upload` span
(it then opens no such range)."""

from h100_bench.readers import stage_mean


def read(run):
    if run.trace is None or not run.traced_items:
        return None
    if stage_mean(run, "upload") is None:
        return None
    return sum(s for name, s in run.trace.idle_gaps
               if name == "match" or name.startswith("match.")) \
        / run.traced_items
