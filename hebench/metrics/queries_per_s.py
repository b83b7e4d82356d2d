"""Queries answered in the window over the window's seconds (host clock)."""

from hebench import stats


def read(run):
    return stats.rate(run.queries, run.window_s)
