"""The 95th percentile over every batch of the window, each from its call
to its synchronize (host clock): the wait a query has for its batch."""

from hebench import stats


def read(run):
    return 1e3 * stats.percentile(run.batch_s, 95)
