"""1 - the device busy time of a profiled batch (the median batch) over
the mean time of an unprofiled batch of the same run's window, in %."""

import statistics


def read(run):
    if run.profile is None or not run.profile["busy_s_per_batch"]:
        return None
    busy = statistics.median(run.profile["busy_s_per_batch"])
    return 100 * (1 - busy / (run.window_s / len(run.batch_s)))
