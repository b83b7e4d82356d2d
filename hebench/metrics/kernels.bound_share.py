"""The batch's byte floor (floor.py: what the PIR work has to move, from
the configuration's shapes) over the card's HBM rate, as a share of the
device busy time of a profiled batch (the median batch). A byte-bound
share: the integer pipes have no published peak."""

import statistics

from hebench import peaks


def read(run):
    if run.profile is None or not run.profile["busy_s_per_batch"]:
        return None
    busy = statistics.median(run.profile["busy_s_per_batch"])
    if busy <= 0:
        return None
    return 100 * run.floor["total"] / peaks.HBM_BYTES_PER_S / busy
