"""Host CPU ms a batch: time.process_time around the server's call (the
issue of the batch's work, without the wait for the device), the mean over
the traced window's batches."""


def read(run):
    if not run.host_s:
        return None
    return 1e3 * sum(run.host_s) / len(run.host_s)
