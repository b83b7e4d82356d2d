"""From the harness's first line to the first timed batch (host clock):
kernel builds where not cached, the database, keys and query pool, and the
warm-up batches."""


def read(run):
    return run.setup_s
