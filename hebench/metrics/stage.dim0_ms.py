"""Device ms a batch of the stage span that ends at the server's
'dim0' mark: dim-0: the first dimension's expanded ciphertexts to Eval, the products with the database, the columns back to Coeff. CUDA events recorded at each mark as the host
passes it; a span ends when the stage's work is issued and done, so it
holds the device's idle time while the host issues it. The mean over the
traced window's batches."""

MARK = "dim0"


def read(run):
    spans = [s[MARK] for s in run.stage_ms if MARK in s]
    if not spans:
        return None
    return sum(spans) / len(spans)
