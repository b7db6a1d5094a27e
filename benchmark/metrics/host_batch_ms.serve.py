"""Mean ms a served batch took to be read and collated
(``SpectrogramDataset.iter_batches``) over the window (a harness span)."""


def read(trace):
    return trace.get("host_batch_ms")
