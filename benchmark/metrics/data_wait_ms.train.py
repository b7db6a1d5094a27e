"""Mean ms a training step waited in the program's ``Prefetcher.get()``
over the window (a harness span around the call)."""


def read(trace):
    return trace.get("data_wait_ms")
