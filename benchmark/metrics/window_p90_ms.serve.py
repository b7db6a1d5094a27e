"""The 90th percentile, over the window's utterances, of the ms from a
batch's read to its strings (host clock)."""


def read(trace):
    return trace.get("window_p90_ms")
