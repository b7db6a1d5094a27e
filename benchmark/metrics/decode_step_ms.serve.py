"""Host ms a greedy decode step over the window: the harness span around
``greedy_loop`` (which synchronizes every step) over the steps run."""


def read(trace):
    return trace.get("decode_step_ms")
