"""Kernel launches a greedy decode step: the profiler's launch calls on
the host inside the ``greedy_loop`` span, over the steps run."""


def read(trace):
    return trace.get("launches_per_step") or None
