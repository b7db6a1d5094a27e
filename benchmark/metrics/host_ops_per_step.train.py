"""ATen operators the host dispatched a training step, nested ones
included: the profiler's ``aten::`` events over the profiled steps."""


def read(trace):
    if not trace.get("host_ops"):
        return None
    return trace["host_ops"] / trace["steps"]
