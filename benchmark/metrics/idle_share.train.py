"""The device's idle share of the profiled stretch in %: 1 - the union of
the kernels' intervals over the stretch's host-clock length."""


def read(trace):
    if not (trace.get("cuda") and trace.get("busy_ms")):
        return None
    return 100.0 * (1.0 - trace["busy_ms"] / trace["window_ms"])
