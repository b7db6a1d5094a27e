"""Device ms a training step in elementwise, copy and cast kernels,
grouped by name as ``chip_smoke.py:KERNEL_GROUPS``."""


def read(trace):
    if not trace.get("copy_cast_ms"):
        return None
    return trace["copy_cast_ms"] / trace["steps"]
