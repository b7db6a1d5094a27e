"""Device ms a training step in GEMM kernels (linears, attention
products), grouped by name as ``chip_smoke.py:KERNEL_GROUPS``."""


def read(trace):
    if not trace.get("gemm_ms"):
        return None
    return trace["gemm_ms"] / trace["steps"]
