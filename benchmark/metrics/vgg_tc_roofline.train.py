"""The two bf16 VGG kernels' (``csrc/vgg_tc.cu``) share of their roofline
in %: the least time their work could take on the card (operations at
989 TFLOP/s or bytes at 3.35 TB/s, from the batches' shapes,
``roofline.vgg_stack_bound_s``) over their device time in the profiled
stretch."""


def read(trace):
    if not trace.get("vgg_ms"):
        return None
    return 100.0 * trace["vgg_bound_ms"] / trace["vgg_ms"]
