"""The whole step's share of the card's bf16 peak in %: the model FLOPs of
the window's work, counted from its shapes (``roofline.py``), over the
window's host-clock seconds times 989 TFLOP/s."""

from roofline import PEAK_BF16


def read(trace):
    if not (trace.get("cuda") and trace.get("flops")):
        return None
    return 100.0 * trace["flops"] / (trace["flops_window_s"] * PEAK_BF16)
