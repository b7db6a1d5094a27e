"""The FFT STFT kernel's (``csrc/stft_fft.cu``) share of its roofline in
%: its work's least time on the card (bytes at 3.35 TB/s or operations at
f32 67 TFLOP/s, from the batches' shapes, ``roofline.stft_bound_s``) over
its device time in the profiled stretch."""


def read(trace):
    if not trace.get("stft_ms"):
        return None
    return 100.0 * trace["stft_bound_ms"] / trace["stft_ms"]
