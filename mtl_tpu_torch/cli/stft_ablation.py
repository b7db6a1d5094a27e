"""Where the FFT STFT kernel's time goes, by ablation, on one NVIDIA GPU.

    python -m mtl_tpu_torch.cli.stft_ablation [--rounds 2]

There is no per-instruction profiler on every machine, so this compiles
text variants of ``csrc/stft_fft.cu`` (one ``nvcc`` each, all at once, into
``build/kernels/ablation/``) and times each kernel alone under
``torch.profiler`` at the flagship serving shapes (B 8, T 800, n_fft 320,
hop 160), in rounds:

* ``built``: the source as it is, at 4, 2 and 1 frames a CTA, and with the
  radix plans (5, 4, 8), (5, 8, 4) and (5, 4, 4, 2);
* ``runtime_plan``: n_fft 320 on the kernel instance that reads its size
  and plan at run time, not the one compiled for them;
* ``no_epilogue``: the split step stores |X|^2, without sqrt and log1p;
* ``no_stages``: the FFT stages skipped (the epilogue reads a buffer that
  nothing wrote).

The ablated variants compute wrong outputs on purpose; only their time is
read. Each line gives the max abs error against the plain version, ptxas's
registers and spills, and the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import native
from ..ops import stft as st

B, T, N_FFT, HOP = 8, 800, 320, 160
EPILOGUE = ("log1pf(sqrtf(lo.x * lo.x + lo.y * lo.y))",
            "log1pf(sqrtf(hi.x * hi.x + hi.y * hi.y))")
STAGES = "while (n_stages < MAX_STAGES"
FIXED_320 = "STFT_FFT_FIXED(320, 0x845)"


def variants(src: str) -> dict:
    out = {"built": src, "runtime_plan": src.replace(FIXED_320, ""),
           "no_epilogue": src, "no_stages": src.replace(
               STAGES, "while (false && n_stages < MAX_STAGES")}
    for e in EPILOGUE:
        out["no_epilogue"] = out["no_epilogue"].replace(
            e, e[len("log1pf(sqrtf("):-2])
    for name, text in out.items():
        if name != "built" and text == src:
            raise RuntimeError(f"variant {name} no longer applies to the "
                               f"source; update the ablation")
    return out


def compile_all(sources: dict, work: str) -> dict:
    """{name: (library path, the compiler's output)}; raises if one
    fails."""
    os.makedirs(work, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(work, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", native.CSRC_DIR,
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        built[name] = (so, log)
    return built


def ptxas_summary(log: str) -> str:
    """Every kernel's registers and spill stores in a ``-Xptxas -v`` log."""
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return f"registers {'/'.join(regs)} spill stores {'/'.join(spills)}"


def kernel_ms(fn, iters: int = 50, kernel: str = "stft_fft_kernel") -> float:
    """Mean device time of the named kernel per call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    if len(times) != iters:
        raise RuntimeError(f"profiler saw {len(times)} of {iters} launches")
    return sum(times) / iters / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stft_ablation: torch finds no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    with open(os.path.join(native.CSRC_DIR, "stft_fft.cu")) as f:
        built = compile_all(variants(f.read()),
                            os.path.join(native.BUILD_DIR, "ablation"))
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    audio = torch.from_numpy(rng.uniform(
        -0.5, 0.5, (B, (T - 1) * HOP + N_FFT)).astype(np.float32)).to(dev)
    win, tw = st.device_fft_tables(N_FFT, "hamming", dev)
    cos_b, nsin_b = st.device_dft_matrices(N_FFT, "hamming", dev)
    ref = st.stft_logmag_plain(audio, cos_b, nsin_b, T, HOP)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream
    runs = [("built", frames, (5, 4, 8)) for frames in (4, 2, 1)]
    runs += [("built", 4, plan) for plan in ((5, 8, 4), (5, 4, 4, 2))]
    runs += [(name, 4, (5, 4, 8))
             for name in ("runtime_plan", "no_epilogue", "no_stages")]
    for rnd in range(args.rounds):
        for name, frames, plan in runs:
            so, log = built[name]
            ptxas = ptxas_summary(log)
            fn = getattr(ctypes.CDLL(so), "stft_fft_f32")
            fn.argtypes = native.ENTRIES["stft_fft"]["stft_fft_f32"]
            fn.restype = ctypes.c_int

            def call():
                rc = fn(audio.data_ptr(), win.data_ptr(), tw.data_ptr(),
                        out.data_ptr(), B, audio.shape[1], T, N_FFT, HOP,
                        st.pack_plan(plan), frames, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            ms = kernel_ms(call)
            err = float((out - ref).abs().max())
            print(f"round {rnd} {name} frames {frames} plan {plan}: kernel "
                  f"alone {ms:.4f} ms, max_abs_err {err:.3e}; {ptxas}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
