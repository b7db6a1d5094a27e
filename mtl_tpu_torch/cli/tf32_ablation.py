"""Where the 3xTF32 kernels' time goes, and which order of the three passes
is more accurate, on one NVIDIA GPU.

    python -m mtl_tpu_torch.cli.tf32_ablation [--rounds 2]

Compiles text variants of ``csrc/stft_dft_tc.cu`` (the direct STFT) and
``csrc/vgg_f32_tc.cu`` (the f32 VGG blocks 1 and 2), one ``nvcc`` each,
all at once, into ``build/kernels/ablation_tf32/``, and times each kernel
alone under ``torch.profiler`` at ``chip_smoke.py`` phase 3's shapes (the
STFT at B 8, T 800, n_fft 441 / hop 220 and 320 / 160; block 1 at [8, 800,
161] -> 64 and at 80 bins; block 2 at [8, 400, 80, 64] -> 128 and at 40
bins), in rounds:

* ``built``: the source as it is;
* ``small_acc`` (STFT): the two small products into an accumulator of
  their own, added after the last step (``SMALL_ACC``'s text edits), the
  other order of the passes; its error beside ``built``'s decides the
  order;
* ``wgs4`` (STFT): four warpgroups, 256 frame rows a CTA, one CTA an SM
  (100 CTAs at n_fft 441, not 200 two an SM): half the basis's L2 reads;
* ``no_fence``: without the async-proxy fences before the MMAs read a
  stage (what they cost; the outputs stay right on this card, though the
  fences are what the memory model asks for);
* ``wait2``: each k8 step waits for the step two back, not the one
  before it: three MMA groups in flight a warpgroup, not two;
* ``one_pass``: hi.hi alone, one tensor-core pass instead of three;
* ``no_mma``: the A loads and splits without the MMAs;
* ``no_stream``: the basis or the weights loaded from L2 for the first
  chunks or slices only (each stage still written, split, from registers);
* ``no_conv1``: block 2's conv-1 MMAs dropped (the time conv 1 takes, a
  third of whose rows are the halo of the 8 x 16 conv-2 tile: 192 rows for
  128 positions); block 1's conv-1 FMAs and their stores dropped;
* ``tile32`` (block 1): a conv-2 tile of 32 t x 16 f, one CTA a SM (4 m64
  tiles a warpgroup, 128 accumulators a thread at C 64), against the
  built 16 x 16 at two CTAs a SM.

The variants from ``one_pass`` to ``no_conv1`` compute wrong outputs on
purpose, and ``wait2``'s output came out wrong at n_fft 441 (not taken
apart: it bought no time); only their time is read.
Each line gives the max abs error against the plain version and against
float64 (computed on the card), ptxas's registers and spills of the
kernel timed (its C 64 / C 128 instance); the card's name and power
limit come first.
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
import torch.nn.functional as F

from ..ops import native
from ..ops import stft as st
from ..ops import vgg
from .stft_ablation import compile_all, kernel_ms

B, T = 8, 800
STFT_SHAPES = ((441, 220), (320, 160))
VGG1_BINS = (161, 80)  # block 1's input width: STFT and log-fbank bins
VGG_BINS = (80, 40)  # block 2's input width at 161 and 80 frontend bins
MMA3 = re.compile(r"mma3<([^>]+)>\(([^,]+), ([^,]+), ([^,]+), b_hi, b_lo\);")
# the STFT's small products into an accumulator of their own, added to acc
# after the last step: (text, replacement) pairs, each found once
SMALL_ACC = (
    ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)"),
    ("  zero(acc);\n",
     "  zero(acc);\n  float small[TN / 2];\n  zero(small);\n"),
    ("mma3<TN>(acc, hi, lo, b_hi, b_lo);",
     "WgmmaTf32<TN>::mma(small, lo, b_hi);\n"
     "      WgmmaTf32<TN>::mma(small, hi, b_lo);\n"
     "      WgmmaTf32<TN>::mma(acc, hi, b_hi);"),
    ("  pin(acc);\n", "  pin(acc);\n  pin(small);\n"
     "  for (int i = 0; i < TN / 2; ++i) acc[i] += small[i];\n"),
)


def _edit(src: str, name: str) -> str:
    if name == "built":
        return src
    if name == "small_acc":  # twice the accumulators: one CTA a SM
        out = src
        for old, new in SMALL_ACC:
            if out.count(old) != 1:
                raise RuntimeError(f"variant small_acc: {old!r} is not in "
                                   f"the source once; update the ablation")
            out = out.replace(old, new)
        return out
    if name == "wgs4":  # 256 frame rows a CTA, one CTA an SM
        out = src.replace("constexpr int WGS = 2;", "constexpr int WGS = 4;")
        out = out.replace("__launch_bounds__(THREADS, 2)",
                          "__launch_bounds__(THREADS, 1)")
    elif name == "no_fence":
        out = src.replace("fence_async_smem();", "")
    elif name == "no_conv1":
        out = src.replace("mma3<K::N1>(acc[m], hi[m], lo[m], b_hi, b_lo);", "")
        out = out.replace("for (int p = tid / K::CG; p < K::M1;",
                          "for (int p = K::M1; p < K::M1;")
    elif name == "tile32":
        out = src.replace("TT = 16, TF = 16;  // block 1's",
                          "TT = 32, TF = 16;  // block 1's")
        out = out.replace("CTAS = 2;          // block 1's",
                          "CTAS = 1;          // block 1's")
    elif name == "wait2":
        out = src.replace("wg_wait<1>();", "wg_wait<2>();")
    elif name == "one_pass":
        out = MMA3.sub(r"WgmmaTf32<\1>::mma(\2, \3, b_hi);", src)
    elif name == "no_mma":
        out = MMA3.sub(
            r"\2[0] += __uint_as_float(\3[0] ^ \3[3] ^ \4[0] ^ \4[3]) + "
            r"(float)(b_hi ^ b_lo);", src)
    else:  # no_stream
        out = re.sub(r"if \((c|s) \+ 2 < (chunks|ns)\)", "if (false)", src)
    if out == src:
        raise RuntimeError(f"variant {name} no longer applies to the source; "
                           f"update the ablation")
    return out


# kernel timed -> (library, C entry, the variants timed)
KERNELS = {
    "stft_dft_tc_kernel": ("stft_dft_tc", "stft_dft_tc_f32", (
        "built", "small_acc", "wgs4", "no_fence", "wait2", "one_pass",
        "no_mma", "no_stream")),
    "vgg_block1_f32tc_kernel": ("vgg_f32_tc", "vgg_block1_f32tc", (
        "built", "tile32", "no_fence", "one_pass", "no_mma", "no_stream",
        "no_conv1")),
    "vgg_block2_f32tc_kernel": ("vgg_f32_tc", "vgg_block2_f32tc", (
        "built", "no_fence", "wait2", "one_pass", "no_mma", "no_stream",
        "no_conv1")),
}


def variants() -> dict:
    """{(library, variant): source text}."""
    out = {}
    for lib, _, names in KERNELS.values():
        with open(os.path.join(native.CSRC_DIR, native.SOURCES[lib])) as f:
            src = f.read()
        for name in names:
            out[(lib, name)] = _edit(src, name)
    return out


# the instance whose registers a line gives (its mangled name's start)
INSTANCE = {"stft_dft_tc_kernel": "stft_dft_tc_kernel",
            "vgg_block1_f32tc_kernel": "vgg_block1_f32tc_kernelILi64E",
            "vgg_block2_f32tc_kernel": "vgg_block2_f32tc_kernelILi64ELi128E"}


def kernel_ptxas(log: str, kernel: str) -> str:
    """Registers and spill stores of ``kernel``'s timed instance in a
    ``-Xptxas -v`` log."""
    for part in log.split("Compiling entry function")[1:]:
        if INSTANCE[kernel] in part.split("\n", 1)[0]:
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            return (f"registers {regs.group(1) if regs else '?'} spill "
                    f"stores {spill.group(1) if spill else '?'}")
    return "no ptxas report"


def _entry(so: str, lib: str, entry: str):
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes = native.ENTRIES[lib][entry]
    fn.restype = ctypes.c_int
    return fn


def _stft_cases(dev, rng):
    """(label, launch args, out, plain, float64, the inputs to keep)."""
    cases = []
    for n_fft, hop in STFT_SHAPES:
        audio = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (B, (T - 1) * hop + n_fft)).astype(np.float32)).to(dev)
        packed = st.device_dft_tc_operands(n_fft, "hamming", dev)
        cos_b, nsin_b = st.device_dft_matrices(n_fft, "hamming", dev)
        plain = st.stft_logmag_plain(audio, cos_b, nsin_b, T, hop)
        f64 = st.stft_logmag_plain(audio.double(), cos_b.double(),
                                   nsin_b.double(), T, hop)
        out = torch.empty_like(plain)
        f = n_fft // 2 + 1
        args = (audio.data_ptr(), packed.data_ptr(), out.data_ptr(), B,
                audio.shape[1], T, n_fft, hop, f, packed.shape[0],
                packed.shape[1])
        cases.append((f"n_fft {n_fft}", args, out, plain, f64, audio))
    return cases


def _vgg_cases(dev, rng, block):
    cases = []
    for f in VGG1_BINS if block == 1 else VGG_BINS:
        t, cin, c = (T, 1, 64) if block == 1 else (T // 2, 64, 128)
        shape = (B, t, f) if block == 1 else (B, t, f, cin)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
        if block == 2:
            x = x.relu()  # like block 1's output
        ws = [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32)).to(dev)
              for s, sc in (((3, 3, cin, c), 0.3 / cin ** 0.5), ((c,), 0.1),
                            ((3, 3, c, c), 0.3 / c ** 0.5), ((c,), 0.1))]
        plain = vgg.vgg_block_plain(x, *ws, out_dtype=torch.float32)
        xd = x.double().reshape(B, t, f, cin).permute(0, 3, 1, 2)
        y = F.relu(F.conv2d(xd, vgg.hwio_to_oihw(ws[0]).double(),
                            ws[1].double(), padding=1))
        y = F.relu(F.conv2d(y, vgg.hwio_to_oihw(ws[2]).double(),
                            ws[3].double(), padding=1))
        f64 = F.max_pool2d(y, 2).permute(0, 2, 3, 1)
        out = torch.empty_like(plain)
        if block == 1:
            wp = vgg.pack_block1_f32tc(ws[2])
            args = (x.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                    wp.data_ptr(), ws[3].data_ptr(), out.data_ptr(), B, t, f,
                    c)
        else:
            wp = vgg.pack_block2_f32tc(ws[0], ws[2])
            args = (x.data_ptr(), wp.data_ptr(), ws[1].data_ptr(),
                    ws[3].data_ptr(), out.data_ptr(), B, t, f, cin, c)
        label = f"[{B}, {t}, {f}{'' if block == 1 else f', {cin}'}] -> {c}"
        cases.append((label, args, out, plain, f64, (x, wp, ws)))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tf32_ablation: torch finds no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    srcs = variants()
    built = compile_all({f"{k}-{n}": s for (k, n), s in srcs.items()},
                        os.path.join(native.BUILD_DIR, "ablation_tf32"))
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {"stft_dft_tc_kernel": _stft_cases(dev, rng),
             "vgg_block1_f32tc_kernel": _vgg_cases(dev, rng, 1),
             "vgg_block2_f32tc_kernel": _vgg_cases(dev, rng, 2)}
    for rnd in range(args.rounds):
        for kernel, (lib, entry, names) in KERNELS.items():
            for name in names:
                so, log = built[f"{lib}-{name}"]
                fn = _entry(so, lib, entry)
                ptxas = kernel_ptxas(log, kernel)
                for label, call_args, out, plain, f64, *_ in cases[kernel]:
                    def call():
                        rc = fn(*call_args, stream)
                        if rc:
                            raise RuntimeError(f"{entry} {name}: CUDA error "
                                               f"{rc}")

                    ms = kernel_ms(call, 30, kernel)
                    err = float((out - plain).abs().max())
                    err64 = float((out.double() - f64).abs().max())
                    print(f"round {rnd} {kernel} {name} {label}: kernel "
                          f"alone {ms:.4f} ms, max_abs_err {err:.3e} (plain "
                          f"f32), {err64:.3e} (float64); {ptxas}", flush=True)
    # the plain f32 versions against float64, for scale
    for kernel, kcases in cases.items():
        for label, _, _, plain, f64, *_ in kcases:
            print(f"plain {kernel} {label}: max_abs_err "
                  f"{float((plain.double() - f64).abs().max()):.3e} (float64)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
