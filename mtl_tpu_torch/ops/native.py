"""Build, load and count the hand-written CUDA kernels under ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. Builds happen at first use
(never at import: hosts without a GPU import every module), into
``build/kernels/`` at the checkout root, named by a hash of the source and
flags so a changed source is rebuilt. ``build()`` compiles all sources at
once, one ``nvcc`` process each.

``launch_counts`` is module state (with the spans' totals of
``utils/trace.py``, the port's only): every kernel wrapper adds one to its
entry where it launches its kernel, so a run can show that its main path
went through the kernels. ``vgg_stack_bwd`` counts the
VGG stack's backward on the card (``ops/vgg.py:_VGGStack``), which recomputes
the plain version rather than launching a kernel of this package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> source file under csrc/ (each may include csrc/*.cuh)
SOURCES = {"stft_dft_tc": "stft_dft_tc.cu", "stft_fft": "stft_fft.cu",
           "vgg_tc": "vgg_tc.cu", "vgg_f32_tc": "vgg_f32_tc.cu"}

# C entry -> argtypes (every entry returns cudaError_t as int)
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    "stft_dft_tc": {"stft_dft_tc_f32": [_P] * 3 + [_I] * 8 + [_P],
                    "tf32_split_f32": [_P] * 4 + [_I, _P]},
    "stft_fft": {"stft_fft_f32": [_P] * 4 + [_I] * 7 + [_P]},
    "vgg_tc": {
        "vgg_block1_tc": [_P] * 6 + [_I] * 4 + [_P],
        "vgg_block2_tc": [_P] * 5 + [_I] * 5 + [_P],
    },
    "vgg_f32_tc": {
        "vgg_block1_f32tc": [_P] * 6 + [_I] * 4 + [_P],
        "vgg_block2_f32tc": [_P] * 5 + [_I] * 5 + [_P],
    },
}

# the STFT has two routes chosen by n_fft: the FFT (stft_fft.cu) and the
# direct DFT (stft_dft_tc.cu, counted as stft_logmag_direct); the VGG blocks
# two chosen by dtype: bf16 tensor cores (vgg_tc.cu) and f32 on 3xTF32
# tensor cores (vgg_f32_tc.cu, counted as *_f32). A meta step replayed as a
# CUDA graph (train/graphs.py) counts its kernels once, at its capture, and
# each replay under meta_graph_replays
launch_counts: Dict[str, int] = {"stft_logmag": 0, "stft_logmag_direct": 0,
                                 "vgg_block1": 0, "vgg_block2": 0,
                                 "vgg_block1_f32": 0, "vgg_block2_f32": 0,
                                 "vgg_stack_bwd": 0,
                                 "meta_graph_captures": 0,
                                 "meta_graph_replays": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from mtl_tpu_torch/csrc at first use")
    return found


def so_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers
    beside it and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None
          ) -> Dict[str, Tuple[float, str]]:
    """Compile the named sources (default: all) that are not built yet, all
    ``nvcc`` processes at once. Returns {name: (seconds from the start of
    the build to that compile's end, ptxas report)}; raises with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    start, procs = time.perf_counter(), {}
    for name in names:
        out = so_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(f"{tmp}.log", "w+")  # a file: a pipe could fill and block
        procs[name] = (out, tmp, log, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
             os.path.join(CSRC_DIR, SOURCES[name])],
            stdout=log, stderr=subprocess.STDOUT))
    seconds = {}
    while len(seconds) < len(procs):
        for name, (_, _, _, proc) in procs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - start
        time.sleep(0.02)
    reports, failed = {}, []
    for name, (out, tmp, log, proc) in procs.items():
        log.seek(0)
        reports[name] = (seconds[name], log.read())
        log.close()
        os.remove(f"{tmp}.log")
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name]} failed:\n{reports[name][1]}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    path = so_path(name)
    if not os.path.exists(path):
        build([name])
    lib = ctypes.CDLL(path)
    for entry, argtypes in ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, entry: str, counter: str, *args) -> None:
    """Call one C entry on the current stream; raise on a CUDA error, count
    the launch otherwise."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(name), entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")
    launch_counts[counter] += 1


def require_cuda(*tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous CUDA tensors on one device, with
    16-byte aligned data (the kernels use vector loads)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
