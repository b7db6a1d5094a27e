"""Build and load the port's host-side C++ libraries (``csrc/host/``).

``audio_io.cpp`` (WAV and FLAC decode, the tempo resampler) and
``edit_distance.cpp`` (Levenshtein distances for CER/WER) are compiled by
``g++`` at first use, never at import, into ``build/host/`` at the checkout
root, named by a hash of the source, the flags and the host CPU's feature
flags, so that a changed source is rebuilt and a ``-march=native`` library
built on another CPU (a checkout shared or copied between hosts) is never
loaded. Each build goes to a per-process temporary file that is renamed
into place, so concurrent loaders (prefetch workers) never load a
half-written library (as mtl_tpu/data/audio.py:49-60 does for the JAX
package's copies).

``load`` returns None when the library cannot be built or loaded; each
caller decides what that means (the WAV decode and the resampler fall back
to numpy, FLAC raises).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "host")

# library name -> g++ flags (those of the JAX package's builds)
FLAGS = {"audio_io": ("-O3", "-march=native", "-shared", "-fPIC"),
         "edit_distance": ("-O3", "-shared", "-fPIC")}


@functools.lru_cache(maxsize=None)
def _cpu_flags() -> str:
    """The ``flags`` line of /proc/cpuinfo ("" where there is none): what
    ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln.strip() for ln in f if ln.startswith("flags")),
                        "")
    except OSError:
        return ""


def so_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, f"{name}.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS[name]).encode()
                                + _cpu_flags().encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


@functools.lru_cache(maxsize=None)
def load(name: str) -> Optional[ctypes.CDLL]:
    """The library ``name`` (``audio_io`` or ``edit_distance``), built first
    if needed; None if g++ or the loader fails."""
    out = so_path(name)
    try:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(["g++", *FLAGS[name],
                            os.path.join(SRC_DIR, f"{name}.cpp"), "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        return ctypes.CDLL(out)
    except (OSError, subprocess.CalledProcessError):
        return None
