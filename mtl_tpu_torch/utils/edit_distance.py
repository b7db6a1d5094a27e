"""Levenshtein distance (the reference depends on python-Levenshtein,
utils/metrics.py:3): the native core ``csrc/host/edit_distance.cpp``
(built by ``utils/host_native.py`` at first use, bound with ctypes), with
the numpy two-row DP as the fallback when it cannot be built (port of
mtl_tpu/utils/edit_distance.py:25-123).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import numpy as np

from . import host_native

_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _load_native() -> Optional[ctypes.CDLL]:
    """The native core with its signatures, or None."""
    lib = host_native.load("edit_distance")
    if lib is None:
        return None
    lib.edit_distance.restype = ctypes.c_int32
    lib.edit_distance.argtypes = [_I32P, ctypes.c_int32, _I32P,
                                  ctypes.c_int32]
    lib.edit_distance_batch.restype = None
    lib.edit_distance_batch.argtypes = [_I32P, _I32P, _I32P, _I32P,
                                        ctypes.c_int32, _I32P]
    return lib


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.int32).copy()


def _np_distance(a: np.ndarray, b: np.ndarray) -> int:
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    prev = np.arange(len(b) + 1, dtype=np.int32)
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        # cur[j] = min(prev[j]+1, cur[j-1]+1, sub[j-1]): the first two
        # candidates are vectorized, the cur[j-1] dependency is sequential
        cand = np.minimum(prev[1:] + 1, sub)
        for j in range(1, len(b) + 1):
            c = cand[j - 1]
            if cur[j - 1] + 1 < c:
                c = cur[j - 1] + 1
            cur[j] = c
        prev = cur
    return int(prev[-1])


def distance(s1: str, s2: str) -> int:
    """Levenshtein distance between two unicode strings."""
    a, b = _codes(s1), _codes(s2)
    lib = _load_native()
    if lib is None:
        return _np_distance(a, b)
    return int(lib.edit_distance(a.ctypes.data_as(_I32P), len(a),
                                 b.ctypes.data_as(_I32P), len(b)))


def distance_batch(pairs: Sequence[tuple]) -> List[int]:
    """Distances of (hyp, gold) string pairs, in one native call."""
    lib = _load_native()
    if lib is None:
        return [distance(a, b) for a, b in pairs]
    a_arrs = [_codes(a) for a, _ in pairs]
    b_arrs = [_codes(b) for _, b in pairs]
    a_off = np.zeros(len(pairs) + 1, np.int32)
    b_off = np.zeros(len(pairs) + 1, np.int32)
    np.cumsum([len(x) for x in a_arrs], out=a_off[1:])
    np.cumsum([len(x) for x in b_arrs], out=b_off[1:])
    a_flat = np.ascontiguousarray(
        np.concatenate(a_arrs) if a_arrs else np.zeros(0), np.int32)
    b_flat = np.ascontiguousarray(
        np.concatenate(b_arrs) if b_arrs else np.zeros(0), np.int32)
    out = np.zeros(len(pairs), np.int32)
    lib.edit_distance_batch(
        a_flat.ctypes.data_as(_I32P), a_off.ctypes.data_as(_I32P),
        b_flat.ctypes.data_as(_I32P), b_off.ctypes.data_as(_I32P),
        len(pairs), out.ctypes.data_as(_I32P))
    return out.tolist()
