# Mirrors llm_bci_tpu/native/__init__.py (host code that imports no JAX): the port keeps its own copy.
"""Native (C) host-side components, built on first use with the system cc.

The compute path is JAX/XLA/Pallas; these cover the CPU-side hot spots the
reference delegated to third-party C++ (SURVEY.md §2.6): currently the
token-sequence Levenshtein used by the WER/CER eval sweeps
(``editdistance`` package equivalent).

Build is cached next to the source; any failure falls back to the pure
numpy implementation in :mod:`llm_bci_tpu_torch.eval.eval_bci`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_editdistance.so")
_SRC = os.path.join(_DIR, "editdistance.c")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            for cc in ("cc", "gcc", "clang"):
                try:
                    subprocess.run(
                        [cc, "-O3", "-shared", "-fPIC", _SRC, "-o", _SO],
                        check=True,
                        capture_output=True,
                        timeout=60,
                    )
                    break
                except (OSError, subprocess.SubprocessError):
                    continue
            else:
                return None
        lib = ctypes.CDLL(_SO)
        lib.edit_distance_i32.restype = ctypes.c_int64
        lib.edit_distance_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def edit_distance_native(source: Sequence, target: Sequence) -> Optional[int]:
    """Levenshtein distance via the C kernel; None if unavailable.

    Tokens are interned to int32 ids host-side (hashability is the only
    requirement), so comparisons in the DP inner loop are integer compares.
    """
    lib = _load()
    if lib is None:
        return None
    import numpy as np

    ids = {}

    def intern(seq):
        out = np.empty(len(seq), np.int32)
        for i, tok in enumerate(seq):
            out[i] = ids.setdefault(tok, len(ids))
        return out

    a = intern(list(source))
    b = intern(list(target))
    res = lib.edit_distance_i32(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(a),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(b),
    )
    return None if res < 0 else int(res)
