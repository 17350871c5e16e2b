"""Builds the port's CUDA sources at first use.

``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``_build/lib<name>-<hash>.so``, and loaded
with ``ctypes``. The file name carries a hash of the source, of the shared
headers (``csrc/*.cuh``) and of the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.
Sources are read only from ``llm_bci_tpu_torch/csrc/``; the ``_build/``
directory is not committed. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return nvcc


def library_path(name: str) -> str:
    sources = [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    # Compile to a private name, then rename: concurrent processes never see
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu`` (once per process)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _LOADED[name] = lib
    return lib
