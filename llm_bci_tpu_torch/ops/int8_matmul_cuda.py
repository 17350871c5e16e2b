"""Int8 weight-only matmul through the hand-written CUDA kernels of
``csrc/int8_matmul.cu``.

Replaces the Pallas TPU kernel ``_int8_matmul_kernel`` of
``llm_bci_tpu/ops/quant.py`` (launched by ``_int8_matmul_pallas``):
``out[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]`` with ``x`` bf16 or
float32 ``(M, K)``, ``q`` int8 ``(K, N)`` and ``scale`` float32 ``(N,)``.

On an H100 two regimes matter, and :func:`plan` picks the tile for each:
``M <= 64`` (decode) is bound by the weight's bytes, so the tile holds all
rows, K is split over blocks to fill the 132 SMs, and a second kernel adds
the float32 partial sums in a fixed order (no atomics: the same inputs give
the same bits); ``M > 64`` (prefill, fine-tune) is bound by operations and
takes 128 x 128 tiles on the tensor cores. See ``csrc/int8_matmul.cu``.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernels do not take; there is no fallback to the plain
version. ``LAUNCHES`` counts the calls that launched the kernel;
``SMALL_M_LAUNCHES`` and ``TILED_LAUNCHES`` split that count by regime.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from llm_bci_tpu_torch.ops import _build

LAUNCHES = 0
SMALL_M_LAUNCHES = 0    # M <= 64: split-K tiles plus the reduce pass
TILED_LAUNCHES = 0      # M > 64: 128 x 128 tiles

SMALL_M = 64            # the largest M of the split-K regime
TARGET_BLOCKS = 264     # two blocks for each of the 132 SMs
MIN_K_TILES = 2         # k-tiles a split-K block sums at least

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.int8_matmul_launch.restype = i
        _LIB = lib
    return _LIB


def reset_counters() -> None:
    global LAUNCHES, SMALL_M_LAUNCHES, TILED_LAUNCHES
    LAUNCHES = 0
    SMALL_M_LAUNCHES = 0
    TILED_LAUNCHES = 0


def plan(M: int, K: int, N: int, x_is_bf16: bool) -> Tuple[int, int, int]:
    """``(config, split, k_per_split)`` of one call: ``config`` 0 is the
    128 x 128 tile (``M > 64``, no split), 1 / 2 / 3 the 16 / 32 / 64-row
    tiles of the split-K regime. ``split`` grows until the grid has about
    two blocks an SM, as long as each block still sums ``MIN_K_TILES``
    k-tiles."""
    if M > SMALL_M:
        return 0, 1, K
    config = 1 if M <= 16 else 2 if M <= 32 else 3
    bk = 64 if x_is_bf16 else 32
    k_tiles = -(-K // bk)
    n_tiles = -(-N // 128)
    split = max(1, min(-(-TARGET_BLOCKS // n_tiles), k_tiles // MIN_K_TILES))
    tiles_per_split = -(-k_tiles // split)
    split = -(-k_tiles // tiles_per_split)       # no block without work
    return config, split, tiles_per_split * bk


def int8_matmul_cuda(
    x: torch.Tensor,                 # (M, K) bf16 or float32, CUDA, contiguous
    q: torch.Tensor,                 # (K, N) int8
    scale: torch.Tensor,             # (N,) float32
    out_dtype: torch.dtype,          # float32 or bfloat16
) -> torch.Tensor:                   # (M, N)
    global LAUNCHES, SMALL_M_LAUNCHES, TILED_LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"int8 matmul kernel: x is on {device}, expected a CUDA device")
    if q.device != device or scale.device != device:
        raise ValueError(f"int8 matmul kernel: q on {q.device}, scale on {scale.device}, "
                         f"x on {device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8 matmul kernel: x has dtype {x.dtype}, expected bfloat16 or float32")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8 matmul kernel: q {q.dtype} / scale {scale.dtype}, "
                        "expected int8 / float32")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8 matmul kernel: out_dtype {out_dtype}, expected bfloat16 or float32")
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError("int8 matmul kernel: expected x (M, K), q (K, N), scale (N,)")
    M, K = x.shape
    N = q.shape[1]
    if q.shape[0] != K or scale.shape[0] != N:
        raise ValueError(f"int8 matmul kernel: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)} do not fit")
    if M < 1:
        raise ValueError("int8 matmul kernel: empty x")
    if K % 16 or N % 16:
        raise ValueError(f"int8 matmul kernel: K={K} and N={N} must be multiples of 16")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"int8 matmul kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int8 matmul kernel: {name} must be 16-byte aligned")

    x_is_bf16 = x.dtype == torch.bfloat16
    config, split, k_per_split = plan(M, K, N, x_is_bf16)
    out = torch.empty((M, N), device=device, dtype=out_dtype)
    partial = (torch.empty((split, M, N), device=device, dtype=torch.float32)
               if split > 1 else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().int8_matmul_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            M, K, N, int(x_is_bf16), int(out_dtype == torch.float32),
            config, split, k_per_split, stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8 matmul kernel: launch failed with CUDA error {rc}")
    LAUNCHES += 1
    if config == 0:
        TILED_LAUNCHES += 1
    else:
        SMALL_M_LAUNCHES += 1
    return out
