"""Int8 weight-only matmul through the hand-written CUDA kernels of
``csrc/int8_matmul.cu``.

Replaces the Pallas TPU kernel ``_int8_matmul_kernel`` of
``llm_bci_tpu/ops/quant.py`` (launched by ``_int8_matmul_pallas``):
``out[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]`` with ``x`` bf16 or
float32 ``(M, K)``, ``q`` int8 ``(K, N)`` and ``scale`` float32 ``(N,)``.

On an H100 two regimes matter, and the plans pick the tiles for each:
``M <= 64`` (decode) is bound by the weight's bytes, so the tile holds all
rows, K is split over blocks to fill the 132 SMs, and a second kernel adds
the float32 partial sums in a fixed order (no atomics: the same inputs give
the same bits), see :func:`plan`; ``M > 64`` (prefill, fine-tune) is bound by
operations and, for bf16 ``x``, takes 256 x 128 or 128 x 128 tiles through
``wgmma`` fed by a ring of TMA loads, the int8 tile converted to bf16 inside
shared memory, see :func:`tile_plan`. What is decided on the host (tile rows,
grid, stages, shared memory) is decided here; the launcher refuses a plan
that does not fit its kernel. See ``csrc/int8_matmul.cu``.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernels do not take; there is no fallback to the plain
version. ``LAUNCHES`` counts the calls that launched the kernel;
``SMALL_M_LAUNCHES`` and ``TILED_LAUNCHES`` split that count by regime.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from llm_bci_tpu_torch.ops import _build

LAUNCHES = 0
SMALL_M_LAUNCHES = 0    # M <= 64: split-K tiles plus the reduce pass
TILED_LAUNCHES = 0      # M > 64: one pass over K (wgmma tiles for bf16 x)

SMALL_M = 64            # the largest M of the split-K regime
TARGET_BLOCKS = 264     # two blocks for each of the 132 SMs
MIN_K_TILES = 2         # k-tiles a split-K block sums at least

# The wgmma kernel of bf16 x at M > 64 (`tiled` in csrc/int8_matmul.cu, which
# refuses a launch whose grid or shared memory differ from its own tiles).
TILE_MS = (256, 128)    # rows of a block's tile: two warpgroups x 2 or 1 chunks of 64
TILE_N, TILE_K = 128, 64
TILE_STAGES = 4         # k-tiles of x (bf16) and q (int8) in the TMA ring
TILE_B_TILES = 3        # converted bf16 weight tiles
TILE_THREADS = 288      # two consumer warpgroups and the warp that starts the loads
TILE_BARRIER_BYTES = 128
SM_COUNT = 132          # one block an SM: a wave is 132 tiles
SMALL_TILE_COST = 1.5   # a 128-row tile converts twice the codes a product
MAX_SMEM_BYTES = 232448  # what one block can use on an H100

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.int8_matmul_launch.restype = i
        lib.int8_matmul_tiled_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.int8_matmul_tiled_launch.restype = i
        _LIB = lib
    return _LIB


def reset_counters() -> None:
    global LAUNCHES, SMALL_M_LAUNCHES, TILED_LAUNCHES
    LAUNCHES = 0
    SMALL_M_LAUNCHES = 0
    TILED_LAUNCHES = 0


def plan(M: int, K: int, N: int, x_is_bf16: bool) -> Tuple[int, int, int]:
    """``(config, split, k_per_split)`` of one call: ``config`` 0 is one
    pass over K (``M > 64``, no split; bf16 ``x`` then takes the tiles of
    :func:`tile_plan`, float32 ``x`` 128 x 128 tiles), 1 / 2 / 3 the 16 / 32 / 64-row
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


class TilePlan(NamedTuple):
    """Launch geometry of the wgmma kernel."""
    tile_m: int                # rows of a block's tile, one of TILE_MS
    grid: Tuple[int, int]      # blocks along M (fastest, so that neighbours share a weight tile), N
    threads: int
    stages: int
    smem_bytes: int            # dynamic shared memory of a block


def tile_plan(M: int, K: int, N: int) -> TilePlan:
    """Geometry of one bf16 call at ``M > 64``: ``tile_m x TILE_N`` output
    tiles, each block walking K in ``TILE_K`` steps through a ring of
    ``TILE_STAGES`` stages (x as bf16, q as int8) plus ``TILE_B_TILES``
    converted bf16 weight tiles and the ring's barriers; 1 KB of slack aligns
    the ring to the swizzle atom.
    ``tile_m`` is the one whose waves of ``SM_COUNT`` blocks cost least: 256
    rows unless the last wave would stand mostly empty."""
    if M <= SMALL_M:
        raise ValueError(f"int8 matmul kernel: M={M} belongs to the split-K regime")
    n_tiles = -(-N // TILE_N)

    def cost(tile_m: int) -> float:
        waves = -(-(-(-M // tile_m) * n_tiles) // SM_COUNT)
        return waves * tile_m * (SMALL_TILE_COST if tile_m == 128 else 1.0)

    tile_m = min(TILE_MS, key=cost)
    stage = tile_m * TILE_K * 2 + TILE_K * TILE_N
    smem = (TILE_STAGES * stage + TILE_B_TILES * TILE_K * TILE_N * 2 + TILE_BARRIER_BYTES
            + 1024)
    return TilePlan(tile_m, (-(-M // tile_m), n_tiles), TILE_THREADS, TILE_STAGES, smem)


def int8_matmul_cuda(
    x: torch.Tensor,                 # (M, K) bf16 or float32, CUDA, contiguous
    q: torch.Tensor,                 # (K, N) int8
    scale: torch.Tensor,             # (N,) float32
    out_dtype: torch.dtype,          # float32 or bfloat16
) -> torch.Tensor:                   # (M, N)
    global LAUNCHES, SMALL_M_LAUNCHES, TILED_LAUNCHES
    device = x.device
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
    # the device last, so that every other refusal can be seen without a card
    if device.type != "cuda":
        raise ValueError(f"int8 matmul kernel: x is on {device}, expected a CUDA device")
    if q.device != device or scale.device != device:
        raise ValueError(f"int8 matmul kernel: q on {q.device}, scale on {scale.device}, "
                         f"x on {device}")

    x_is_bf16 = x.dtype == torch.bfloat16
    config, split, k_per_split = plan(M, K, N, x_is_bf16)
    out = torch.empty((M, N), device=device, dtype=out_dtype)
    partial = (torch.empty((split, M, N), device=device, dtype=torch.float32)
               if split > 1 else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if config == 0 and x_is_bf16:
            tiles = tile_plan(M, K, N)
            rc = _lib().int8_matmul_tiled_launch(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                M, K, N, int(out_dtype == torch.float32),
                tiles.tile_m, tiles.grid[0], tiles.grid[1], tiles.smem_bytes, stream,
            )
        else:
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
