"""Int8 weight-only matmul through the hand-written CUDA kernels of
``csrc/int8_matmul.cu``.

Replaces the Pallas TPU kernel ``_int8_matmul_kernel`` of
``llm_bci_tpu/ops/quant.py`` (launched by ``_int8_matmul_pallas``):
``out[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]`` with ``x`` bf16 or
float32 ``(M, K)``, ``q`` int8 ``(K, N)`` and ``scale`` float32 ``(N,)``.

On an H100 two regimes matter, and a plan fixes each launch's geometry:

* bf16 ``x`` at ``M <= 64`` (a decode step) is bound by the weight's bytes:
  blocks of 128 columns keep a ring of TMA loads in flight, K is split over
  the ranks of a thread-block cluster and the ranks add their float32 partial
  sums through distributed shared memory, in rank order (one launch a
  product, no scratch, the same bits every run), see :func:`cluster_plan`;
* bf16 ``x`` at ``M > 64`` (prefill, fine-tune) is bound by operations: 256 x
  128 or 128 x 128 tiles through ``wgmma`` fed by a ring of TMA loads, the
  int8 tile converted to bf16 inside shared memory, see :func:`tile_plan`.

float32 ``x`` (tests and tight comparison only) takes one CUDA-core kernel of
128 x 128 tiles at every M. The launchers refuse a plan that does not fit
their kernel; the wrapper checks the cluster plan against the same constants
before it touches the card. See ``csrc/int8_matmul.cu``.

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernels do not take; there is no fallback to the plain
version. ``LAUNCHES`` counts the calls that launched a kernel (a call inside
a CUDA graph capture counts once, when it is captured; replays of the graph
do not count); ``REGIME_LAUNCHES`` splits that count by the :func:`regime`
each call took, whose kernel ``REGIME_KERNELS`` names.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from llm_bci_tpu_torch.ops import _build

LAUNCHES = 0
# the kernel of each regime, by namespace and name in csrc/int8_matmul.cu
REGIME_KERNELS = {"cluster": "cluster::int8_cluster_kernel",    # bf16, M <= 64
                  "tiled": "tiled::int8_wgmma_kernel",          # bf16, M > 64
                  "f32": "f32::int8_f32_kernel"}                # float32 x, every M
REGIME_LAUNCHES = dict.fromkeys(REGIME_KERNELS, 0)

SM_COUNT = 132          # H100 SXM
MAX_SMEM_BYTES = 232448  # what one block can use on an H100

# The cluster kernel of bf16 x at M <= 64 (`cluster` in csrc/int8_matmul.cu,
# which refuses a launch whose plan differs from its own constants).
CLUSTER_MAX_M = 64
CLUSTER_M_TILES = (1, 2, 4, 5, 8)  # 8-row tiles of x of the kernel's instantiations
CLUSTER_SIZES = (1, 2, 4, 8)       # ranks of a cluster: the K-split; 128 columns divide over them
CLUSTER_N, CLUSTER_K = 128, 64     # columns of a block, k-depth of a stage
CLUSTER_THREADS = 160              # four consumer warps and the warp that starts the loads
CLUSTER_BLOCKS_PER_SM = 2          # blocks an SM the plan aims at (each plan's shared memory allows three)
MIN_RANK_TILES = 4                 # k-tiles a rank streams at least
CLUSTER_BLOCK_SMEM = 76800         # a block's dynamic shared memory at most: three an SM

# The wgmma kernel of bf16 x at M > 64 (`tiled` in csrc/int8_matmul.cu,
# which refuses a launch whose grid or shared memory differ from its own tiles).
TILE_MS = (256, 128)    # rows of a block's tile: two warpgroups x 2 or 1 chunks of 64
TILE_N, TILE_K = 128, 64
TILE_STAGES = 4         # k-tiles of x (bf16) and q (int8) in the TMA ring
TILE_B_TILES = 3        # converted bf16 weight tiles
TILE_THREADS = 288      # two consumer warpgroups and the warp that starts the loads
TILE_BARRIER_BYTES = 128
SMALL_TILE_COST = 1.5   # a 128-row tile converts twice the codes a product

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul_f32_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.int8_matmul_cluster_launch.argtypes = [p, p, p, p] + [i] * 11 + [p]
        lib.int8_matmul_tiled_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
        for fn in (lib.int8_matmul_f32_launch, lib.int8_matmul_cluster_launch,
                   lib.int8_matmul_tiled_launch):
            fn.restype = i
        _LIB = lib
    return _LIB


def reset_counters() -> None:
    global LAUNCHES
    LAUNCHES = 0
    REGIME_LAUNCHES.update(dict.fromkeys(REGIME_KERNELS, 0))


def regime(M: int, x_is_bf16: bool) -> str:
    """The kernel a call takes: ``"cluster"`` (bf16 ``x``, ``M <= 64``: split-K
    inside a cluster), ``"tiled"`` (bf16, ``M > 64``: wgmma tiles) or
    ``"f32"`` (float32 ``x``: CUDA-core tiles, one pass over K)."""
    if not x_is_bf16:
        return "f32"
    return "cluster" if M <= CLUSTER_MAX_M else "tiled"


class ClusterPlan(NamedTuple):
    """Launch geometry of the cluster kernel."""
    m_tiles: int               # 8-row tiles of x, one of CLUSTER_M_TILES
    cluster: int               # ranks of a cluster, one of CLUSTER_SIZES
    k_per_rank: int            # k-range of a rank, a multiple of CLUSTER_K
    grid: Tuple[int, int]      # (ranks, column tiles): a cluster is one column tile
    threads: int
    stages: int
    smem_bytes: int            # dynamic shared memory of a block


def cluster_stages(m_tiles: int) -> int:
    """Stages of the ring: the most, at most 8, at which three blocks fit an
    SM (``CLUSTER_BLOCK_SMEM`` each): 8 (64 KB of codes in flight a block) at
    M <= 8, 5 at M <= 40, 4 at M <= 64. Two blocks an SM are launched; the
    room for a third lets clusters of 8 pack into the GPCs in one wave."""
    stage = CLUSTER_K * CLUSTER_N + m_tiles * 8 * CLUSTER_K * 2
    return min(8, (CLUSTER_BLOCK_SMEM - 1024) // (stage + 16))


def cluster_smem_bytes(m_tiles: int) -> int:
    """The ring (codes and x a stage), its two barriers a stage, 1 KB to align
    the ring to the swizzle atom. The partial sum reuses the ring."""
    stages = cluster_stages(m_tiles)
    return stages * (CLUSTER_K * CLUSTER_N + m_tiles * 8 * CLUSTER_K * 2) + 2 * stages * 8 + 1024


def cluster_plan(M: int, K: int, N: int) -> ClusterPlan:
    """Geometry of one bf16 call at ``M <= 64``. The cluster size C is the
    one whose ``n_tiles * C`` blocks come nearest two blocks on every SM
    (``CLUSTER_BLOCKS_PER_SM * SM_COUNT``; the smaller C on a tie), among the
    sizes at which every rank streams at least ``MIN_RANK_TILES`` k-tiles and
    none is empty: a larger C adds a cluster barrier and a reduction through
    distributed shared memory, a smaller one leaves SMs idle
    (``scripts/int8_decode_times.py --sweep`` times every C at the decode
    shapes). At the Llama-2-7B decode shapes:
    (4096, 4096) C=8, 8 k-tiles a rank, 256 blocks; (4096, 11008) C=4, 16,
    344; (11008, 4096) C=8, 22, 256; (4096, 32000) C=1, 64, 250."""
    if not 1 <= M <= CLUSTER_MAX_M:
        raise ValueError(f"int8 matmul kernel: M={M} is not in the cluster kernel's 1..64")
    m_tiles = min(t for t in CLUSTER_M_TILES if 8 * t >= M)
    k_tiles = -(-K // CLUSTER_K)
    n_tiles = -(-N // CLUSTER_N)
    fits = [c for c in CLUSTER_SIZES
            if k_tiles >= c * MIN_RANK_TILES and (c - 1) * -(-k_tiles // c) < k_tiles] or [1]
    cluster = min(fits, key=lambda c: abs(n_tiles * c - CLUSTER_BLOCKS_PER_SM * SM_COUNT))
    return ClusterPlan(m_tiles, cluster, -(-k_tiles // cluster) * CLUSTER_K, (cluster, n_tiles),
                       CLUSTER_THREADS, cluster_stages(m_tiles), cluster_smem_bytes(m_tiles))


def check_cluster_plan(plan: ClusterPlan, M: int, K: int, N: int) -> None:
    """Raise unless ``plan`` is one the cluster kernel takes for this call:
    the constants of an instantiation, a K-split that covers K with no empty
    rank, one cluster a column tile. The launcher refuses the same."""
    m_tiles, cluster, k_per_rank, grid, threads, stages, smem = plan
    bad = []
    if m_tiles not in CLUSTER_M_TILES or 8 * m_tiles < M:
        bad.append(f"m_tiles={m_tiles}")
    if cluster not in CLUSTER_SIZES:
        bad.append(f"cluster={cluster}")
    if (k_per_rank <= 0 or k_per_rank % CLUSTER_K or k_per_rank * cluster < K
            or k_per_rank * (cluster - 1) >= K):
        bad.append(f"k_per_rank={k_per_rank}")
    if tuple(grid) != (cluster, -(-N // CLUSTER_N)):
        bad.append(f"grid={tuple(grid)}")
    if threads != CLUSTER_THREADS:
        bad.append(f"threads={threads}")
    if m_tiles in CLUSTER_M_TILES and (stages != cluster_stages(m_tiles)
                                       or smem != cluster_smem_bytes(m_tiles)):
        bad.append(f"stages={stages}, smem_bytes={smem}")
    if smem > MAX_SMEM_BYTES:
        bad.append(f"smem_bytes={smem} > {MAX_SMEM_BYTES}")
    if bad:
        raise ValueError(f"int8 matmul kernel: the plan for M={M} K={K} N={N} is not the "
                         f"cluster kernel's: {', '.join(bad)}")


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
    if M <= CLUSTER_MAX_M:
        raise ValueError(f"int8 matmul kernel: M={M} belongs to the cluster (split-K) kernel")
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
    global LAUNCHES
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
    kind = regime(M, x.dtype == torch.bfloat16)
    if kind == "cluster":
        plan = cluster_plan(M, K, N)
        check_cluster_plan(plan, M, K, N)
    # the device last, so that every other refusal can be seen without a card
    if device.type != "cuda":
        raise ValueError(f"int8 matmul kernel: x is on {device}, expected a CUDA device")
    if q.device != device or scale.device != device:
        raise ValueError(f"int8 matmul kernel: q on {q.device}, scale on {scale.device}, "
                         f"x on {device}")

    out = torch.empty((M, N), device=device, dtype=out_dtype)
    out_f32 = int(out_dtype == torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "cluster":
            rc = _lib().int8_matmul_cluster_launch(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, out_f32,
                plan.m_tiles, plan.cluster, plan.k_per_rank, plan.grid[1], plan.threads,
                plan.stages, plan.smem_bytes, stream,
            )
        elif kind == "tiled":
            tiles = tile_plan(M, K, N)
            rc = _lib().int8_matmul_tiled_launch(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N,
                out_f32, tiles.tile_m, tiles.grid[0], tiles.grid[1], tiles.smem_bytes, stream,
            )
        else:
            rc = _lib().int8_matmul_f32_launch(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N,
                out_f32, stream,
            )
    if rc != 0:
        raise RuntimeError(f"int8 matmul kernel: launch failed with CUDA error {rc}")
    LAUNCHES += 1
    REGIME_LAUNCHES[kind] += 1
    return out
