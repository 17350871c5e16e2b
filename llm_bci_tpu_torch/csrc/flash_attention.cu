// Banded flash attention for sm_90a: forward, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of llm_bci_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel      (via _flash_fwd)
//   flash_dq_kernel   <- _bwd_dq_kernel   (via _flash_bwd)
//   flash_dkv_kernel  <- _bwd_dkv_kernel  (via _flash_bwd)
//
// What they compute. Self-attention over (B, T, H, D) tensors where key j is
// visible to query i iff  i - bwd <= j <= i + fwd  and key_valid[b, j] != 0.
// There is no self-attend diagonal: a query with no visible key gives out = 0
// and lse = -1e30, and every gradient of that row is 0. The mask is evaluated
// from positions inside the kernels and never exists as a tensor. Attention-
// probability dropout uses a counter-based integer hash of (seed, b*H+h,
// q_pos, k_pos), bit for bit the JAX package's _keep_mask, so the backward
// kernels regenerate the forward's mask from coordinates alone. The softmax
// normaliser l sums the undropped probabilities; only the value product sees
// p * keep / (1 - p_drop). The backward recomputes p = exp(s - lse) and takes
// delta = rowsum(dO * O) from the caller.
//
// Design on this card. The TPU kernels make the key sweep a sequential grid
// dimension with the softmax state in scratch memory across grid steps. Here
// blocks run in parallel and nothing carries between them, so the sweep is a
// loop inside one block: a block owns a tile of 64 queries (forward, dQ) or
// of 64 keys (dK/dV; no atomics, each block owns its sums) and walks over the
// tiles of the other side that intersect the band; tiles wholly outside the
// band are never loaded. The running max, the normaliser and the output
// accumulators live in registers; p and ds are rounded to the input type
// before their products, as the TPU kernels do.
//
// * Forward, bf16, D = 64 or 128 (`fwd_wg::flash_fwd_wgmma_kernel`): one
//   consumer warpgroup owns the 64 queries and runs wgmma. s = Q K^T is
//   m64n64k16 with Q and K read K-major from 128-byte-swizzled shared memory;
//   o += P V takes P as the A operand from registers (the accumulator
//   fragment of s, packed to bf16 pairs, is already in the A-fragment layout,
//   so the probabilities never touch shared memory) and V, D-contiguous, as
//   the MN-major B operand with the transpose flag. A fifth warp keeps 4-D TMA
//   loads of K and of V one tile ahead in rings of two, handed back and forth
//   through mbarriers; rows past T arrive as zeros. The score product of tile
//   j + 1 and the value product of tile j are in flight while the warps turn
//   the scores of tile j + 1 into probabilities; the key_valid words of that
//   tile are loaded before the products are started and read after them. A
//   tile wholly inside the band whose keys are all valid skips the visibility
//   test; the exponentials are exp2 with scale * log2(e) folded into one fma
//   (lse stays in natural log).
//   Two blocks an SM (80 KB of shared memory each at D = 128) let one block's
//   softmax overlap the other's products.
// * Forward at D = 32 and for float32, dQ and dK/dV: 4 warps of 16 rows each,
//   mma.sync.m16n8k16 (bf16 inputs, float32 accumulate) with fragments read by
//   ldmatrix from padded shared-memory tiles, loaded synchronously. float32
//   inputs take the same code with the products on the CUDA cores in full
//   float32 (a slow path meant for holding the kernels tightly against the
//   plain version). D = 32 is half a swizzle row and stays here.
//
// Bound: operations (4*T^2*D per head forward, 10*T^2*D backward, against
// 3-4 tensors of T*D bytes); measured times beside the bounds are in PERF.md.
// What holds the wgmma forward from its bound: the softmax and, with dropout,
// the keep hash (about 10 integer operations an entry, the bits may not
// change) are instruction work of one warpgroup that only the SM's second
// block overlaps with the products, and a 64 x 64 score tile is a small wgmma.
// What holds the backward kernels: every warp reads the whole K and V tile
// out of shared memory for its 16 rows, about 2.4 bytes of fragments for each
// byte the 128 B/clock shared-memory port could pair with one mma; tiles are
// loaded synchronously, so loads overlap compute only across the blocks
// resident on an SM; s and dp are recomputed in both kernels; and mma.sync
// reaches about two thirds of the wgmma rate at best.
//
// The tensors are read in the public (B, T, H, D) layout (row stride H*D), so
// no transposed copy is made. D must be 32, 64 or 128 here; the Python
// wrapper zero-pads other head sizes. Every launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;   // 4 warps, 16 rows of the block's tile each
constexpr int TILE = 64;       // rows of the block's own tile, and keys per step
constexpr int QSTEP = 32;      // queries per step of the dK/dV kernel

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* valid;   // (B, T) or nullptr (all keys valid)
  const int* seed;    // one int32 on the device
  const float* delta; // (B, H, T)
  void* out;
  float* lse;         // (B, H, T)
  void* dq;
  void* dk;
  void* dv;
  int B, T, H;
  int fwd, bwd;
  float scale;
  uint32_t thresh;
  float inv_keep;
  int use_drop;
};

template <typename T>
struct Pad {
  static constexpr int value = 16 / sizeof(T);   // 16 bytes of padding a row
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The JAX package's _keep_mask in uint32 arithmetic.
__device__ __forceinline__ bool keep_mask(uint32_t seed, uint32_t bh, uint32_t q_pos,
                                          uint32_t k_pos, uint32_t thresh) {
  uint32_t x = (q_pos * 0x9E3779B1u) ^ (k_pos * 0x85EBCA77u);
  x ^= bh * 0xC2B2AE3Du;
  x += seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// Rows [row0, row0 + ROWS) of a matrix with HD columns and `stride` elements
// between rows go to shared memory with HD + Pad columns a row; rows at or
// beyond n_rows are filled with zeros. 16 bytes a thread and access.
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long stride, int row0,
                                          int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LDS = HD + Pad<T>::value;
  constexpr int VPR = HD / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const int4*>(src + (long)(row0 + r) * stride + c);
    }
    *reinterpret_cast<int4*>(dst + r * LDS + c) = val;
  }
}

// Four 8x8 bf16 matrices from shared memory into the fragment layout of
// mma.m16n8k16: lane l gives the address of row l % 8 of matrix l / 8
// (16 bytes, 16-byte aligned). The .trans form transposes each matrix, which
// turns rows of keys into the k-major B fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc (16 x 8*NT) += A (16 x K) * B (K x 8*NT), operands in shared
// memory. A is row-major, A(m, k) = A[m*lda + k]. B(k, n) is B[n*ldb + k]
// when B_KCONTIG, else B[k*ldb + n]. The accumulators have the layout of the
// mma.m16n8k16 C fragment for both types: with g = lane / 4 and t = lane % 4,
// acc[nt][0..1] is row g, columns nt*8 + 2t and +1, acc[nt][2..3] row g + 8.
// NT is even. bf16 fragments come from shared memory through ldmatrix.
template <typename T, int NT, bool B_KCONTIG>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const T* A, int lda, const T* B,
                                          int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    for (int k = 0; k < K; ++k) {
      const float a_lo = A[g * lda + k];
      const float a_hi = A[(g + 8) * lda + k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t;
        const float b0 = B_KCONTIG ? B[n * ldb + k] : B[k * ldb + n];
        const float b1 = B_KCONTIG ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
        acc[nt][0] += a_lo * b0;
        acc[nt][1] += a_lo * b1;
        acc[nt][2] += a_hi * b0;
        acc[nt][3] += a_hi * b1;
      }
    }
  } else {
    // ldmatrix addresses of this lane: matrix l / 8, row l % 8
    const int a_row = lane & 15;             // A: rows 0-15, then the k + 8 half
    const int a_col = (lane >> 4) * 8;
    const int b_sub = ((lane >> 3) & 1) * 8 + (B_KCONTIG ? 0 : (lane & 7));   // along k
    const int b_n = (lane >> 4) * 8 + (B_KCONTIG ? (lane & 7) : 0);           // along n
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, A + a_row * lda + k0 + a_col);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // b[0..1]: the B fragment of n-tile nt, b[2..3]: of n-tile nt + 1
        uint32_t b[4];
        if (B_KCONTIG) {
          ldsm_x4(b, B + (nt * 8 + b_n) * ldb + k0 + b_sub);
        } else {
          ldsm_x4_trans(b, B + (k0 + b_sub) * ldb + nt * 8 + b_n);
        }
        mma_bf16(acc[nt], a, b[0], b[1]);
        mma_bf16(acc[nt + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
}

// Shared-memory sizes in bytes (every part a multiple of 16).
template <typename T, int HD>
constexpr size_t fwd_smem() {
  return sizeof(T) * (3 * TILE * (HD + Pad<T>::value) + TILE * (TILE + Pad<T>::value)) +
         sizeof(int) * TILE;
}
template <typename T, int HD>
constexpr size_t dq_smem() {
  return sizeof(T) * (4 * TILE * (HD + Pad<T>::value) + TILE * (TILE + Pad<T>::value)) +
         sizeof(int) * TILE;
}
template <typename T, int HD>
constexpr size_t dkv_smem() {
  return sizeof(T) * ((2 * TILE + 2 * QSTEP) * (HD + Pad<T>::value) +
                      2 * TILE * (QSTEP + Pad<T>::value)) +
         sizeof(float) * 2 * QSTEP;
}

// ---------------------------------------------------------------------------
// Forward: one block per (batch*head, tile of 64 queries)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FlashParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = HD + Pad<T>::value;
  constexpr int LDP = TILE + Pad<T>::value;
  constexpr int NS = TILE / 8;
  constexpr int NO = HD / 8;
  const int n_tiles = (p.T + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * TILE;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const long stride = (long)p.H * HD;
  const long base = ((long)b * p.T * p.H + h) * HD;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  T* out = static_cast<T*>(p.out) + base;

  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + TILE * LDS;
  T* sV = sK + TILE * LDS;
  T* sP = sV + TILE * LDS;
  int* sValid = reinterpret_cast<int*>(sP + TILE * LDP);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const uint32_t seed = p.use_drop ? (uint32_t)(*p.seed) : 0u;

  load_tile<T, TILE, HD>(sQ, q, stride, q0, p.T);

  float o[NO][4];
  zero_acc<NO>(o);
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  const int k_lo = max(q0 - p.bwd, 0);
  const int k_hi = min(q0 + TILE - 1 + p.fwd, p.T - 1);
  for (int kt = k_lo / TILE; kt <= k_hi / TILE; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();   // the previous step has finished with sK, sV, sValid
    load_tile<T, TILE, HD>(sK, k, stride, k0, p.T);
    load_tile<T, TILE, HD>(sV, v, stride, k0, p.T);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const int j = k0 + i;
      sValid[i] = (j < p.T) && (p.valid == nullptr || p.valid[(long)b * p.T + j] != 0);
    }
    __syncthreads();

    float s[NS][4];
    zero_acc<NS>(s);
    warp_gemm<T, NS, true>(s, sQ + warp * 16 * LDS, LDS, sK, LDS, HD);

    uint32_t vis = 0u;
    float row_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = nt * 8 + 2 * t + (e & 1);
        const int k_pos = k0 + col;
        const int q_pos = q0 + row[r];
        const bool visible =
            sValid[col] != 0 && k_pos >= q_pos - p.bwd && k_pos <= q_pos + p.fwd;
        const float val = visible ? s[nt][e] * p.scale : NEG_INF;
        s[nt][e] = val;
        if (visible) vis |= 1u << (nt * 4 + e);
        row_max[r] = fmaxf(row_max[r], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(row_max[r]));
      // alpha is forced to 0 while no key has been seen yet
      alpha[r] = (m_run[r] <= NEG_INF) ? 0.f : expf(fminf(m_run[r] - m_new, 0.f));
      m_run[r] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = nt * 8 + 2 * t + (e & 1);
        // masked entries are set to 0 after the exp, so a step with no
        // visible key adds nothing
        float pr = ((vis >> (nt * 4 + e)) & 1u) ? expf(s[nt][e] - m_run[r]) : 0.f;
        row_sum[r] += pr;
        if (p.use_drop) {
          const bool keep = keep_mask(seed, (uint32_t)bh, (uint32_t)(q0 + row[r]),
                                      (uint32_t)(k0 + col), p.thresh);
          pr = keep ? pr * p.inv_keep : 0.f;
        }
        sP[row[r] * LDP + col] = from_float<T>(pr);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + quad_sum(row_sum[r]);
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    __syncwarp();   // a warp reads only the rows of sP that it wrote
    warp_gemm<T, NO, false>(o, sP + warp * 16 * LDP, LDP, sV, LDS, TILE);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = q0 + row[r];
    if (q_pos >= p.T) continue;
    const bool live = l_run[r] > 0.f;
    const float inv = live ? 1.f / l_run[r] : 1.f;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int col = nt * 8 + 2 * t;
      out[(long)q_pos * stride + col] = from_float<T>(o[nt][2 * r] * inv);
      out[(long)q_pos * stride + col + 1] = from_float<T>(o[nt][2 * r + 1] * inv);
    }
    if (t == 0) {
      p.lse[(long)bh * p.T + q_pos] = live ? m_run[r] + logf(l_run[r]) : NEG_INF;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward, bf16, head sizes 64 and 128: one consumer warpgroup per
// (batch*head, tile of 64 queries) runs wgmma; one more warp keeps the TMA
// loads of K and V two tiles ahead.
// ---------------------------------------------------------------------------

namespace fwd_wg {

constexpr int STAGES = 2;                // K tiles and V tiles in their rings
constexpr int CONSUMERS = 128;
constexpr int FWD_THREADS = CONSUMERS + 32;
constexpr int BARRIER_BYTES = 64;        // 4 * STAGES mbarriers
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A 64-row tile of HD bf16 columns in shared memory: HD / 64 blocks of 64
// rows x 128 bytes, swizzled, each block one TMA box. Q and K are read
// K-major from it (the head dimension is the product's k), V MN-major (the
// head dimension is n).
template <int HD>
__host__ __device__ constexpr int tile_bytes() { return TILE * HD * 2; }
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * STAGES) * tile_bytes<HD>() + BARRIER_BYTES + 1024;
}

// 2^x in one instruction; results below 2^-126 are flushed to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + 64) of head h of example b; rows at or beyond T arrive as
// zeros.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int row0, int h,
                                          int b, uint32_t bar) {
#pragma unroll
  for (int d = 0; d < HD / 64; ++d) {
    hopper::tma_load_4d(dst + d * (TILE * 128), map, d * 64, h, row0, b, bar);
  }
}

// Key tile j of the sweep is multiplied in three pieces. While the tensor
// cores run s = Q K_j+1^T and o += P_j V_j, the warps turn the scores of
// tile j + 1 into probabilities (mask, running max, exp2, dropout), all in
// the registers of the s fragment; only then do they wait for the value
// product, rescale o and pack the probabilities into the A fragments of the
// next value product.
template <int HD>
__global__ void __launch_bounds__(FWD_THREADS, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, FlashParams p) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  constexpr int TB = tile_bytes<HD>();
  constexpr int NO = HD / 2;             // output accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sQ = smem_u32(base);
  const uint32_t sK = sQ + TB;                     // STAGES tiles
  const uint32_t sV = sK + STAGES * TB;            // STAGES tiles
  const uint32_t k_full = sV + STAGES * TB;        // STAGES barriers each
  const uint32_t k_empty = k_full + STAGES * 8;
  const uint32_t v_full = k_empty + STAGES * 8;
  const uint32_t v_empty = v_full + STAGES * 8;

  const int n_tiles = (p.T + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * TILE;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k_lo = max(q0 - p.bwd, 0);
  const int k_hi = min(q0 + TILE - 1 + p.fwd, p.T - 1);
  const int kt_lo = k_lo / TILE;
  const int n_steps = k_hi / TILE - kt_lo + 1;     // at least 1

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4 * STAGES; ++i) mbar_init(k_full + i * 8, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      for (int it = 0; it < n_steps; ++it) {
        const int slot = it % STAGES;
        const int round = it / STAGES;
        const int k0 = (kt_lo + it) * TILE;
        if (round > 0) mbar_wait(k_empty + slot * 8, (round - 1) & 1);
        mbar_arrive_expect_tx(k_full + slot * 8, it == 0 ? 2 * TB : TB);
        if (it == 0) load_tile<HD>(sQ, &tm_q, q0, h, b, k_full);
        load_tile<HD>(sK + slot * TB, &tm_k, k0, h, b, k_full + slot * 8);
        if (round > 0) mbar_wait(v_empty + slot * 8, (round - 1) & 1);
        mbar_arrive_expect_tx(v_full + slot * 8, TB);
        load_tile<HD>(sV + slot * TB, &tm_v, k0, h, b, v_full + slot * 8);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_pos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint32_t seed = p.use_drop ? (uint32_t)(*p.seed) : 0u;
  const uint32_t q_hash[2] = {(uint32_t)q_pos[0] * 0x9E3779B1u, (uint32_t)q_pos[1] * 0x9E3779B1u};
  const uint32_t bh_hash = (uint32_t)bh * 0xC2B2AE3Du;
  const float c_log2 = p.scale * LOG2E;
  const int* valid = p.valid != nullptr ? p.valid + (long)b * p.T : nullptr;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t pa[4][4];
  // running max in units of log2 (scores times scale * log2(e)) and normaliser
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  float alpha[2] = {0.f, 0.f};

  // s = Q K^T of ring slot `slot`: 64 x 64, float32, one wgmma group
  auto start_scores = [&](int slot) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (TILE * 128) + (kk & 3) * 32;
      wgmma_ss_n64(s, make_desc(sQ + off, 16, 1024), make_desc(sK + slot * TB + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  };
  // o += P V of ring slot `slot`, P from registers, V MN-major: 16 keys a step
  auto start_values = [&](int slot) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint64_t dv = make_desc(sV + slot * TB + kk * (16 * 128), TILE * 128, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128_bt(o, pa[kk], dv, 1);
      } else {
        wgmma_rs_n64_bt(o, pa[kk], dv, 1);
      }
    }
    wgmma_commit();
  };
  // The validity words of keys k0 + lane and k0 + 32 + lane (1 where there is
  // no key_valid, 0 past T); loaded ahead, so that the products cover the
  // loads' latency.
  auto load_valid = [&](int k0, int& v0, int& v1) {
    const int j0 = k0 + lane;
    const int j1 = j0 + 32;
    v0 = j0 < p.T ? (valid == nullptr ? 1 : valid[j0]) : 0;
    v1 = j1 < p.T ? (valid == nullptr ? 1 : valid[j1]) : 0;
  };
  // Bit j of the pair: key k0 + j (lo) or k0 + 32 + j (hi) exists and is valid.
  auto key_bits = [&](int v0, int v1, uint32_t& lo, uint32_t& hi) {
    lo = __ballot_sync(0xffffffffu, v0 != 0);
    hi = __ballot_sync(0xffffffffu, v1 != 0);
  };
  // The scores of key tile k0 in s become probabilities p = exp2(s * c - m)
  // in place, dropped and rescaled where dropout is on; m_run, l_run and
  // alpha (the factor the running output owes to the new max) are updated.
  // The normaliser sums the undropped probabilities.
  auto softmax = [&](int k0, uint32_t lo, uint32_t hi) {
    // A tile wholly inside the band whose keys are all valid needs no
    // visibility test; any other tile masks entry by entry.
    const bool inside = k0 >= q0 + TILE - 1 - p.bwd && k0 + TILE - 1 <= q0 + p.fwd;
    if (!(inside && (lo & hi) == 0xffffffffu)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t bits = (j < 4 ? lo : hi) >> ((j & 3) * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k_pos = k0 + j * 8 + 2 * t + (e & 1);
          const int qp = q_pos[e >> 1];
          const bool visible =
              ((bits >> (e & 1)) & 1u) != 0u && k_pos >= qp - p.bwd && k_pos <= qp + p.fwd;
          if (!visible) s[4 * j + e] = NEG_INF;
        }
      }
    }
    float raw_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      raw_max[0] = fmaxf(raw_max[0], fmaxf(s[4 * j], s[4 * j + 1]));
      raw_max[1] = fmaxf(raw_max[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rm = quad_max(raw_max[r]);
      const float m_new = fmaxf(m_run[r], rm <= NEG_INF ? NEG_INF : rm * c_log2);
      // alpha is forced to 0 while no key has been seen yet
      alpha[r] = (m_run[r] <= NEG_INF) ? 0.f : exp2f(fminf(m_run[r] - m_new, 0.f));
      m_run[r] = m_new;
      // with no key seen so far every entry of the row is masked, and
      // exp2(-1e30 * c - 0) is 0 as it must be
      m_use[r] = (m_new <= NEG_INF) ? 0.f : m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = exp2_approx(fmaf(s[4 * j + e], c_log2, -m_use[e >> 1]));
        row_sum[e >> 1] += pr;
        s[4 * j + e] = pr;
      }
      if (p.use_drop) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the JAX package's _keep_mask of (seed, b*H+h, q_pos, k_pos)
          const uint32_t k_pos = (uint32_t)(k0 + j * 8 + 2 * t + (e & 1));
          uint32_t x = q_hash[e >> 1] ^ ((k_pos * 0x85EBCA77u) ^ bh_hash);
          x += seed;
          x ^= x >> 16;
          x *= 0x7FEB352Du;
          x ^= x >> 15;
          x *= 0x846CA68Bu;
          x ^= x >> 16;
          s[4 * j + e] = x >= p.thresh ? s[4 * j + e] * p.inv_keep : 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + quad_sum(row_sum[r]);
  };
  // The running output takes the new max; the probabilities, rounded to
  // bf16, become the 4 A fragments of the value product.
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };

  uint32_t lo, hi;
  int v0, v1;
  load_valid(kt_lo * TILE, v0, v1);
  mbar_wait(k_full, 0);              // Q and the first K tile
  start_scores(0);
  wgmma_wait<0>();
  fence_operand(s);
  if (threadIdx.x == 0) mbar_arrive(k_empty);
  key_bits(v0, v1, lo, hi);
  softmax(kt_lo * TILE, lo, hi);
  rescale_and_pack();

  for (int it = 0; it + 1 < n_steps; ++it) {
    const int slot = it % STAGES;
    const int next = (it + 1) % STAGES;
    const int k0_next = (kt_lo + it + 1) * TILE;
    load_valid(k0_next, v0, v1);
    mbar_wait(k_full + next * 8, ((it + 1) / STAGES) & 1);
    start_scores(next);
    mbar_wait(v_full + slot * 8, (it / STAGES) & 1);
    start_values(slot);
    wgmma_wait<1>();                 // the scores of tile it + 1
    fence_operand(s);
    if (threadIdx.x == 0) mbar_arrive(k_empty + next * 8);
    key_bits(v0, v1, lo, hi);
    softmax(k0_next, lo, hi);
    wgmma_wait<0>();                 // the value product of tile it
    fence_operand(o);
    if (threadIdx.x == 0) mbar_arrive(v_empty + slot * 8);
    rescale_and_pack();
  }
  const int last = (n_steps - 1) % STAGES;
  mbar_wait(v_full + last * 8, ((n_steps - 1) / STAGES) & 1);
  start_values(last);
  wgmma_wait<0>();
  fence_operand(o);

  const long stride = (long)p.H * HD;
  bf16* out = static_cast<bf16*>(p.out) + ((long)b * p.T * p.H + h) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_pos[r] >= p.T) continue;
    const bool live = l_run[r] > 0.f;
    const float inv = live ? 1.f / l_run[r] : 1.f;
    bf16* dst = out + (long)q_pos[r] * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (t == 0) {
      p.lse[(long)bh * p.T + q_pos[r]] = live ? m_run[r] * LN2 + logf(l_run[r]) : NEG_INF;
    }
  }
}

// Tensor map of one (B, T, H, HD) bf16 tensor, read in boxes of 64 rows of
// one head x 64 columns.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int HD) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)H * HD * 2,
                                 (cuuint64_t)T * H * HD * 2};
  const cuuint32_t box[4] = {64, 1, TILE, 1};
  return hopper::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides,
                                 box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
int launch(const FlashParams& p, int smem_planned, cudaStream_t stream) {
  if (smem_planned != smem_bytes<HD>()) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* tensors[3] = {p.q, p.k, p.v};
  for (int i = 0; i < 3; ++i) {
    if (!tensor_map(&maps[i], tensors[i], p.B, p.T, p.H, HD)) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_planned);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (p.T + TILE - 1) / TILE;
  flash_fwd_wgmma_kernel<HD><<<(unsigned)(n_tiles * p.B * p.H), FWD_THREADS, smem_planned,
                               stream>>>(maps[0], maps[1], maps[2], p);
  return (int)cudaGetLastError();
}

}  // namespace fwd_wg

// ---------------------------------------------------------------------------
// dQ: one block per (batch*head, tile of 64 queries), sweep over key tiles
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_dq_kernel(FlashParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = HD + Pad<T>::value;
  constexpr int LDP = TILE + Pad<T>::value;
  constexpr int NS = TILE / 8;
  constexpr int NO = HD / 8;
  const int n_tiles = (p.T + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * TILE;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const long stride = (long)p.H * HD;
  const long base = ((long)b * p.T * p.H + h) * HD;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const T* dout = static_cast<const T*>(p.dout) + base;
  T* dq = static_cast<T*>(p.dq) + base;

  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + TILE * LDS;
  T* sK = sdO + TILE * LDS;
  T* sV = sK + TILE * LDS;
  T* sdS = sV + TILE * LDS;
  int* sValid = reinterpret_cast<int*>(sdS + TILE * LDP);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const uint32_t seed = p.use_drop ? (uint32_t)(*p.seed) : 0u;

  load_tile<T, TILE, HD>(sQ, q, stride, q0, p.T);
  load_tile<T, TILE, HD>(sdO, dout, stride, q0, p.T);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = q0 + row[r];
    const bool in = q_pos < p.T;
    lse[r] = in ? p.lse[(long)bh * p.T + q_pos] : 0.f;
    delta[r] = in ? p.delta[(long)bh * p.T + q_pos] : 0.f;
  }

  float acc[NO][4];
  zero_acc<NO>(acc);

  const int k_lo = max(q0 - p.bwd, 0);
  const int k_hi = min(q0 + TILE - 1 + p.fwd, p.T - 1);
  for (int kt = k_lo / TILE; kt <= k_hi / TILE; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile<T, TILE, HD>(sK, k, stride, k0, p.T);
    load_tile<T, TILE, HD>(sV, v, stride, k0, p.T);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const int j = k0 + i;
      sValid[i] = (j < p.T) && (p.valid == nullptr || p.valid[(long)b * p.T + j] != 0);
    }
    __syncthreads();

    float s[NS][4], dp[NS][4];
    zero_acc<NS>(s);
    zero_acc<NS>(dp);
    warp_gemm<T, NS, true>(s, sQ + warp * 16 * LDS, LDS, sK, LDS, HD);
    warp_gemm<T, NS, true>(dp, sdO + warp * 16 * LDS, LDS, sV, LDS, HD);

#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = nt * 8 + 2 * t + (e & 1);
        const int k_pos = k0 + col;
        const int q_pos = q0 + row[r];
        const bool visible = sValid[col] != 0 && q_pos < p.T && k_pos >= q_pos - p.bwd &&
                             k_pos <= q_pos + p.fwd;
        const float pr = visible ? expf(s[nt][e] * p.scale - lse[r]) : 0.f;
        float d = dp[nt][e];
        if (p.use_drop) {
          const bool keep =
              keep_mask(seed, (uint32_t)bh, (uint32_t)q_pos, (uint32_t)k_pos, p.thresh);
          d = keep ? d * p.inv_keep : 0.f;
        }
        sdS[row[r] * LDP + col] = from_float<T>(pr * (d - delta[r]));
      }
    }
    __syncwarp();
    warp_gemm<T, NO, false>(acc, sdS + warp * 16 * LDP, LDP, sK, LDS, TILE);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q_pos = q0 + row[r];
    if (q_pos >= p.T) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int col = nt * 8 + 2 * t;
      dq[(long)q_pos * stride + col] = from_float<T>(acc[nt][2 * r] * p.scale);
      dq[(long)q_pos * stride + col + 1] = from_float<T>(acc[nt][2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (batch*head, tile of 64 keys), sweep over query tiles
// of 32. The scores are computed transposed (keys are the rows), so that
// p^T and ds^T come out in the layout of an A operand.
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(FlashParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = HD + Pad<T>::value;
  constexpr int LDQ = QSTEP + Pad<T>::value;
  constexpr int NS = QSTEP / 8;
  constexpr int NO = HD / 8;
  const int n_tiles = (p.T + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * TILE;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const long stride = (long)p.H * HD;
  const long base = ((long)b * p.T * p.H + h) * HD;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const T* dout = static_cast<const T*>(p.dout) + base;
  T* dk = static_cast<T*>(p.dk) + base;
  T* dv = static_cast<T*>(p.dv) + base;

  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + TILE * LDS;
  T* sQ = sV + TILE * LDS;
  T* sdO = sQ + QSTEP * LDS;
  T* sPt = sdO + QSTEP * LDS;
  T* sdSt = sPt + TILE * LDQ;
  float* sLse = reinterpret_cast<float*>(sdSt + TILE * LDQ);
  float* sDelta = sLse + QSTEP;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const uint32_t seed = p.use_drop ? (uint32_t)(*p.seed) : 0u;

  load_tile<T, TILE, HD>(sK, k, stride, k0, p.T);
  load_tile<T, TILE, HD>(sV, v, stride, k0, p.T);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k_pos = k0 + row[r];
    key_ok[r] = k_pos < p.T && (p.valid == nullptr || p.valid[(long)b * p.T + k_pos] != 0);
  }

  float acc_dk[NO][4], acc_dv[NO][4];
  zero_acc<NO>(acc_dk);
  zero_acc<NO>(acc_dv);

  // query i sees key j iff j - fwd <= i <= j + bwd
  const int q_lo = max(k0 - p.fwd, 0);
  const int q_hi = min(k0 + TILE - 1 + p.bwd, p.T - 1);
  for (int qt = q_lo / QSTEP; qt <= q_hi / QSTEP; ++qt) {
    const int q0 = qt * QSTEP;
    __syncthreads();
    load_tile<T, QSTEP, HD>(sQ, q, stride, q0, p.T);
    load_tile<T, QSTEP, HD>(sdO, dout, stride, q0, p.T);
    for (int i = threadIdx.x; i < QSTEP; i += THREADS) {
      const int q_pos = q0 + i;
      const bool in = q_pos < p.T;
      sLse[i] = in ? p.lse[(long)bh * p.T + q_pos] : 0.f;
      sDelta[i] = in ? p.delta[(long)bh * p.T + q_pos] : 0.f;
    }
    __syncthreads();

    float st[NS][4], dpt[NS][4];
    zero_acc<NS>(st);
    zero_acc<NS>(dpt);
    warp_gemm<T, NS, true>(st, sK + warp * 16 * LDS, LDS, sQ, LDS, HD);
    warp_gemm<T, NS, true>(dpt, sV + warp * 16 * LDS, LDS, sdO, LDS, HD);

#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = nt * 8 + 2 * t + (e & 1);
        const int q_pos = q0 + col;
        const int k_pos = k0 + row[r];
        const bool visible = key_ok[r] && q_pos < p.T && k_pos >= q_pos - p.bwd &&
                             k_pos <= q_pos + p.fwd;
        const float pr = visible ? expf(st[nt][e] * p.scale - sLse[col]) : 0.f;
        float pv = pr;
        float d = dpt[nt][e];
        if (p.use_drop) {
          const bool keep =
              keep_mask(seed, (uint32_t)bh, (uint32_t)q_pos, (uint32_t)k_pos, p.thresh);
          pv = keep ? pr * p.inv_keep : 0.f;
          d = keep ? d * p.inv_keep : 0.f;
        }
        sPt[row[r] * LDQ + col] = from_float<T>(pv);
        sdSt[row[r] * LDQ + col] = from_float<T>(pr * (d - sDelta[col]));
      }
    }
    __syncwarp();
    warp_gemm<T, NO, false>(acc_dv, sPt + warp * 16 * LDQ, LDQ, sdO, LDS, QSTEP);
    warp_gemm<T, NO, false>(acc_dk, sdSt + warp * 16 * LDQ, LDQ, sQ, LDS, QSTEP);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k_pos = k0 + row[r];
    if (k_pos >= p.T) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int col = nt * 8 + 2 * t;
      const long at = (long)k_pos * stride + col;
      dk[at] = from_float<T>(acc_dk[nt][2 * r] * p.scale);
      dk[at + 1] = from_float<T>(acc_dk[nt][2 * r + 1] * p.scale);
      dv[at] = from_float<T>(acc_dv[nt][2 * r]);
      dv[at + 1] = from_float<T>(acc_dv[nt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

enum Which { FWD = 0, DQ = 1, DKV = 2 };

// `fwd_smem_planned` is the dynamic shared memory the caller planned for the
// forward kernel; a plan that differs from the kernel's own is refused.
template <typename T, int HD>
int launch(int which, const FlashParams& p, int fwd_smem_planned, cudaStream_t stream) {
  const int n_tiles = (p.T + TILE - 1) / TILE;
  const dim3 grid((unsigned)(n_tiles * p.B * p.H));
  void (*kernel)(FlashParams);
  size_t smem;
  if (which == FWD) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 64) {
      return fwd_wg::launch<HD>(p, fwd_smem_planned, stream);
    } else {
      kernel = flash_fwd_kernel<T, HD>;
      smem = fwd_smem<T, HD>();
      if ((size_t)fwd_smem_planned != smem) return (int)cudaErrorInvalidValue;
    }
  } else if (which == DQ) {
    kernel = flash_dq_kernel<T, HD>;
    smem = dq_smem<T, HD>();
  } else {
    kernel = flash_dkv_kernel<T, HD>;
    smem = dkv_smem<T, HD>();
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int which, int D, const FlashParams& p, int fwd_smem, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(which, p, fwd_smem, stream);
    case 64: return launch<T, 64>(which, p, fwd_smem, stream);
    case 128: return launch<T, 128>(which, p, fwd_smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, int is_bf16, int D, const FlashParams& p, void* stream, int fwd_smem = 0) {
  if (p.B < 1 || p.T < 1 || p.H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(which, D, p, fwd_smem, s)
                 : dispatch_hd<float>(which, D, p, fwd_smem, s);
}

FlashParams make_params(const void* q, const void* k, const void* v, const int* valid,
                        const int* seed, int B, int T, int H, int fwd, int bwd, float scale,
                        unsigned thresh, float inv_keep, int use_drop) {
  FlashParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = valid;
  p.seed = seed;
  p.B = B;
  p.T = T;
  p.H = H;
  p.fwd = fwd;
  p.bwd = bwd;
  p.scale = scale;
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  p.use_drop = use_drop;
  return p;
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: (B, T, H, D) contiguous, bf16 or float32.
// valid: (B, T) int32 or null. seed: one int32 on the device. lse, delta:
// (B, H, T) float32. fwd / bwd: band widths in [0, T]. Each returns the CUDA
// error code of its launch (0 on success).

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const int* valid,
                                const int* seed, void* out, float* lse, int B, int T, int H,
                                int D, int is_bf16, int fwd, int bwd, float scale,
                                unsigned thresh, float inv_keep, int use_drop, int smem_bytes,
                                void* stream) {
  FlashParams p =
      make_params(q, k, v, valid, seed, B, T, H, fwd, bwd, scale, thresh, inv_keep, use_drop);
  p.out = out;
  p.lse = lse;
  return dispatch(FWD, is_bf16, D, p, stream, smem_bytes);
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const int* valid,
                               const int* seed, const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int T, int H, int D,
                               int is_bf16, int fwd, int bwd, float scale, unsigned thresh,
                               float inv_keep, int use_drop, void* stream) {
  FlashParams p =
      make_params(q, k, v, valid, seed, B, T, H, fwd, bwd, scale, thresh, inv_keep, use_drop);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  return dispatch(DQ, is_bf16, D, p, stream);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const int* valid,
                                const int* seed, const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int B, int T, int H,
                                int D, int is_bf16, int fwd, int bwd, float scale,
                                unsigned thresh, float inv_keep, int use_drop, void* stream) {
  FlashParams p =
      make_params(q, k, v, valid, seed, B, T, H, fwd, bwd, scale, thresh, inv_keep, use_drop);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return dispatch(DKV, is_bf16, D, p, stream);
}
