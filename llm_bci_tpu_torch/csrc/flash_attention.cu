// Banded flash attention for sm_90a: forward, delta, dQ and dK/dV kernels.
//
// Replaces the Pallas TPU kernels of llm_bci_tpu/ops/flash_attention.py:
//   flash_fwd_kernel, fwd_wg::flash_fwd_wgmma_kernel  <- _fwd_kernel     (via _flash_fwd)
//   flash_dq_kernel, bwd_wg::flash_dq_wgmma_kernel    <- _bwd_dq_kernel  (via _flash_bwd)
//   flash_dkv_kernel, bwd_wg::flash_dkv_wgmma_kernel  <- _bwd_dkv_kernel (via _flash_bwd)
//   flash_delta_kernel  <- delta = sum(out * do) in _flash_bwd, which XLA fuses
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
// p * keep / (1 - p_drop). The backward recomputes p = exp(s * scale - lse),
// takes dp = dO V^T * keep / (1 - p_drop) and ds = p * (dp - delta) with
// delta = rowsum(dO * O), and gives dq = scale * ds K, dk = scale * ds^T Q,
// dv = (p * keep / (1 - p_drop))^T dO; p and ds are rounded to the input type
// before their products, as the TPU kernels do.
//
// Design on this card. The TPU kernels make the sweep a sequential grid
// dimension with the state in scratch memory across grid steps. Here blocks
// run in parallel and nothing carries between them, so the sweep is a loop
// inside one block: a block owns a tile of queries (forward, dQ) or of keys
// (dK/dV; no atomics, each block owns its sums, so one seed gives the same
// bits every run) and walks over the tiles of the other side that intersect
// the band; tiles wholly outside the band are never loaded. Running max,
// normaliser and accumulators live in registers.
//
// bf16 at D = 64 and 128 runs wgmma on 64-row tiles in 128-byte-swizzled
// shared memory, filled by 4-D TMA loads over the public (B, T, H, D) layout
// (rows past T arrive as zeros) and handed over through mbarriers. In all
// three kernels the probabilities never touch shared memory: the accumulator
// fragment of a score product, packed to bf16 pairs, is already the register A
// operand of the next product, whose B operand is a D-contiguous tile read
// MN-major (transpose flag). A tile wholly inside the band whose keys are all
// valid skips the visibility test; the exponentials are exp2 with scale *
// log2(e) folded into one fma and lse scaled once a row.
// * Forward (`fwd_wg::flash_fwd_wgmma_kernel`): one consumer warpgroup owns
//   64 queries; a fifth warp keeps K and V rings of two ahead. The score
//   product of tile j + 1 and the value product of tile j are in flight while
//   the warps turn the scores of tile j + 1 into probabilities. Two blocks an
//   SM let one block's softmax overlap the other's products.
// * dQ (`bwd_wg::flash_dq_wgmma_kernel`): one warpgroup owns 64 queries; Q
//   and dO stay, K tiles go through a ring of three (a K tile serves s = Q K^T
//   of one step and, read again MN-major, dq += ds K of the next) and V tiles
//   through a ring of one or two (free as soon as dp = dO V^T is done, which
//   is committed first). The products of tile j + 1 and the dq product of
//   tile j are in flight while the warps turn s and dp of tile j + 1 into ds.
//   The warpgroup's first thread issues the TMA loads itself: a wgmma group is
//   one operation of the whole warpgroup, so once that thread has waited for
//   it the tile is free. Two blocks of 128 threads an SM leave a thread 255
//   registers; with a fifth warp the compiler allowed 168 and serialised the
//   products.
// * dK/dV (`bwd_wg::flash_dkv_wgmma_kernel`): a block owns 128 keys, 64 to
//   each of two warpgroups that share a ring of four (Q, dO) tile pairs. Keys
//   are the rows: s^T = K Q^T and dp^T = V dO^T with K / V as the A operand,
//   then dv += p^T dO and dk += ds^T Q from registers. lse and delta belong
//   to the columns and are staged in shared memory a tile ahead. dk and dv
//   take 128 registers a thread at D = 128, so a step of the sweep takes 32
//   queries (half a tile): s^T and dp^T of 64 x 32 and their packed copies
//   fit beside them. A third warpgroup that only loads, with setmaxnreg
//   moving its registers to the other two, did not help: the compiler places
//   wgmma accumulators within the register count the kernel is launched with
//   (168 at 384 threads). So the block's first thread loads here too, and
//   nothing branches on what one warpgroup's keys can see, because a wgmma
//   under a condition that differs between warpgroups is serialised as well.
//   While one warpgroup turns its scores into p^T and ds^T the other's
//   products run (packing the next step's operands while a step's dv and dk
//   products are still in flight was tried: the compiler serialises a wgmma
//   whose register operand is written inside the pipeline stage). At D = 64
//   two blocks share an SM. dq, dk and dv are staged through a tile the block no longer
//   reads, so that a warp stores whole 128-byte lines.
// * D = 32 and float32 (`flash_fwd_kernel`, `flash_dq_kernel`,
//   `flash_dkv_kernel`): 4 warps of 16 rows each, mma.sync.m16n8k16 (bf16
//   inputs, float32 accumulate) with fragments read by ldmatrix from padded
//   shared-memory tiles, loaded synchronously; dK/dV steps over 32 queries.
//   float32 inputs take the same code with the products on the CUDA cores in
//   full float32 (a slow path meant for holding the kernels tightly against
//   the plain version). D = 32 is half a swizzle row and stays here.
// * `flash_delta_kernel`: every dtype and head size; reads out and dout once,
//   16 bytes a thread, sums in float32 and writes the (B, H, T) layout of lse.
//
// Bounds: operations for the attention kernels (4*T^2*D per head forward,
// 6*T^2*D for dQ, 8*T^2*D for dK/dV, against 4-6 tensors of T*D elements),
// bytes for delta; measured times beside the bounds are in PERF.md. What holds
// the wgmma kernels from their bounds: turning scores into probabilities (and
// ds) is instruction work of the same warps that issue the products: exp2,
// about 12 integer operations an entry for the keep hash (the bits may not
// change), the multiply-adds of ds. In the forward and dQ only the SM's
// second block and the products already in flight cover it; in dK/dV only the
// other warpgroup, since dk and dv leave no registers for a second set of
// scores. s and dp are recomputed in both backward kernels, and a 64 x 64 or
// 64 x 32 score tile is a small wgmma whose A operand is read from shared
// memory again for every tile.
//
// D must be 32, 64 or 128 here; the Python wrapper zero-pads other head
// sizes. Every launcher returns cudaGetLastError().

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

enum Which { FWD = 0, DQ = 1, DKV = 2 };

// What the host planned for a kernel. A launcher refuses a plan that differs
// from the kernel's own; the forward states its shared memory only.
struct Planned {
  int rows;      // rows a block owns: queries (dQ) or keys (dK/dV)
  int stages;    // tiles of the swept side in shared memory at a time
  int threads;   // threads of a block
  int smem;      // dynamic shared memory of a block
  int blocks;    // blocks an SM
  bool is(int r, int st, int th, int sm, int bl) const {
    return rows == r && stages == st && threads == th && smem == sm && blocks == bl;
  }
};
constexpr int MAX_SMEM = 232448;   // what one block can use on an H100

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The JAX package's _keep_mask in uint32 arithmetic, after its first line:
// `x` is (q_pos * 0x9E3779B1) ^ (k_pos * 0x85EBCA77) ^ (bh * 0xC2B2AE3D).
__device__ __forceinline__ bool keep_hash(uint32_t x, uint32_t seed, uint32_t thresh) {
  x += seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

__device__ __forceinline__ bool keep_mask(uint32_t seed, uint32_t bh, uint32_t q_pos,
                                          uint32_t k_pos, uint32_t thresh) {
  return keep_hash((q_pos * 0x9E3779B1u) ^ (k_pos * 0x85EBCA77u) ^ (bh * 0xC2B2AE3Du), seed,
                   thresh);
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
// Backward, bf16, head sizes 64 and 128: wgmma kernels fed by TMA rings.
// ---------------------------------------------------------------------------

namespace bwd_wg {

using fwd_wg::exp2_approx;
using fwd_wg::load_tile;
using fwd_wg::LOG2E;
using fwd_wg::tensor_map;
using fwd_wg::tile_bytes;

constexpr int WG = 128;                  // threads of a warpgroup

// dQ: Q, dO, a ring of K tiles (each lives through two steps of the sweep:
// the score product of one and the dq product of the next) and a ring of V
// tiles (free again as soon as dp is done). One warpgroup a block, whose
// first thread also issues the TMA loads: it knows when a tile is free, and
// two blocks of 128 threads an SM leave each thread up to 255 registers, which
// a fifth warp would not.
constexpr int DQ_THREADS = WG;
constexpr int DQ_BLOCKS_PER_SM = 2;
constexpr int DQ_K_STAGES = 3;
template <int HD>
__host__ __device__ constexpr int dq_v_stages() { return HD == 128 ? 1 : 2; }
template <int HD>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (2 + DQ_K_STAGES + dq_v_stages<HD>()) * tile_bytes<HD>() + 128 + 1024;
}

// dK/dV: two warpgroups own 64 keys each of a 128-key tile (K and V loaded
// once) and share a ring of (Q, dO) tile pairs; each keeps two buffers of 64
// lse and 64 delta values. One block an SM at D = 128, where dk and dv alone
// take 128 registers a thread. Two at D = 64: the kernel wants 156 registers
// and gets 128, the compiler spills 64 bytes and waits after each wgmma, and
// with twice the warps to do the per-entry work it still measured faster.
template <int HD>
__host__ __device__ constexpr int dkv_blocks_per_sm() { return HD == 128 ? 1 : 2; }
constexpr int DKV_KEYS = 2 * TILE;
constexpr int DKV_THREADS = 2 * WG;
constexpr int DKV_STAGES = 4;
constexpr int DKV_ROW_BYTES = 2 * 2 * 2 * TILE * 4;   // warpgroups x buffers x (lse, delta)
// Queries a step of the sweep: half a (Q, dO) tile. At D = 128 dk and dv take
// 128 registers a thread, and s^T and dp^T of 64 x 32 with their packed
// copies fit beside them without spills; at D = 64 the shorter step measured
// faster as well.
constexpr int DKV_STEP = 32;
template <int HD>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (4 + 2 * DKV_STAGES) * tile_bytes<HD>() + DKV_ROW_BYTES + 128 + 1024;
}

// lse in units of log2, as the exponent's fma takes it. A row with no visible
// key has lse = -1e30: every entry of it is masked (its score is set to
// -1e30), and with 0 here the exponent stays far below 0 instead of
// overflowing.
__device__ __forceinline__ float lse_log2(float lse) {
  return lse <= NEG_INF ? 0.f : lse * LOG2E;
}

// The 64 x HD accumulator fragment of a warpgroup, times `mul`, goes as bf16
// through a swizzled tile at `stage` (which no product reads any more, and
// only this warpgroup uses) to rows [row0, row0 + 64) of one head at `dst`
// (row stride `stride` elements), so that a warp stores whole 128-byte lines.
// Rows at or beyond n_rows are not written. `tid` is the thread's index in
// the warpgroup, `bar_id` a named barrier of its own.
template <int HD>
__device__ __forceinline__ void store_tile(const float (&acc)[HD / 2], float mul,
                                           unsigned char* stage, __nv_bfloat16* dst,
                                           long stride, int row0, int n_rows, int tid,
                                           int bar_id) {
  using namespace hopper;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      // columns 8j + 2t and + 1: block j / 8, chunk j % 8, 4t bytes into it
      unsigned char* at = stage + (j >> 3) * (TILE * 128) + swizzle128(row, j & 7) + 4 * t;
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
  named_barrier(bar_id, WG);
  constexpr int CPR = HD / 8;              // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < TILE * CPR / WG; ++i) {
    const int idx = i * WG + tid;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    if (row0 + row < n_rows) {
      const int4 val = *reinterpret_cast<const int4*>(stage + (ch >> 3) * (TILE * 128) +
                                                      swizzle128(row, ch & 7));
      *reinterpret_cast<int4*>(dst + (long)(row0 + row) * stride + ch * 8) = val;
    }
  }
}

// Bit j of the pair: key k0 + j (lo) or k0 + 32 + j (hi) exists and is valid.
// Every lane reads two words; called by whole warps.
__device__ __forceinline__ void load_valid(const int* valid, int k0, int n_keys, int lane,
                                           int& v0, int& v1) {
  const int j0 = k0 + lane;
  const int j1 = j0 + 32;
  v0 = j0 < n_keys ? (valid == nullptr ? 1 : valid[j0]) : 0;
  v1 = j1 < n_keys ? (valid == nullptr ? 1 : valid[j1]) : 0;
}

// dQ. One warpgroup owns 64 queries and sweeps over the key tiles
// that cut their band. For key tile j: dp = dO V_j^T and s = Q K_j^T (A and B
// K-major from shared memory), ds = p * (dp * keep / (1 - p_drop) - delta) in
// the registers of the two accumulator fragments, and dq += ds K_j with ds as
// the register A operand and the same K tile read again as the MN-major B
// operand. The products of tile j + 1 and the dq product of tile j are in
// flight while the warps turn the scores of tile j + 1 into ds. A wgmma group
// is one operation of the whole warpgroup: once thread 0 has waited for it,
// no warp reads the tile any more and thread 0 starts the next load into it.
template <int HD>
__global__ void __launch_bounds__(DQ_THREADS, DQ_BLOCKS_PER_SM)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, FlashParams p) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  constexpr int TB = tile_bytes<HD>();
  constexpr int KST = DQ_K_STAGES;
  constexpr int VST = dq_v_stages<HD>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sQ = smem_u32(base);
  const uint32_t sdO = sQ + TB;
  const uint32_t sK = sdO + TB;                    // KST tiles
  const uint32_t sV = sK + KST * TB;               // VST tiles
  const uint32_t k_full = sV + VST * TB;          // KST barriers
  const uint32_t v_full = k_full + KST * 8;        // VST barriers

  const int n_tiles = (p.T + TILE - 1) / TILE;
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * TILE;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k_lo = max(q0 - p.bwd, 0);
  const int k_hi = min(q0 + TILE - 1 + p.fwd, p.T - 1);
  const int kt_lo = k_lo / TILE;
  const int n_steps = k_hi / TILE - kt_lo + 1;     // at least 1

  // K or V tile `it` of the sweep into its ring slot; called by thread 0 once
  // the slot's last reader is done
  auto load_k = [&](int it) {
    if (threadIdx.x != 0 || it >= n_steps) return;
    const uint32_t bar = k_full + (it % KST) * 8;
    mbar_arrive_expect_tx(bar, TB);
    load_tile<HD>(sK + (it % KST) * TB, &tm_k, (kt_lo + it) * TILE, h, b, bar);
  };
  auto load_v = [&](int it) {
    if (threadIdx.x != 0 || it >= n_steps) return;
    const uint32_t bar = v_full + (it % VST) * 8;
    mbar_arrive_expect_tx(bar, TB);
    load_tile<HD>(sV + (it % VST) * TB, &tm_v, (kt_lo + it) * TILE, h, b, bar);
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < KST + VST; ++i) mbar_init(k_full + i * 8, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(k_full, 3 * TB);
    load_tile<HD>(sQ, &tm_q, q0, h, b, k_full);
    load_tile<HD>(sdO, &tm_do, q0, h, b, k_full);
    load_tile<HD>(sK, &tm_k, kt_lo * TILE, h, b, k_full);
    load_v(0);
    for (int it = 1; it < KST; ++it) load_k(it);
    for (int it = 1; it < VST; ++it) load_v(it);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_pos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint32_t seed = p.use_drop ? (uint32_t)(*p.seed) : 0u;
  const uint32_t bh_hash = (uint32_t)bh * 0xC2B2AE3Du;
  const uint32_t q_hash[2] = {((uint32_t)q_pos[0] * 0x9E3779B1u) ^ bh_hash,
                              ((uint32_t)q_pos[1] * 0x9E3779B1u) ^ bh_hash};
  const float c_log2 = p.scale * LOG2E;
  const int* valid = p.valid != nullptr ? p.valid + (long)b * p.T : nullptr;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = q_pos[r] < p.T;
    lse2[r] = in ? lse_log2(p.lse[(long)bh * p.T + q_pos[r]]) : 0.f;
    delta[r] = in ? p.delta[(long)bh * p.T + q_pos[r]] : 0.f;
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t pa[4][4];

  // dp = dO V^T of V slot `vs`, then s = Q K^T of K slot `ks`: two groups, so
  // that the V tile can be handed back before the scores are done
  auto start_scores = [&](int ks, int vs) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (TILE * 128) + (kk & 3) * 32;
      wgmma_ss_n64(dp, make_desc(sdO + off, 16, 1024), make_desc(sV + vs * TB + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (TILE * 128) + (kk & 3) * 32;
      wgmma_ss_n64(s, make_desc(sQ + off, 16, 1024), make_desc(sK + ks * TB + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  };
  // dq += ds K of K slot `ks`, ds from registers, K MN-major: 16 keys a step
  auto start_dq = [&](int ks) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint64_t dk = make_desc(sK + ks * TB + kk * (16 * 128), TILE * 128, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128_bt(dq, pa[kk], dk, 1);
      } else {
        wgmma_rs_n64_bt(dq, pa[kk], dk, 1);
      }
    }
    wgmma_commit();
  };
  // s and dp of key tile k0 become ds, in dp's registers
  auto make_ds = [&](int k0, uint32_t lo, uint32_t hi) {
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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pr = exp2_approx(fmaf(s[4 * j + e], c_log2, -lse2[r]));
        float d = dp[4 * j + e];
        if (p.use_drop) {
          const uint32_t k_pos = (uint32_t)(k0 + j * 8 + 2 * t + (e & 1));
          d = keep_hash(q_hash[r] ^ (k_pos * 0x85EBCA77u), seed, p.thresh) ? d * p.inv_keep : 0.f;
        }
        dp[4 * j + e] = pr * (d - delta[r]);
      }
    }
  };
  // ds, rounded to bf16, becomes the 4 A fragments of the dq product
  auto pack = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j >> 1][(j & 1) * 2] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
    }
  };

  uint32_t lo, hi;
  int v0, v1;
  load_valid(valid, kt_lo * TILE, p.T, lane, v0, v1);
  mbar_wait(k_full, 0);              // Q, dO and the first K tile
  mbar_wait(v_full, 0);
  start_scores(0, 0);
  wgmma_wait<1>();
  fence_operand(dp);
  load_v(VST);
  wgmma_wait<0>();
  fence_operand(s);
  lo = __ballot_sync(0xffffffffu, v0 != 0);
  hi = __ballot_sync(0xffffffffu, v1 != 0);
  make_ds(kt_lo * TILE, lo, hi);
  pack();

  for (int it = 0; it + 1 < n_steps; ++it) {
    const int ks = it % KST;
    const int ks_next = (it + 1) % KST;
    const int vs_next = (it + 1) % VST;
    const int k0_next = (kt_lo + it + 1) * TILE;
    load_valid(valid, k0_next, p.T, lane, v0, v1);
    mbar_wait(k_full + ks_next * 8, ((it + 1) / KST) & 1);
    mbar_wait(v_full + vs_next * 8, ((it + 1) / VST) & 1);
    start_scores(ks_next, vs_next);
    start_dq(ks);
    wgmma_wait<2>();                 // dp of tile it + 1: its V slot is free
    fence_operand(dp);
    load_v(it + 1 + VST);
    wgmma_wait<1>();                 // s of tile it + 1
    fence_operand(s);
    lo = __ballot_sync(0xffffffffu, v0 != 0);
    hi = __ballot_sync(0xffffffffu, v1 != 0);
    make_ds(k0_next, lo, hi);
    wgmma_wait<0>();                 // the dq product of tile it: its K slot is free
    fence_operand(dq);
    load_k(it + KST);
    pack();
  }
  start_dq((n_steps - 1) % KST);
  wgmma_wait<0>();
  fence_operand(dq);

  bf16* out = static_cast<bf16*>(p.dq) + ((long)b * p.T * p.H + h) * HD;
  store_tile<HD>(dq, p.scale, base, out, (long)p.H * HD, q0, p.T, threadIdx.x, 1);
}

// dK, dV. A block owns 128 keys, 64 to each of two warpgroups, and
// sweeps over the 64-query tiles that cut their band. Keys are the rows:
// s^T = K Q^T and dp^T = V dO^T with K / V as the A operand and Q / dO as the
// K-major B operand; the accumulator fragments of p^T * keep / (1 - p_drop)
// and ds^T, packed to bf16 pairs, are the register A operands of dv += p^T dO
// and dk += ds^T Q, with the same dO and Q tiles as the MN-major B operand.
// lse and delta belong to the columns: each warpgroup brings the next tile's
// 64 + 64 floats to shared memory while this tile's products run. The
// block's first thread also keeps the TMA loads of (Q, dO) pairs ahead in a
// ring: two warpgroups alone leave a thread up to 255 registers, and the
// compiler places wgmma accumulators only within the count the kernel is
// launched with, whatever setmaxnreg adds later. While one warpgroup turns
// its scores into p^T and ds^T, the other's products run.
template <int HD>
__global__ void __launch_bounds__(DKV_THREADS, dkv_blocks_per_sm<HD>())
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, FlashParams p) {
  using namespace hopper;
  using bf16 = __nv_bfloat16;
  constexpr int TB = tile_bytes<HD>();
  constexpr int ST = DKV_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sK = smem_u32(base);              // 2 tiles, one a warpgroup
  const uint32_t sV = sK + 2 * TB;                 // 2 tiles
  const uint32_t sQ = sV + 2 * TB;                 // ST tiles
  const uint32_t sdO = sQ + ST * TB;               // ST tiles
  float* rows = reinterpret_cast<float*>(base + (4 + 2 * ST) * TB);
  const uint32_t kv_full = sdO + ST * TB + DKV_ROW_BYTES;
  const uint32_t full = kv_full + 8;               // ST barriers
  const uint32_t empty = full + ST * 8;            // ST barriers, 2 arrivals each

  const int n_tiles = (p.T + DKV_KEYS - 1) / DKV_KEYS;
  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * DKV_KEYS;
  const int b = bh / p.H;
  const int h = bh % p.H;
  // query i sees key j iff j - fwd <= i <= j + bwd
  const int q_lo = max(k0 - p.fwd, 0);
  const int q_hi = min(k0 + DKV_KEYS - 1 + p.bwd, p.T - 1);
  const int qt_lo = q_lo / TILE;
  const int n_steps = q_hi / TILE - qt_lo + 1;     // at least 1

  // (Q, dO) tile `it` of the sweep into its ring slot; called by thread 0
  auto load_pair = [&](int it) {
    const int slot = it % ST;
    const int q0 = (qt_lo + it) * TILE;
    mbar_arrive_expect_tx(full + slot * 8, 2 * TB);
    load_tile<HD>(sQ + slot * TB, &tm_q, q0, h, b, full + slot * 8);
    load_tile<HD>(sdO + slot * TB, &tm_do, q0, h, b, full + slot * 8);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i * 8, 1);
      mbar_init(empty + i * 8, 2);
    }
    mbar_init_fence();
    mbar_arrive_expect_tx(kv_full, 4 * TB);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      load_tile<HD>(sK + w * TB, &tm_k, k0 + w * TILE, h, b, kv_full);
      load_tile<HD>(sV + w * TB, &tm_v, k0 + w * TILE, h, b, kv_full);
    }
    for (int it = 0; it < ST - 2 && it < n_steps; ++it) load_pair(it);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & (WG - 1);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0w = k0 + wg * TILE;                // this warpgroup's first key
  const int k_pos[2] = {k0w + warp * 16 + g, k0w + warp * 16 + g + 8};
  const uint32_t seed = p.use_drop ? (uint32_t)(*p.seed) : 0u;
  const uint32_t bh_hash = (uint32_t)bh * 0xC2B2AE3Du;
  const uint32_t k_hash[2] = {((uint32_t)k_pos[0] * 0x85EBCA77u) ^ bh_hash,
                              ((uint32_t)k_pos[1] * 0x85EBCA77u) ^ bh_hash};
  const float c_log2 = p.scale * LOG2E;
  const uint32_t sKw = sK + wg * TB;
  const uint32_t sVw = sV + wg * TB;
  float* my_rows = rows + wg * (2 * 2 * TILE);   // [buffer][lse 64, delta 64]
  const int bar_id = 1 + wg;

  // which of this warpgroup's 64 keys exist and are valid
  uint32_t lo, hi;
  {
    int v0, v1;
    load_valid(p.valid != nullptr ? p.valid + (long)b * p.T : nullptr, k0w, p.T, lane, v0, v1);
    lo = __ballot_sync(0xffffffffu, v0 != 0);
    hi = __ballot_sync(0xffffffffu, v1 != 0);
  }
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + g + 8 * r;
    key_ok[r] = (((i < 32 ? lo : hi) >> (i & 31)) & 1u) != 0u;
  }
  const bool keys_full = (lo & hi) == 0xffffffffu;

  // lse (threads 0-63, in units of log2) or delta (64-127) of query
  // q0 + tid % 64; 0 past T
  auto load_row = [&](int q0) {
    const int q = q0 + (tid & (TILE - 1));
    if (q >= p.T) return 0.f;
    const long at = (long)bh * p.T + q;
    return tid < TILE ? lse_log2(p.lse[at]) : p.delta[at];
  };

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  // A step of the sweep takes NQ queries: s^T and dp^T of 64 keys x NQ
  // queries, and the packed p^T and ds^T, share the registers with dk and dv.
  constexpr int NQ = DKV_STEP;
  constexpr int PARTS = TILE / NQ;               // steps a (Q, dO) tile
  constexpr int NS = NQ / 8;                     // 8-query column groups a step
  float st[NQ / 2], dpt[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t pa_p[NQ / 16][4], pa_ds[NQ / 16][4];

  // s^T = K Q^T and dp^T = V dO^T for queries [part * NQ, + NQ) of ring slot `slot`
  auto start_scores = [&](int slot, int part) {
    const uint32_t rows_off = slot * TB + part * (NQ * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (TILE * 128) + (kk & 3) * 32;
      const uint64_t a = make_desc(sKw + off, 16, 1024);
      const uint64_t bq = make_desc(sQ + rows_off + off, 16, 1024);
      wgmma_ss_n32(st, a, bq, kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (TILE * 128) + (kk & 3) * 32;
      const uint64_t a = make_desc(sVw + off, 16, 1024);
      const uint64_t bo = make_desc(sdO + rows_off + off, 16, 1024);
      wgmma_ss_n32(dpt, a, bo, kk > 0);
    }
    wgmma_commit();
  };

  my_rows[tid] = load_row(qt_lo * TILE);
  named_barrier(bar_id, WG);
  mbar_wait(kv_full, 0);
  mbar_wait(full, 0);
  start_scores(0, 0);

  // Nothing below branches on what this warpgroup's own keys can see: a
  // product under a condition that differs between warpgroups is
  // serialised by the compiler. A tile they cannot see is masked entry by
  // entry.
  float next_row = 0.f;
  const int n_parts = n_steps * PARTS;
  for (int u = 0; u < n_parts; ++u) {
    const int it = u / PARTS;
    const int part = u % PARTS;
    const int slot = it % ST;
    const int q0 = (qt_lo + it) * TILE + part * NQ;   // first query of this step
    const float* row_lse = my_rows + (it & 1) * (2 * TILE) + part * NQ;
    const float* row_delta = row_lse + TILE;
    if (part == 0) next_row = it + 1 < n_steps ? load_row((qt_lo + it + 1) * TILE) : 0.f;
    // this step's scores, and with them every product issued before
    wgmma_wait<0>();
    fence_operand(st);
    fence_operand(dpt);
    fence_operand(dk);
    fence_operand(dv);
    if (part == 0 && tid == 0) {
      if (it > 0) mbar_arrive(empty + ((it - 1) % ST) * 8);
      // Thread 0 of the block keeps the ring ST - 2 tiles ahead: the slot of
      // tile it - 2, which the other warpgroup has long left.
      if (wg == 0 && it + ST - 2 < n_steps) {
        if (it >= 2) mbar_wait(empty + ((it - 2) % ST) * 8, ((it - 2) / ST) & 1);
        load_pair(it + ST - 2);
      }
    }

    // A step wholly inside the band whose keys are all valid and whose
    // queries all lie below T needs no visibility test.
    const bool inside = k0w >= q0 + NQ - 1 - p.bwd && k0w + TILE - 1 <= q0 + p.fwd;
    if (!(inside && keys_full && q0 + NQ <= p.T)) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + j * 8 + 2 * t + (e & 1);
          const int kp = k_pos[e >> 1];
          const bool visible =
              key_ok[e >> 1] && qp < p.T && kp >= qp - p.bwd && kp <= qp + p.fwd;
          if (!visible) st[4 * j + e] = NEG_INF;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(row_lse + j * 8 + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(row_delta + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pr = exp2_approx(fmaf(st[4 * j + e], c_log2, (e & 1) ? -l2.y : -l2.x));
        float pv = pr;
        float d = dpt[4 * j + e];
        if (p.use_drop) {
          const uint32_t qp = (uint32_t)(q0 + j * 8 + 2 * t + (e & 1));
          const bool keep = keep_hash(k_hash[r] ^ (qp * 0x9E3779B1u), seed, p.thresh);
          pv = keep ? pr * p.inv_keep : 0.f;
          d = keep ? d * p.inv_keep : 0.f;
        }
        st[4 * j + e] = pv;
        dpt[4 * j + e] = pr * (d - ((e & 1) ? dl.y : dl.x));
      }
      pa_p[j >> 1][(j & 1) * 2] = pack_bf16(st[4 * j], st[4 * j + 1]);
      pa_p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
      pa_ds[j >> 1][(j & 1) * 2] = pack_bf16(dpt[4 * j], dpt[4 * j + 1]);
      pa_ds[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dpt[4 * j + 2], dpt[4 * j + 3]);
    }
    // dv += p^T dO and dk += ds^T Q: 16 queries a step, dO and Q MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk) {
      const uint32_t rows_off = slot * TB + (part * (NQ / 16) + kk) * (16 * 128);
      const uint64_t d_do = make_desc(sdO + rows_off, TILE * 128, 1024);
      const uint64_t d_q = make_desc(sQ + rows_off, TILE * 128, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128_bt(dv, pa_p[kk], d_do, 1);
        wgmma_rs_n128_bt(dk, pa_ds[kk], d_q, 1);
      } else {
        wgmma_rs_n64_bt(dv, pa_p[kk], d_do, 1);
        wgmma_rs_n64_bt(dk, pa_ds[kk], d_q, 1);
      }
    }
    wgmma_commit();
    // the next step's scores queue up behind them
    if (u + 1 < n_parts) {
      const int it_next = (u + 1) / PARTS;
      if (part == PARTS - 1) mbar_wait(full + (it_next % ST) * 8, (it_next / ST) & 1);
      start_scores(it_next % ST, (u + 1) % PARTS);
    }
    if (part == PARTS - 1) {
      // the next tile's lse and delta; the barrier also says that every
      // warp has read this tile's
      my_rows[((it + 1) & 1) * (2 * TILE) + tid] = next_row;
      named_barrier(bar_id, WG);
    }
  }
  wgmma_wait<0>();
  fence_operand(dk);
  fence_operand(dv);

  const long stride = (long)p.H * HD;
  const long at = ((long)b * p.T * p.H + h) * HD;
  store_tile<HD>(dk, p.scale, base + wg * TB, static_cast<bf16*>(p.dk) + at, stride, k0w, p.T,
                 tid, bar_id);
  store_tile<HD>(dv, 1.f, base + (2 + wg) * TB, static_cast<bf16*>(p.dv) + at, stride, k0w,
                 p.T, tid, bar_id);
}

template <int HD>
int launch(int which, const FlashParams& p, const Planned& plan, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* tensors[4] = {p.q, p.k, p.v, p.dout};
  for (int i = 0; i < 4; ++i) {
    if (!tensor_map(&maps[i], tensors[i], p.B, p.T, p.H, HD)) return (int)cudaErrorInvalidValue;
  }
  const bool is_dq = which == DQ;
  const int smem = is_dq ? dq_smem_bytes<HD>() : dkv_smem_bytes<HD>();
  const int rows = is_dq ? TILE : DKV_KEYS;
  const int threads = is_dq ? DQ_THREADS : DKV_THREADS;
  if (!plan.is(rows, is_dq ? DQ_K_STAGES : DKV_STAGES, threads, smem,
               is_dq ? DQ_BLOCKS_PER_SM : dkv_blocks_per_sm<HD>())) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = is_dq ? flash_dq_wgmma_kernel<HD> : flash_dkv_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((p.T + rows - 1) / rows * p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

}  // namespace bwd_wg

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one pass over out and dout, every dtype and head size
// ---------------------------------------------------------------------------

// Replaces the expression of llm_bci_tpu/ops/flash_attention.py (_flash_bwd)
// that XLA fuses into one pass. 16 bytes a thread from each tensor, HD * sizeof(T)
// / 16 lanes a (b, t, h) row and 32 / that many rows a warp; products and sum
// in float32; the result goes to the (B, H, T) layout of lse.
constexpr int DELTA_THREADS = 256;

template <typename T, int HD>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ delta, int B, int Tn, int H) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPR = HD / VEC;            // lanes a row: 4 to 32
  const int lane = threadIdx.x & 31;
  const long n_rows = (long)B * Tn * H;
  const long warp = (long)blockIdx.x * (DELTA_THREADS / 32) + (threadIdx.x >> 5);
  const long row = warp * (32 / LPR) + lane / LPR;
  float sum = 0.f;
  if (row < n_rows) {
    const long at = row * HD + (lane % LPR) * VEC;
    const int4 a = *reinterpret_cast<const int4*>(out + at);
    const int4 c = *reinterpret_cast<const int4*>(dout + at);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* cv = reinterpret_cast<const T*>(&c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum = fmaf(to_float(av[i]), to_float(cv[i]), sum);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < n_rows && lane % LPR == 0) {
    const int h = (int)(row % H);
    const long bt = row / H;
    delta[((bt / Tn) * H + h) * Tn + bt % Tn] = sum;
  }
}

template <typename T, int HD>
int launch_delta(const void* out, const void* dout, float* delta, int B, int Tn, int H,
                 cudaStream_t stream) {
  constexpr int ROWS = DELTA_THREADS / (HD * (int)sizeof(T) / 16);   // rows a block
  const long n_rows = (long)B * Tn * H;
  flash_delta_kernel<T, HD><<<(unsigned)((n_rows + ROWS - 1) / ROWS), DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, B, Tn, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// `plan` is what the caller planned for the kernel; a plan that differs from
// the kernel's own is refused.
template <typename T, int HD>
int launch(int which, const FlashParams& p, const Planned& plan, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 64) {
    return which == FWD ? fwd_wg::launch<HD>(p, plan.smem, stream)
                        : bwd_wg::launch<HD>(which, p, plan, stream);
  } else {
    void (*kernel)(FlashParams) = flash_dkv_kernel<T, HD>;
    size_t smem = dkv_smem<T, HD>();
    if (which == FWD) {
      kernel = flash_fwd_kernel<T, HD>;
      smem = fwd_smem<T, HD>();
    } else if (which == DQ) {
      kernel = flash_dq_kernel<T, HD>;
      smem = dq_smem<T, HD>();
    }
    if ((size_t)plan.smem != smem) return (int)cudaErrorInvalidValue;
    // one tile of each operand, and as many blocks an SM as shared memory
    // holds with 1 KB of overhead each
    if (which != FWD && !plan.is(TILE, 1, THREADS, (int)smem, MAX_SMEM / ((int)smem + 1024))) {
      return (int)cudaErrorInvalidValue;
    }
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (p.T + TILE - 1) / TILE;
    kernel<<<(unsigned)(n_tiles * p.B * p.H), THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_hd(int which, int D, const FlashParams& p, const Planned& plan,
                cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(which, p, plan, stream);
    case 64: return launch<T, 64>(which, p, plan, stream);
    case 128: return launch<T, 128>(which, p, plan, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, int is_bf16, int D, const FlashParams& p, void* stream,
             const Planned& plan) {
  if (p.B < 1 || p.T < 1 || p.H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<__nv_bfloat16>(which, D, p, plan, s)
                 : dispatch_hd<float>(which, D, p, plan, s);
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
// (B, H, T) float32. fwd / bwd: band widths in [0, T]. smem_bytes: the dynamic
// shared memory planned for the kernel; the backward launchers also take the
// planned rows a block, stages, threads and blocks an SM. Each returns the CUDA error code of
// its launch (0 on success).

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const int* valid,
                                const int* seed, void* out, float* lse, int B, int T, int H,
                                int D, int is_bf16, int fwd, int bwd, float scale,
                                unsigned thresh, float inv_keep, int use_drop, int smem_bytes,
                                void* stream) {
  FlashParams p =
      make_params(q, k, v, valid, seed, B, T, H, fwd, bwd, scale, thresh, inv_keep, use_drop);
  p.out = out;
  p.lse = lse;
  return dispatch(FWD, is_bf16, D, p, stream, Planned{0, 0, 0, smem_bytes, 0});
}

extern "C" int flash_delta_launch(const void* out, const void* dout, float* delta, int B, int T,
                                  int H, int D, int is_bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (is_bf16 ? D : -D) {
    case 32: return launch_delta<__nv_bfloat16, 32>(out, dout, delta, B, T, H, s);
    case 64: return launch_delta<__nv_bfloat16, 64>(out, dout, delta, B, T, H, s);
    case 128: return launch_delta<__nv_bfloat16, 128>(out, dout, delta, B, T, H, s);
    case -32: return launch_delta<float, 32>(out, dout, delta, B, T, H, s);
    case -64: return launch_delta<float, 64>(out, dout, delta, B, T, H, s);
    case -128: return launch_delta<float, 128>(out, dout, delta, B, T, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const int* valid,
                               const int* seed, const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int T, int H, int D,
                               int is_bf16, int fwd, int bwd, float scale, unsigned thresh,
                               float inv_keep, int use_drop, int tile_rows, int stages,
                               int threads, int smem_bytes, int blocks_per_sm, void* stream) {
  FlashParams p =
      make_params(q, k, v, valid, seed, B, T, H, fwd, bwd, scale, thresh, inv_keep, use_drop);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  return dispatch(DQ, is_bf16, D, p, stream,
                  Planned{tile_rows, stages, threads, smem_bytes, blocks_per_sm});
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const int* valid,
                                const int* seed, const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv, int B, int T, int H,
                                int D, int is_bf16, int fwd, int bwd, float scale,
                                unsigned thresh, float inv_keep, int use_drop, int tile_rows,
                                int stages, int threads, int smem_bytes, int blocks_per_sm,
                                void* stream) {
  FlashParams p =
      make_params(q, k, v, valid, seed, B, T, H, fwd, bwd, scale, thresh, inv_keep, use_drop);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return dispatch(DKV, is_bf16, D, p, stream,
                  Planned{tile_rows, stages, threads, smem_bytes, blocks_per_sm});
}
