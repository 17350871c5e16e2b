// Int8 weight-only dequant-matmul for NVIDIA Hopper (sm_90a):
//
//     out[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
//
// x (M, K) bf16 or float32, q (K, N) int8 row-major, scale (N,) float32, out
// (M, N) in float32 or bf16. Replaces the Pallas TPU kernel
// `_int8_matmul_kernel` of llm_bci_tpu/ops/quant.py (launched by
// `_int8_matmul_pallas`). That kernel walks K as a sequential grid dimension
// with the sum in VMEM and sizes 2 MB weight blocks; none of that is carried
// over. Here the int8 weight crosses device memory once, as int8, in its
// stored layout (N contiguous); it is converted to the type of x inside
// shared memory (|q| <= 127 is exact in bf16), multiplied with float32
// accumulation, and the scale is applied once, in the epilogue. No
// dequantised copy of the weight exists in device memory.
//
// Two regimes, chosen by M in the Python wrapper:
//
// * M > 64 with bf16 x (prefill, fine-tune; M = 1480 on the BCI path): bound
//   by operations. `tiled::int8_wgmma_kernel`: 256 x 128 (or 128 x 128)
//   output tiles, two consumer warpgroups issuing
//   `wgmma.mma_async.m64n128k16` with float32 accumulators in registers. One
//   more warp keeps a 4-stage ring of TMA loads in flight, x as bf16 into the
//   128-byte swizzle, the weight as int8; `mbarrier`s hand the stages back
//   and forth. The weight lies N-contiguous, which is wgmma's MN-major B
//   operand (transpose flag set); the consumers convert each int8 tile to a
//   swizzled bf16 tile in shared memory between the wgmma steps of the tile
//   before it. What bounds it on this card is the shared-memory port: a
//   256 x 128 x 64 step has wgmma read 96 KB of operands, TMA write 40 KB and
//   the conversion move 24 KB, against 128 bytes a clock over the 1,024
//   clocks of its products; and one block an SM leaves each tile's prologue
//   and epilogue uncovered. PERF.md has the times.
// * M <= 64 (decode; M = 8 greedy, 40 with 5 beams): bound by the weight's
//   bytes. `int8_matmul_kernel<T, BM, BN, BK, WARPS_M, WARPS_N>` with a tile
//   that holds all M rows (BM = 16, 32 or 64), BN = 128, BK = 64, 4 warps side
//   by side along N, `mma.sync.m16n8k16` with fragments from `ldmatrix`, the
//   next k-tile fetched into registers while the current one is multiplied. At
//   N = 4096 there are only 32 such tiles for 132 SMs, so K is split over
//   gridDim.z: every block writes a float32 partial sum to a scratch buffer
//   (split, M, N) and `int8_reduce_kernel` adds the partials in a fixed order,
//   applies the scale and casts. No atomics: the same inputs give the same
//   bits on every run.
//
// float32 x takes `int8_matmul_kernel` on the CUDA cores at every M (128 x 128
// tiles above 64), for tests and tight comparison. Ragged edges (any M >= 1;
// K and N multiples of 16) read as zeros and are masked in the stores.
//
// Plain C interface for ctypes; the launch function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

struct Params {
  const void* x;       // (M, K)
  const int8_t* q;     // (K, N)
  const float* scale;  // (N,)
  void* out;           // (M, N) float32 or bf16
  float* partial;      // (split, M, N) float32, used when gridDim.z > 1
  int M, K, N;
  int k_per_split;     // a multiple of BK
  int out_f32;
};

template <typename T>
struct Pad {
  static constexpr int value = 16 / sizeof(T);   // 16 bytes: keeps rows 16-byte aligned
};

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

// 16 int8 codes (one int4) to 16 values of T in shared memory.
__device__ __forceinline__ void store_codes(__nv_bfloat16* dst, const int4& v) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  uint32_t packed[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f0 = (float)(int8_t)(w[i] & 0xff);
    const float f1 = (float)(int8_t)((w[i] >> 8) & 0xff);
    const float f2 = (float)(int8_t)((w[i] >> 16) & 0xff);
    const float f3 = (float)(int8_t)((w[i] >> 24) & 0xff);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f0, f1);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f2, f3);
    packed[2 * i] = *reinterpret_cast<const uint32_t*>(&lo);
    packed[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
  int4* d = reinterpret_cast<int4*>(dst);
  d[0] = make_int4(packed[0], packed[1], packed[2], packed[3]);
  d[1] = make_int4(packed[4], packed[5], packed[6], packed[7]);
}

__device__ __forceinline__ void store_codes(float* dst, const int4& v) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = make_float4((float)(int8_t)(w[i] & 0xff), (float)(int8_t)((w[i] >> 8) & 0xff),
                       (float)(int8_t)((w[i] >> 16) & 0xff),
                       (float)(int8_t)((w[i] >> 24) & 0xff));
  }
}

// M <= 64, and float32 x at any M. Block (blockIdx.x, blockIdx.y, blockIdx.z):
// output rows [y*BM, +BM), columns [x*BN, +BN), summed over k in
// [z*k_per_split, +k_per_split). The int8 tile is read 16 bytes a thread and
// converted on the way into shared memory. Warp (wm, wn)
// owns rows wm*WTM.. and columns wn*WTN.. of the tile; its accumulators have
// the layout of the mma.m16n8k16 C fragment for both types: with g = lane / 4
// and t = lane % 4, acc[mt][nt][0..1] is row mt*16 + g, columns nt*8 + 2t and
// +1, and acc[mt][nt][2..3] is row mt*16 + g + 8.
template <typename T, int BM, int BN, int BK, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N) int8_matmul_kernel(Params p) {
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int VEC = 16 / sizeof(T);              // elements of x in 16 bytes
  constexpr int LDA = BK + Pad<T>::value;
  constexpr int LDB = BN + Pad<T>::value;
  constexpr int WTM = BM / WARPS_M;
  constexpr int WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16;
  constexpr int NT = WTN / 8;
  constexpr int A_VECS = BM * BK / VEC / THREADS;  // 16-byte loads of x a thread and k-tile
  constexpr int B_VECS = BK * BN / 16 / THREADS;   // 16-byte loads of q a thread and k-tile
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "warp tile");
  static_assert(A_VECS * THREADS * VEC == BM * BK, "x tile must divide over the threads");
  static_assert(B_VECS * THREADS * 16 == BK * BN, "q tile must divide over the threads");

  __shared__ __align__(16) T As[BM * LDA];
  __shared__ __align__(16) T Bs[BK * LDB];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int8_t* __restrict__ q = p.q;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  int4 a_reg[A_VECS];
  int4 b_reg[B_VECS];

  // One k-tile from device memory into registers; what lies outside the
  // matrices reads as zero. K % 16 == 0 and N % 16 == 0 keep every 16-byte
  // vector inside one row.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / VEC);
      const int c = (v % (BK / VEC)) * VEC;
      a_reg[i] = make_int4(0, 0, 0, 0);
      if (m0 + r < p.M && k0 + c < k_end) {
        a_reg[i] = *reinterpret_cast<const int4*>(x + (long)(m0 + r) * p.K + k0 + c);
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BN / 16);
      const int c = (v % (BN / 16)) * 16;
      b_reg[i] = make_int4(0, 0, 0, 0);
      if (k0 + r < k_end && n0 + c < p.N) {
        b_reg[i] = *reinterpret_cast<const int4*>(q + (long)(k0 + r) * p.N + n0 + c);
      }
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / VEC);
      const int c = (v % (BK / VEC)) * VEC;
      *reinterpret_cast<int4*>(As + r * LDA + c) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BN / 16);
      const int c = (v % (BN / 16)) * 16;
      store_codes(Bs + r * LDB + c, b_reg[i]);
    }
  };

  const T* A_warp = As + (wm * WTM) * LDA;
  const T* B_warp = Bs + wn * WTN;

  if (k_begin < k_end) fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < k_end) fetch(k0 + BK);

    if constexpr (std::is_same<T, float>::value) {
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a_lo[MT], a_hi[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a_lo[mt] = A_warp[(mt * 16 + g) * LDA + k];
          a_hi[mt] = A_warp[(mt * 16 + g + 8) * LDA + k];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float b0 = B_warp[k * LDB + nt * 8 + 2 * t];
          const float b1 = B_warp[k * LDB + nt * 8 + 2 * t + 1];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nt][0] += a_lo[mt] * b0;
            acc[mt][nt][1] += a_lo[mt] * b1;
            acc[mt][nt][2] += a_hi[mt] * b0;
            acc[mt][nt][3] += a_hi[mt] * b1;
          }
        }
      }
    } else {
      // ldmatrix addresses of this lane: matrix lane / 8, row lane % 8
      const int a_row = lane & 15;
      const int a_col = (lane >> 4) * 8;
      const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
      const int b_n = (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldsm_x4(a[mt], A_warp + (mt * 16 + a_row) * LDA + kk + a_col);
        }
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          // b[0..1]: the B fragment of n-tile nt, b[2..3]: of n-tile nt + 1
          uint32_t b[4];
          ldsm_x4_trans(b, B_warp + (kk + b_k) * LDB + nt * 8 + b_n);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Epilogue. One block over all of K scales and casts; a split-K block
  // leaves its float32 partial sum for int8_reduce_kernel.
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * WTN + nt * 8 + 2 * t;
      if (col >= p.N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * WTM + mt * 16 + g + half * 8;
        if (row >= p.M) continue;
        float v0 = acc[mt][nt][2 * half];
        float v1 = acc[mt][nt][2 * half + 1];
        if (split) {
          float* dst = p.partial + ((long)blockIdx.z * p.M + row) * p.N + col;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          continue;
        }
        v0 *= p.scale[col];
        v1 *= p.scale[col + 1];
        if (p.out_f32) {
          float* dst = static_cast<float*>(p.out) + (long)row * p.N + col;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + (long)row * p.N + col;
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 x, M > 64: wgmma from a ring of asynchronous loads
// ---------------------------------------------------------------------------

namespace tiled {

constexpr int BN = 128;
constexpr int BK = 64;         // one 128-byte swizzle row of bf16 x
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups that convert and multiply
constexpr int THREADS = CONSUMERS + 32;  // and one warp whose first lane starts the TMA loads
constexpr int Q_STAGE = BK * BN;       // int8 codes as they lie in device memory
constexpr int B_TILE = BK * BN * 2;    // converted bf16 weight tile, MN-major, swizzled
constexpr int B_TILES = 3;             // one multiplied, one being converted, one draining
constexpr int BARRIER_BYTES = 128;     // 2 * STAGES mbarriers

// A block's tile has 128 * CHUNKS rows: two warpgroups, CHUNKS wgmma chunks of
// 64 rows each. The bf16 x tile of a stage is K-major and swizzled.
template <int CHUNKS>
__host__ __device__ constexpr int a_stage() { return 128 * CHUNKS * BK * 2; }
template <int CHUNKS>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (a_stage<CHUNKS>() + Q_STAGE) + B_TILES * B_TILE + BARRIER_BYTES + 1024;
}

// Four int8 codes of one word to four floats, exactly: the code plus 128 is
// placed into the mantissa of 2^23 and 2^23 + 128 is subtracted.
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  w ^= 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = hopper::pack_bf16(f0, f1);
  hi = hopper::pack_bf16(f2, f3);
}

// Block (blockIdx.x, blockIdx.y): output rows [x*BM, +BM), columns [y*BN,
// +BN). One thread of the last warp keeps STAGES k-tiles in flight: per
// 64-deep k-tile one TMA box of x (BM rows x 64 bf16, written swizzled) and
// one of q (64 rows x 128 int8), both counted on the stage's `full` barrier;
// what lies outside the matrices arrives as zeros, so ragged M, K and N need
// no other care than masked stores. Consumer warpgroup w owns rows w*BM/2 ..
// as CHUNKS 64-row wgmma chunks with a 64 x 128 float32 accumulator each
// (rows past M are zero and multiplied all the same: a branch around a wgmma
// serialises the whole group). Step kt multiplies k-tile kt and converts the
// int8 tile kt + 1 into the next of three bf16 B tiles, a quarter of it after
// each 16-deep wgmma step: a warp that starts a wgmma waits until the tensor
// cores accept it, so only work placed between two of them overlaps the
// products.
template <int CHUNKS>
__global__ void __launch_bounds__(THREADS, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_q, Params p) {
  using namespace hopper;
  constexpr int BM = 128 * CHUNKS;
  constexpr int WG_ROWS = 64 * CHUNKS;
  constexpr int A_STAGE = a_stage<CHUNKS>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* gQ = base + STAGES * A_STAGE;
  unsigned char* gB = gQ + STAGES * Q_STAGE;
  const uint32_t sA = smem_u32(base);
  const uint32_t sQ = smem_u32(gQ);
  const uint32_t sB = smem_u32(gB);
  const uint32_t full = sB + B_TILES * B_TILE;   // STAGES barriers: the stage's bytes have landed
  const uint32_t empty = full + STAGES * 8;      // STAGES barriers: both warpgroups are done with it

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k_tiles = (p.K + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        const int round = kt / STAGES;
        if (round > 0) mbar_wait(empty + s * 8, (round - 1) & 1);
        mbar_arrive_expect_tx(full + s * 8, A_STAGE + Q_STAGE);
        tma_load_2d(sA + s * A_STAGE, &tm_x, kt * BK, m0, full + s * 8);
        tma_load_2d(sQ + s * Q_STAGE, &tm_q, n0, kt * BK, full + s * 8);
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int t = tid & 127;

  // int8 stage -> bf16 B tile: 8 codes (one 16-byte chunk of bf16) a thread
  // and pass; pass i takes rows c_k + 16 i. The B tile is two blocks of 64
  // columns, each 64 rows of 128 bytes, swizzled.
  const int c_k = tid >> 4;
  const int c_u = tid & 15;
  const uint32_t c_src = c_k * BN + c_u * 8;
  const uint32_t c_dst = (c_u >> 3) * (BK * 128) + swizzle128(c_k, c_u & 7);
  auto convert = [&](int s, int buf, int i) {
    const uint2 w = *reinterpret_cast<const uint2*>(gQ + s * Q_STAGE + c_src + i * (16 * BN));
    uint4 v;
    codes_to_bf16(w.x, v.x, v.y);
    codes_to_bf16(w.y, v.z, v.w);
    *reinterpret_cast<uint4*>(gB + buf * B_TILE + c_dst + i * (16 * 128)) = v;
  };

  float acc[CHUNKS][64];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
  }

  mbar_wait(full, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) convert(0, 0, i);
  fence_proxy_async();
  if (k_tiles > 1) mbar_wait(full + 8, 0);
  named_barrier(1, CONSUMERS);   // B tile 0 is converted and k-tile 1 has landed, for everyone

  // B tile (kt + 1) % 3 was last read by the products of k-tile kt - 2, which
  // both warpgroups have seen complete before the barrier that ended step
  // kt - 1. (A barrier placed between the wgmma steps instead, to keep the
  // tensor cores' queue full across it, makes the compiler fence every step
  // and was slower.)
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    const int next_s = (kt + 1) % STAGES;
    const int next_buf = (kt + 1) % B_TILES;
    const uint32_t a_tile = sA + s * A_STAGE + wg * (WG_ROWS * 128);
    const uint32_t b_tile = sB + (kt % B_TILES) * B_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = make_desc(b_tile + kk * (16 * 128), BK * 128, 1024);
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        wgmma_ss_n128_bt(acc[i], make_desc(a_tile + i * (64 * 128) + kk * 32, 16, 1024), db, 1);
      }
      convert(next_s, next_buf, kk);
    }
    wgmma_commit();
    // the products of k-tile kt - 1 are complete, and its int8 tile was
    // converted a step earlier: this warpgroup hands the stage back
    wgmma_wait<1>();
    if (kt > 0 && t == 0) mbar_arrive(empty + ((kt - 1) % STAGES) * 8);
    fence_proxy_async();
    if (kt + 2 < k_tiles) mbar_wait(full + ((kt + 2) % STAGES) * 8, ((kt + 2) / STAGES) & 1);
    named_barrier(1, CONSUMERS);   // B tile kt + 1 is converted and k-tile kt + 2 has landed
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) fence_operand(acc[i]);

  // Epilogue: scale, then store. bf16 output goes through shared memory (the
  // ring is idle by now) so that every thread stores 16 contiguous bytes and a
  // warp whole 128-byte lines; rows of 272 bytes keep the fragment writes
  // free of bank conflicts. float32 output is stored from the fragments.
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  constexpr int STAGE_ROW = BN * 2 + 16;
  unsigned char* staging = base + wg * (WG_ROWS * STAGE_ROW);
  if (!p.out_f32) named_barrier(1, CONSUMERS);   // both warpgroups have finished reading the ring
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + c2;
      if (col >= p.N) continue;
      const float2 sc = *reinterpret_cast<const float2*>(p.scale + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int local = i * 64 + warp * 16 + g + half * 8;
        const float v0 = acc[i][4 * j + 2 * half] * sc.x;
        const float v1 = acc[i][4 * j + 2 * half + 1] * sc.y;
        if (p.out_f32) {
          const int row = m0 + wg * WG_ROWS + local;
          if (row >= p.M) continue;
          float* dst = static_cast<float*>(p.out) + (long)row * p.N + col;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(staging + local * STAGE_ROW + (j * 8 + c2) * 2) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
  if (p.out_f32) return;
  named_barrier(2 + wg, 128);   // this warpgroup's rows are staged
  const int chunk = t & 15;     // 16 bytes: 8 columns
  const int col0 = n0 + chunk * 8;
  if (col0 >= p.N) return;
#pragma unroll 4
  for (int r = 0; r < WG_ROWS / 8; ++r) {
    const int local = r * 8 + (t >> 4);
    const int row = m0 + wg * WG_ROWS + local;
    if (row >= p.M) break;
    const int4 v = *reinterpret_cast<const int4*>(staging + local * STAGE_ROW + chunk * 16);
    *reinterpret_cast<int4*>(static_cast<__nv_bfloat16*>(p.out) + (long)row * p.N + col0) = v;
  }
}

// Tensor map of a row-major (rows, cols) matrix of `elem_bytes`-wide elements,
// read in boxes of box_rows x box_cols.
bool matrix_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return hopper::make_tensor_map(map, type, 2, ptr, dims, strides, box, swizzle);
}

template <int CHUNKS>
int launch(const Params& p, int grid_m, int grid_n, int smem, cudaStream_t stream) {
  constexpr int BM = 128 * CHUNKS;
  if (grid_m != (p.M + BM - 1) / BM || grid_n != (p.N + BN - 1) / BN ||
      smem != smem_bytes<CHUNKS>()) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tm_x, tm_q;
  if (!matrix_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.x, p.M, p.K, BM, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !matrix_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.q, p.K, p.N, BK, BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(int8_wgmma_kernel<CHUNKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int8_wgmma_kernel<CHUNKS><<<dim3(grid_m, grid_n), THREADS, smem, stream>>>(tm_x, tm_q, p);
  return (int)cudaGetLastError();
}

}  // namespace tiled

// out[m, n] = (sum_z partial[z, m, n]) * scale[n], z in ascending order; four
// columns a thread (N % 16 == 0).
__global__ void __launch_bounds__(256) int8_reduce_kernel(Params p, int split) {
  const long quads = (long)p.M * p.N / 4;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const long e = i * 4;
  const int col = (int)(e % p.N);
  float4 s = *reinterpret_cast<const float4*>(p.partial + e);
  for (int z = 1; z < split; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(p.partial + (long)z * p.M * p.N + e);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 sc = *reinterpret_cast<const float4*>(p.scale + col);
  s.x *= sc.x;
  s.y *= sc.y;
  s.z *= sc.z;
  s.w *= sc.w;
  if (p.out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + e) = s;
  } else {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + e);
    dst[0] = __floats2bfloat162_rn(s.x, s.y);
    dst[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

template <typename T, int BM, int BN, int BK, int WARPS_M, int WARPS_N>
int launch(const Params& p, int split, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, split);
  int8_matmul_kernel<T, BM, BN, BK, WARPS_M, WARPS_N>
      <<<grid, 32 * WARPS_M * WARPS_N, 0, stream>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || split == 1) return rc;
  const long quads = (long)p.M * p.N / 4;
  int8_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(p, split);
  return (int)cudaGetLastError();
}

// The k-tile depth of a configuration: the wrapper rounds k_per_split to it.
template <typename T>
int launch_config(const Params& p, int config, int split, cudaStream_t stream) {
  constexpr int BK_SMALL = std::is_same<T, float>::value ? 32 : 64;
  switch (config) {
    case 0:
      // bf16 x at M > 64 goes through int8_matmul_tiled_launch
      if constexpr (std::is_same<T, float>::value) {
        return launch<T, 128, 128, 32, 4, 2>(p, split, stream);
      } else {
        return (int)cudaErrorInvalidValue;
      }
    case 1: return launch<T, 16, 128, BK_SMALL, 1, 4>(p, split, stream);
    case 2: return launch<T, 32, 128, BK_SMALL, 1, 4>(p, split, stream);
    case 3: return launch<T, 64, 128, BK_SMALL, 1, 4>(p, split, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// config: 0 = 128 x 128 tiles (M > 64, float32 x only: bf16 x takes
// int8_matmul_tiled_launch); 1, 2, 3 = 16, 32, 64 x 128 tiles with split-K
// (M <= 64). `partial` holds split * M * N floats when split > 1.
extern "C" int int8_matmul_launch(const void* x, const void* q, const void* scale, void* out,
                                  void* partial, int M, int K, int N, int x_bf16, int out_f32,
                                  int config, int split, int k_per_split, void* stream) {
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.M = M;
  p.K = K;
  p.N = N;
  p.k_per_split = k_per_split;
  p.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch_config<__nv_bfloat16>(p, config, split, s);
  return launch_config<float>(p, config, split, s);
}

// bf16 x, M > 64: the wgmma kernel with tiles of `tile_m` (128 or 256) x 128.
// The caller states the grid and the dynamic shared memory it planned for; a
// plan that does not match the kernel's tiles is refused.
extern "C" int int8_matmul_tiled_launch(const void* x, const void* q, const void* scale, void* out,
                                        int M, int K, int N, int out_f32, int tile_m, int grid_m,
                                        int grid_n, int smem_bytes, void* stream) {
  if (M < 1 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.k_per_split = K;
  p.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_m == 256) return tiled::launch<2>(p, grid_m, grid_n, smem_bytes, s);
  if (tile_m == 128) return tiled::launch<1>(p, grid_m, grid_n, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
