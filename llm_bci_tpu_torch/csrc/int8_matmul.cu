// Int8 weight-only dequant-matmul for NVIDIA Hopper (sm_90a):
//
//     out[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]
//
// x (M, K) bf16 or float32, q (K, N) int8 row-major, scale (N,) float32, out
// (M, N) in float32 or bf16. Replaces the Pallas TPU kernel
// `_int8_matmul_kernel` of llm_bci_tpu/ops/quant.py (launched by
// `_int8_matmul_pallas`). That kernel walks K as a sequential grid dimension
// with the sum in VMEM and sizes 2 MB weight blocks; none of that is carried
// over. Here the int8 weight crosses device memory once, as int8, 16 bytes a
// thread along the contiguous N direction; it is converted to the type of x
// on the way into shared memory (|q| <= 127 is exact in bf16), multiplied
// with float32 accumulation, and the scale is applied once, in the epilogue.
// No dequantised copy of the weight exists in device memory.
//
// One kernel template, `int8_matmul_kernel<T, BM, BN, BK, WARPS_M, WARPS_N>`,
// serves two regimes, chosen by M in the Python wrapper:
//
// * M > 64 (prefill, fine-tune; M = 1480 on the BCI path): bound by
//   operations. 128 x 128 output tiles, BK = 32, 8 warps of 32 x 64 each,
//   `mma.sync.m16n8k16` bf16 with fragments from `ldmatrix`; the next k-tile
//   is fetched into registers while the current one is multiplied.
// * M <= 64 (decode; M = 8 greedy, 40 with 5 beams): bound by the weight's
//   bytes. A tile holds all M rows (BM = 16, 32 or 64), BN = 128, BK = 64,
//   4 warps side by side along N. At N = 4096 there are only 32 such tiles
//   for 132 SMs, so K is split over gridDim.z: every block writes a float32
//   partial sum to a scratch buffer (split, M, N) and `int8_reduce_kernel`
//   adds the partials in a fixed order, applies the scale and casts. No
//   atomics: the same inputs give the same bits on every run.
//
// float32 x takes the same tiles on the CUDA cores (for tests and tight
// comparison). Ragged edges (any M >= 1; K and N multiples of 16) are masked
// in the loads and stores.
//
// What a later redesign should change: `wgmma` with the weight tile converted
// in registers (mma.sync reaches about two thirds of the wgmma rate at best),
// TMA or cp.async with a multi-stage ring instead of one register stage, and
// for decode a persistent stream-K schedule without the scratch round trip.
//
// Plain C interface for ctypes; the launch function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Block (blockIdx.x, blockIdx.y, blockIdx.z): output rows [y*BM, +BM), columns
// [x*BN, +BN), summed over k in [z*k_per_split, +k_per_split). Warp (wm, wn)
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
    case 0: return launch<T, 128, 128, 32, 4, 2>(p, split, stream);
    case 1: return launch<T, 16, 128, BK_SMALL, 1, 4>(p, split, stream);
    case 2: return launch<T, 32, 128, BK_SMALL, 1, 4>(p, split, stream);
    case 3: return launch<T, 64, 128, BK_SMALL, 1, 4>(p, split, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// config: 0 = 128 x 128 tiles (M > 64); 1, 2, 3 = 16, 32, 64 x 128 tiles with
// split-K (M <= 64). `partial` holds split * M * N floats when split > 1.
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
