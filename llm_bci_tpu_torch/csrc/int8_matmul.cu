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
// stored layout (N contiguous); it is converted to bf16 inside the SM (|q| <=
// 127 is exact in bf16), multiplied with float32 accumulation, and the scale
// is applied once, in the epilogue. No dequantised copy of the weight exists
// in device memory. Three kernels, chosen by the Python wrapper
// (ops/int8_matmul_cuda.py, whose plans fix every launch's geometry; each
// launcher refuses a plan that differs from its kernel's constants):
//
// * bf16 x, M <= 64 (a decode step: M = 8 greedy, 40 with 5 beams):
//   `cluster::int8_cluster_kernel`. Bound by the weight's bytes: a 32-layer
//   Llama-2-7B token step reads 32 x (4 x 4096^2 + 3 x 4096 x 11008) + 4096 x
//   32000 = 6.61 GB of codes, 1.97 ms at 3.35 TB/s, and does 2 x M operations
//   a byte, far below the tensor cores' rate. So the design keeps bytes in
//   flight and nothing else in its way:
//   - a block owns 128 output columns and one K-range of a split-K; one lane of
//     a fifth warp keeps a ring of 4 to 8 stages of TMA loads in flight (a 64
//     x 128 box of codes, 8 KB, and the M x 64 bf16 box of x, both in the
//     128-byte swizzle) on `mbarrier`s, 32-64 KB of codes a block, so that
//     short K-ranges are requested whole before the first product; the ring
//     is sized so that three blocks fit an SM; the four consumer warps
//     wait on the stage's barrier, never on __syncthreads;
//   - the K-split lives inside a thread-block cluster of C = 1, 2, 4 or 8
//     blocks (the cluster dimension is the split): each rank leaves its M x 128
//     float32 partial sum in its own shared memory, and after a cluster
//     barrier rank r adds columns [r 128 / C, (r + 1) 128 / C) of all C
//     partials through distributed shared memory in rank order 0 .. C - 1,
//     scales, casts and stores. One launch a product, no scratch in device
//     memory, and the same bits on every run;
//   - the product is `mma.sync.m16n8k16` with the operands swapped: the weight
//     tile is the 16-row A operand (columns n as rows) and x the n8 B operand
//     (rows m as columns), so at M <= 8 no half of a fragment is zero rows. A
//     thread's A fragments of two 16-column tiles come from four 32-bit words
//     of one 128-byte-swizzled stage (four consecutive columns at four k; the
//     swizzle keeps the warp's loads free of bank conflicts), and each pair of
//     codes becomes a bf16 pair exactly with two LOP3 and one bf16x2
//     subtraction: (128 + (b & 127)) - (b & 128 ? 256 : 128);
//   - `ops/int8_matmul_cuda.py::cluster_plan` picks C so that about two blocks
//     an SM are in flight and every rank streams at least four k-tiles, and the
//     launcher refuses a cluster size the card cannot co-schedule
//     (cudaOccupancyMaxActiveClusters).
// * bf16 x, M > 64 (prefill, fine-tune; M = 1480 on the BCI path): bound by
//   operations. `tiled::int8_wgmma_kernel`: 256 x 128 (or 128 x 128) output
//   tiles, two consumer warpgroups issuing `wgmma.mma_async.m64n128k16` with
//   float32 accumulators in registers. One more warp keeps a 4-stage ring of
//   TMA loads in flight, x as bf16 into the 128-byte swizzle, the weight as
//   int8; `mbarrier`s hand the stages back and forth. The weight lies
//   N-contiguous, which is wgmma's MN-major B operand (transpose flag set);
//   the consumers convert each int8 tile to a swizzled bf16 tile in shared
//   memory between the wgmma steps of the tile before it. What bounds it on
//   this card is the shared-memory port: a 256 x 128 x 64 step has wgmma read
//   96 KB of operands, TMA write 40 KB and the conversion move 24 KB, against
//   128 bytes a clock over the 1,024 clocks of its products; and one block an
//   SM leaves each tile's prologue and epilogue uncovered.
// * float32 x at any M (tests and tight comparison only, no main path):
//   `int8_f32_kernel`, 128 x 128 x 32 tiles on the CUDA cores, one pass over K.
//
// Ragged edges (any M >= 1; K and N multiples of 16) read as zeros and are
// masked in the stores. PERF.md has the times.
//
// Plain C interface for ctypes; each launch function returns cudaGetLastError()
// (or the error of the refused plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

struct Params {
  const void* x;       // (M, K)
  const int8_t* q;     // (K, N)
  const float* scale;  // (N,)
  void* out;           // (M, N) float32 or bf16
  int M, K, N;
  int k_per_rank;      // the cluster kernel: k-range of one rank, a multiple of 64
  int out_f32;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// float32 x: CUDA cores, 128 x 128 tiles, one pass over K
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int LDA = BK + 4;   // 16 bytes of padding keep rows 16-byte aligned
constexpr int LDB = BN + 4;

// Block (blockIdx.x, blockIdx.y): output rows [y*BM, +BM), columns [x*BN,
// +BN). The next k-tile is fetched into registers while the current one is
// multiplied. Warp (wm, wn) owns rows wm*32.. and columns wn*64..; with g =
// lane / 4 and t = lane % 4, acc[mt][nt][0..1] is row mt*16 + g, columns
// nt*8 + 2t and +1, and acc[mt][nt][2..3] is row mt*16 + g + 8.
__global__ void __launch_bounds__(THREADS) int8_f32_kernel(Params p) {
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  constexpr int A_VECS = BM * BK / 4 / THREADS;    // float4 loads of x a thread and k-tile
  constexpr int B_VECS = BK * BN / 16 / THREADS;   // 16-byte loads of q a thread and k-tile

  __shared__ __align__(16) float As[BM * LDA];
  __shared__ __align__(16) float Bs[BK * LDB];

  const float* __restrict__ x = static_cast<const float*>(p.x);
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

  float acc[MT][NT][4] = {};
  int4 a_reg[A_VECS];
  int4 b_reg[B_VECS];

  // One k-tile from device memory into registers; what lies outside the
  // matrices reads as zero. K % 16 == 0 and N % 16 == 0 keep every 16-byte
  // vector inside one row.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / 4);
      const int c = (v % (BK / 4)) * 4;
      a_reg[i] = make_int4(0, 0, 0, 0);
      if (m0 + r < p.M && k0 + c < p.K) {
        a_reg[i] = *reinterpret_cast<const int4*>(x + (long)(m0 + r) * p.K + k0 + c);
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BN / 16);
      const int c = (v % (BN / 16)) * 16;
      b_reg[i] = make_int4(0, 0, 0, 0);
      if (k0 + r < p.K && n0 + c < p.N) {
        b_reg[i] = *reinterpret_cast<const int4*>(q + (long)(k0 + r) * p.N + n0 + c);
      }
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * THREADS;
      *reinterpret_cast<int4*>(As + (v / (BK / 4)) * LDA + (v % (BK / 4)) * 4) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * THREADS;
      float4* d = reinterpret_cast<float4*>(Bs + (v / (BN / 16)) * LDB + (v % (BN / 16)) * 16);
      const int w[4] = {b_reg[i].x, b_reg[i].y, b_reg[i].z, b_reg[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[j] = make_float4((float)(int8_t)(w[j] & 0xff), (float)(int8_t)((w[j] >> 8) & 0xff),
                           (float)(int8_t)((w[j] >> 16) & 0xff),
                           (float)(int8_t)((w[j] >> 24) & 0xff));
      }
    }
  };

  const float* A_warp = As + (wm * WTM) * LDA;
  const float* B_warp = Bs + wn * WTN;

  fetch(0);
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < p.K) fetch(k0 + BK);
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
    __syncthreads();
  }

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
        const float v0 = acc[mt][nt][2 * half] * p.scale[col];
        const float v1 = acc[mt][nt][2 * half + 1] * p.scale[col + 1];
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

}  // namespace f32

// Tensor map of a row-major (rows, cols) matrix of `elem_bytes`-wide elements,
// read in boxes of box_rows x box_cols.
bool matrix_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return hopper::make_tensor_map(map, type, 2, ptr, dims, strides, box, swizzle);
}

// ---------------------------------------------------------------------------
// bf16 x, M <= 64: a TMA ring, split-K summed inside a thread-block cluster
// ---------------------------------------------------------------------------

namespace cluster {

constexpr int BN = 128;                  // output columns of a block
constexpr int BK = 64;                   // k-depth of a stage
constexpr int CONSUMERS = 128;           // four warps, 32 columns each
constexpr int THREADS = CONSUMERS + 32;  // and a warp whose first lane issues the loads
constexpr int Q_STAGE = BK * BN;         // 8 KB of codes, 128-byte swizzle
constexpr int PART_LD = BN + 4;          // floats a row of the partial sum (bank padding)

// M_TILES 8-row tiles of x: a stage's x box is 8 * M_TILES rows x 64 bf16.
// The ring has the most stages, at most 8, at which three blocks fit an SM
// (76,800 B of dynamic shared memory a block: 228 KB / 3, less the 1 KB an SM
// keeps for each block): 8 stages at M <= 8, 5 at M <= 40, 4 at M <= 64. The
// plan launches about two blocks an SM; room for a third lets the clusters of
// up to 8 blocks pack into the GPCs in one wave.
constexpr int BLOCK_SMEM = 76800;
__host__ __device__ constexpr int x_stage(int m_tiles) { return m_tiles * 8 * BK * 2; }
__host__ __device__ constexpr int stages(int m_tiles) {
  return (BLOCK_SMEM - 1024) / (Q_STAGE + x_stage(m_tiles) + 16) < 8
             ? (BLOCK_SMEM - 1024) / (Q_STAGE + x_stage(m_tiles) + 16)
             : 8;
}
__host__ __device__ constexpr int smem_bytes(int m_tiles) {
  return stages(m_tiles) * (Q_STAGE + x_stage(m_tiles)) + 2 * stages(m_tiles) * 8 + 1024;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: shared-memory writes before the
// barrier are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Four floats at the same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ float4 ld_rank_f4(const float* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(hopper::smem_u32(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote) : "memory");
  return v;
}

// Byte `i` of two words of codes as a bf16 pair (the first word's code in the
// low half), exactly: 128 + (b & 127) and 128 or 256 are both bf16, and
// their difference is the signed code.
__device__ __forceinline__ uint32_t codes_pair(uint32_t lo, uint32_t hi, int i) {
  const uint32_t v = __byte_perm(lo, hi, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
  const uint32_t a = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (v & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Block (rank, blockIdx.y) of a cluster of gridDim.x blocks: columns [y*BN,
// +BN), k in [rank * k_per_rank, +k_per_rank). Stage s holds the codes
// (64 k-rows of 128 bytes) and then x (rows m of 64 bf16), both written by
// TMA in the 128-byte swizzle: byte (r, c) of a 128-byte row r lies at r*128 +
// ((c/16 ^ r%8) * 16) + c%16. What lies outside the matrices arrives as
// zeros.
//
// Consumer warp w owns columns 32w .. 32w + 31 as two 16-row A tiles of the
// swapped product (rows: columns n; k: the stage's k) and every 8-row tile j
// of x as the B operand (columns: rows m). With g = lane / 4 and t = lane %
// 4, the thread's A rows g and g + 8 of tile i are the columns 32w + 4g + 2i
// and + 1, so one 32-bit word of codes at k-row r holds its four columns: the
// words of k-rows kk + 2t, + 1, + 8 and + 9 make both tiles' A fragments of
// the 16-deep step kk. Its accumulator acc[i][j] is then out[8j + 2t (+1)]
// [32w + 4g + 2i (+1)] in the layout of the mma C fragment.
template <int M_TILES>
__global__ void __launch_bounds__(THREADS) int8_cluster_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_q, Params p) {
  using namespace hopper;
  constexpr int STAGES = stages(M_TILES);
  constexpr int STAGE = Q_STAGE + x_stage(M_TILES);
  static_assert(8 * M_TILES * PART_LD * 4 <= STAGES * STAGE, "the partial sum reuses the ring");
  static_assert(smem_bytes(M_TILES) <= BLOCK_SMEM, "three blocks an SM");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t ring = smem_u32(base);
  const uint32_t full = ring + STAGES * STAGE;   // STAGES barriers: the stage's bytes have landed
  const uint32_t empty = full + STAGES * 8;      // STAGES barriers: the four consumer warps are done

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const uint32_t ranks = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int k_begin = (int)rank * p.k_per_rank;
  const int k_tiles = (min(p.K, k_begin + p.k_per_rank) - k_begin + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[2][M_TILES][4] = {};
  const int g = lane >> 2;
  const int t = lane & 3;
  if (warp == CONSUMERS / 32) {
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + s * 8, (kt / STAGES - 1) & 1);
        mbar_arrive_expect_tx(full + s * 8, STAGE);
        const int k0 = k_begin + kt * BK;
        tma_load_2d(ring + s * STAGE, &tm_q, n0, k0, full + s * 8);
        tma_load_2d(ring + s * STAGE + Q_STAGE, &tm_x, k0, 0, full + s * 8);
      }
    }
  } else {
    // the thread's word of codes in a k-row r: chunk (2w + g/4) ^ (r % 8),
    // byte 4 (g % 4); its words of x in row 8j + g: chunks kk/8 (+ 1) ^ g, byte 4t
    const int q_chunk = warp * 2 + (g >> 2);
    const int q_byte = 4 * (g & 3);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + s * 8, (kt / STAGES) & 1);
      const unsigned char* qs = base + s * STAGE;
      const unsigned char* xs = qs + Q_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = kk + 2 * t + (e & 1) + (e >> 1) * 8;
          w[e] = *reinterpret_cast<const uint32_t*>(qs + r * 128 + ((q_chunk ^ (r & 7)) << 4) +
                                                    q_byte);
        }
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = codes_pair(w[0], w[1], 2 * i);        // row g, k 2t and 2t + 1
          a[i][1] = codes_pair(w[0], w[1], 2 * i + 1);    // row g + 8
          a[i][2] = codes_pair(w[2], w[3], 2 * i);        // row g, k 2t + 8 and 2t + 9
          a[i][3] = codes_pair(w[2], w[3], 2 * i + 1);    // row g + 8
        }
#pragma unroll
        for (int j = 0; j < M_TILES; ++j) {
          const unsigned char* xr = xs + (8 * j + g) * 128 + 4 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + (((kk >> 3) ^ g) << 4));
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(xr + ((((kk >> 3) + 1) ^ g) << 4));
          mma_bf16(acc[0][j], a[0], b0, b1);
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s * 8);
    }
  }

  // Every load has landed and every consumer has left the ring: the partial
  // sum of this rank goes over it, (8 M_TILES) x 128 floats in rows of PART_LD.
  __syncthreads();
  float* part = reinterpret_cast<float*>(base);
  if (warp < CONSUMERS / 32) {
    const int n = warp * 32 + 4 * g;
#pragma unroll
    for (int j = 0; j < M_TILES; ++j) {
      const int m = 8 * j + 2 * t;
      *reinterpret_cast<float4*>(part + m * PART_LD + n) =
          make_float4(acc[0][j][0], acc[0][j][2], acc[1][j][0], acc[1][j][2]);
      *reinterpret_cast<float4*>(part + (m + 1) * PART_LD + n) =
          make_float4(acc[0][j][1], acc[0][j][3], acc[1][j][1], acc[1][j][3]);
    }
  }
  cluster_sync();

  // Rank r: columns [r * BN / C, (r + 1) * BN / C) of every rank's partial,
  // added in rank order, four columns a thread and pass.
  const int quads = BN / 4 / (int)ranks;
  const int col0 = (int)rank * (BN / (int)ranks);
  for (int item = tid; item < p.M * quads; item += THREADS) {
    const int m = item / quads;
    const int c = col0 + 4 * (item % quads);
    const float* src = part + m * PART_LD + c;
    float4 s = ld_rank_f4(src, 0);
    for (uint32_t j = 1; j < ranks; ++j) {
      const float4 v = ld_rank_f4(src, j);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int col = n0 + c;
    if (col >= p.N) continue;
    const float4 sc = *reinterpret_cast<const float4*>(p.scale + col);
    s.x *= sc.x;
    s.y *= sc.y;
    s.z *= sc.z;
    s.w *= sc.w;
    if (p.out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + (long)m * p.N + col) = s;
    } else {
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + (long)m * p.N + col);
      dst[0] = __floats2bfloat162_rn(s.x, s.y);
      dst[1] = __floats2bfloat162_rn(s.z, s.w);
    }
  }
  // no block leaves while another may still read its shared memory
  cluster_sync();
}

// The launch of one plan: cluster size, column tiles, threads, stages, shared
// memory and k_per_rank must be the kernel's own and cover K with no empty
// rank; a cluster size the card cannot co-schedule is refused.
template <int M_TILES>
int launch(const Params& p, int ranks, int grid_n, int threads, int stages_, int smem,
           cudaStream_t stream) {
  if ((ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) ||
      grid_n != (p.N + BN - 1) / BN || threads != THREADS || stages_ != stages(M_TILES) ||
      smem != smem_bytes(M_TILES) || p.M > 8 * M_TILES || p.k_per_rank <= 0 ||
      p.k_per_rank % BK || (long)p.k_per_rank * ranks < p.K ||
      (long)p.k_per_rank * (ranks - 1) >= p.K) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tm_x, tm_q;
  if (!matrix_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.x, p.M, p.K, 8 * M_TILES, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !matrix_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.q, p.K, p.N, BK, BN,
                  CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ranks, grid_n);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // Set up once per process (and so never inside a stream capture): the
  // shared-memory opt-in, then whether clusters of each size fit the card.
  static int ready = 0;                 // cudaSuccess + 1 once the attribute is set
  static int clusters_fit[9] = {};      // 1 yes, -1 no, 0 not asked yet
  if (ready == 0) {
    const cudaError_t err = cudaFuncSetAttribute(int8_cluster_kernel<M_TILES>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = 1;
  }
  if (clusters_fit[ranks] == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, int8_cluster_kernel<M_TILES>, &config);
    if (err != cudaSuccess) return (int)err;
    clusters_fit[ranks] = n > 0 ? 1 : -1;
  }
  if (clusters_fit[ranks] < 0) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaLaunchKernelEx(&config, int8_cluster_kernel<M_TILES>, tm_x, tm_q, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cluster

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

}  // namespace

// float32 x, any M: one pass over K in 128 x 128 tiles.
extern "C" int int8_matmul_f32_launch(const void* x, const void* q, const void* scale, void* out,
                                      int M, int K, int N, int out_f32, void* stream) {
  if (M < 1 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.out_f32 = out_f32;
  const dim3 grid((N + f32::BN - 1) / f32::BN, (M + f32::BM - 1) / f32::BM);
  f32::int8_f32_kernel<<<grid, f32::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// bf16 x, M <= 64: the cluster kernel for `m_tiles` 8-row tiles of x (1, 2, 4,
// 5 or 8). The caller states its whole plan; a plan that is not the kernel's
// own is refused.
extern "C" int int8_matmul_cluster_launch(const void* x, const void* q, const void* scale,
                                          void* out, int M, int K, int N, int out_f32,
                                          int m_tiles, int ranks, int k_per_rank, int grid_n,
                                          int threads, int stages, int smem_bytes, void* stream) {
  if (M < 1 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.k_per_rank = k_per_rank;
  p.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m_tiles) {
    case 1: return cluster::launch<1>(p, ranks, grid_n, threads, stages, smem_bytes, s);
    case 2: return cluster::launch<2>(p, ranks, grid_n, threads, stages, smem_bytes, s);
    case 4: return cluster::launch<4>(p, ranks, grid_n, threads, stages, smem_bytes, s);
    case 5: return cluster::launch<5>(p, ranks, grid_n, threads, stages, smem_bytes, s);
    case 8: return cluster::launch<8>(p, ranks, grid_n, threads, stages, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  p.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_m == 256) return tiled::launch<2>(p, grid_m, grid_n, smem_bytes, s);
  if (tile_m == 128) return tiled::launch<1>(p, grid_m, grid_n, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
