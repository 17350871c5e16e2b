// CTC loss kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of llm_bci_tpu/ops/ctc_pallas.py:
//   _fwd_kernel (the alpha recursion, launched by _run_fwd)
//     -> ctc_alpha_kernel, the forward when no gradient is wanted;
//   _bwd_kernel (alpha recomputed, the beta recursion and the occupancies,
//   launched by _run_bwd), together with _fwd_kernel
//     -> ctc_alpha_beta_kernel, the forward that also writes the gradient.
// The semantics are torch CTCLoss(reduction="none", blank, zero_infinity) with
// the JAX package's finite sentinel NEG_INF = -1e30: zero_infinity zeroes a
// loss >= 5e29, and an infeasible example gets a zero gradient.
//
// What bounds it on an H100: a chain of n dependent frames (n = the input
// length; 121 at the NDT1-CTC flagship), each a log-sum-exp for every slot of
// the blank-interleaved labels z = [blank, y1, blank, ..., yS, blank]
// (L = 2S+1 slots). Its bytes (a (T, V) slab of log-probs in, the loss and a
// (T, V) gradient out) would take well under a microsecond; the time is n
// times the latency of one frame, and a frame is as slow as the scheduler
// with the most instructions to dispatch in it. So the design spreads a frame
// over the SM's four schedulers and keeps its chain in FP32:
//   * Each thread owns two consecutive slots, a blank (2g) and a label
//     (2g+1); a recursion has ceil(L/64) warps (3 at L = 129), one on each
//     scheduler. A blank slot takes two moves (stay, advance) and a label
//     three (and the skip where it is legal), so the blank's log-sum-exp has
//     two terms and no lane of a warp branches on the slot's kind. Neighbour
//     slots go through a double-buffered row of shared memory with one
//     barrier of the recursion's warps a frame.
//   * Log space in double-float: each value is a (hi, lo) pair of floats
//     (about 48 bits), because a lattice's log-probabilities reach hundreds,
//     where a float ulp is 3e-5 (a float32 recursion missed the gradient by
//     1.9e-4). The max is chosen on (hi, lo), the differences from it are
//     formed in float, the two that need not be 0 go through expf, their
//     sum through log1pf, and the result and the emission are added back
//     with exact two-sums. No double instruction and no conversion is on the chain
//     (one warp with five double slots a lane took 1.07 us a frame). About
//     1e-7 of error a frame. A linear-space scaled recursion would be
//     cheaper still, but it underflows the one feasible path of a confident
//     model, which can lie hundreds of nats below the frame's best slot.
//   * The emissions log_probs[b, t, z_s] of a thread's slots are gathered by
//     cp.async into a ring of RING frames in shared memory, RING - 1 frames
//     ahead of the frame in work.
//   * With a gradient, a cluster of two blocks of 512 threads an example, on
//     two SMs: in block 0 the recursion's warps run alpha from t = 0 while in
//     block 1 they run beta from t = n-1, so the chain is n frames and not
//     2n, and no lattice goes through device memory between two kernels. Each
//     block keeps its whole (T, L) lattice of pairs in its own shared memory
//     where it fits (121 KB at T = 121, L = 129; T <= 167 at L = 129) and else
//     in a global scratch (T = 1000 unstacked trials).
//   * After one cluster barrier all the threads of each block form the
//     occupancies exp(alpha_t + beta_t - log p) of half the frames, reading
//     the other block's lattice through distributed shared memory: a thread
//     takes a frame and a blank-label pair of slots, four at a time with
//     their loads first, and writes the two occupancies to a row of shared
//     memory; each vocabulary entry then adds its chain of label slots (the
//     blank its blank slots) in a fixed order and is written once to
//     occ[b, t, v]. No atomics, so the same bits every run: shared-memory
//     float atomics there took longer than the recursions. Frames at and past
//     n get 0. The backward is a multiply by -grad_loss[b] (ops/ctc_cuda.py).
//     (Forming the occupancies while the recursions run, in the warps they
//     leave idle, measured slower: PERF.md.)
//   * log p and the loss come from alpha's terminal slots, in double, in both
//     kernels, so a forward with and without a gradient give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr double NEG_INF_D = -1e30;   // the thresholds: a loss >= 5e29 is infinite
constexpr int SLOTS = 2;             // slots a thread: a blank and a label
constexpr int RING = 8;              // frames of emissions a block keeps in shared memory
constexpr int MAX_SLOTS = 1024;      // L = 2S+1 <= 16 warps x 32 threads x 2 slots
constexpr int MAX_VOCAB = 8192;
constexpr int MAX_SMEM = 232448;     // shared memory a block can have on an H100
constexpr int HEAD = 16;             // bytes: log p (double) of the example
constexpr int ACC_BYTES = 49152;     // occupancy rows of the fused kernel, at most
constexpr int FUSED_THREADS = 512;   // a block of the fused kernel: its recursion, then all in the pass

enum Lattice { LATTICE_NONE = 0, LATTICE_SHARED = 1, LATTICE_GLOBAL = 2 };

// A double-float: hi + lo, |lo| <= ulp(hi) / 2.
struct DF {
  float hi, lo;
};

__device__ __forceinline__ DF df(float x) { return DF{x, 0.f}; }

// s + err == a + b exactly (Knuth's two-sum; nvcc does not reassociate).
__device__ __forceinline__ DF two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return DF{s, (a - (s - bb)) + (b - bb)};
}

// x + f, renormalised.
__device__ __forceinline__ DF df_add(DF x, float f) {
  const DF s = two_sum(x.hi, f);
  const float lo = s.lo + x.lo;
  const float hi = s.hi + lo;
  return DF{hi, lo - (hi - s.hi)};
}

// x - m in float: hi parts first (exact when they are close, and precision
// does not matter when they are not).
__device__ __forceinline__ float df_diff(DF x, DF m) { return (x.hi - m.hi) + (x.lo - m.lo); }

__device__ __forceinline__ double df_to_double(DF x) {
  return static_cast<double>(x.hi) + static_cast<double>(x.lo);
}

// min / max that return NaN when either argument is NaN (fminf drops it), so
// that a NaN log-prob still reaches the loss.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The larger pair, hi first and lo on a tie: a dead slot (hi = NEG_INF) keeps
// the emissions it adds in lo, so two of them can tie on hi and differ in lo.
__device__ __forceinline__ DF df_max(DF a, DF b) {
  return b.hi > a.hi || (b.hi == a.hi && b.lo > a.lo) ? b : a;
}

// log(e^a + e^b): one of the differences from the max is 0.
__device__ __forceinline__ DF lse2(DF a, DF b) {
  const DF m = df_max(a, b);
  const float lo = min_nan(df_diff(a, m), df_diff(b, m));
  return df_add(m, log1pf(expf(lo)));
}

// log(e^a + e^b + e^c): the two smallest differences go through expf.
__device__ __forceinline__ DF lse3(DF a, DF b, DF c) {
  const DF m = df_max(df_max(a, b), c);
  const float da = df_diff(a, m), db = df_diff(b, m), dc = df_diff(c, m);
  const float lo_ab = min_nan(da, db);
  const float lo = min_nan(lo_ab, dc);
  const float mid = max_nan(lo_ab, min_nan(max_nan(da, db), dc));
  return df_add(m, log1pf(expf(lo) + expf(mid)));
}

// In double: once an example. Clamped at the float sentinel, which is below
// -1e30 in double: two dead slots give NEG_INF + log 2, not log 0.
__device__ __forceinline__ double lse2_double(double a, double b) {
  const double m = fmax(fmax(a, b), static_cast<double>(NEG_INF));
  return m + log(exp(a - m) + exp(b - m));
}

__device__ __forceinline__ int label(const int* tgt, int i, int V) {
  return min(max(tgt[i], 0), V - 1);   // a bad label cannot read out of bounds
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both blocks: writes before it are visible to reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The generic address of the same shared-memory location in block `rank`.
template <typename P>
__device__ __forceinline__ P* in_rank(P* local, unsigned rank) {
  uint64_t remote;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(remote) : "l"(reinterpret_cast<uint64_t>(local)), "r"(rank));
  return reinterpret_cast<P*>(remote);
}

__host__ __device__ __forceinline__ int recursion_threads(int L) { return 32 * ((L + 63) / 64); }

// The barrier of the recursion's threads (the first G of the block).
__device__ __forceinline__ void recursion_sync(int G) {
  asm volatile("bar.sync 1, %0;" ::"r"(G) : "memory");
}

// What a block knows of its example and of its thread's two slots.
struct Example {
  const float* lp;       // (T, V) log-probs of the example
  const int* tgt;        // (S,) labels
  int T, V, S, L, blank;
  int Sb, Lb, n;         // target length, live slots, input length (clamped)
  int G;                 // threads of the recursion: 32 x ceil(L / 64)
  int s0;                // the thread's blank slot; s0 + 1 its label slot
  int z1;                // the label slot's label
  bool live0, live1;     // s0 < Lb, s0 + 1 < Lb
};

__device__ __forceinline__ Example example(const float* log_probs, const int* targets,
                                           const int* input_lengths, const int* target_lengths,
                                           int b, int T, int V, int S, int blank) {
  Example x;
  x.lp = log_probs + static_cast<long long>(b) * T * V;
  x.tgt = targets + static_cast<long long>(b) * S;
  x.T = T;
  x.V = V;
  x.S = S;
  x.L = 2 * S + 1;
  x.blank = blank;
  x.Sb = min(max(target_lengths[b], 0), S);
  x.Lb = 2 * x.Sb + 1;
  x.n = min(max(input_lengths[b], 1), T);
  x.G = recursion_threads(x.L);
  const int g = threadIdx.x;
  x.s0 = 2 * g;
  x.live0 = x.s0 < x.Lb;
  x.live1 = x.s0 + 1 < x.Lb;
  x.z1 = x.live1 ? label(x.tgt, g, V) : blank;
  return x;
}

// The emissions of a thread's two slots for its steps k = 0, 1, ... (frame
// first + k * dir, k < count), gathered by cp.async RING - 1 steps ahead into
// RING stages of 2 x threads floats. Each thread reads only what it copied, so
// cp.async.wait_group is the only fence.
struct Ring {
  float* buf;
  int first, dir, count;

  __device__ __forceinline__ void fetch(const Example& x, int k) {
    if (k < count) {
      const float* src = x.lp + static_cast<long long>(first + k * dir) * x.V;
      float* dst = buf + (k % RING) * 2 * x.G + threadIdx.x;
      if (x.live0) cp_async4(dst, src + x.blank);
      if (x.live1) cp_async4(dst + x.G, src + x.z1);
    }
    cp_async_commit();   // an empty group past the end keeps the count
  }

  __device__ __forceinline__ void start(const Example& x) {
    for (int k = 0; k < RING - 1; ++k) fetch(x, k);
  }

  // Steps are read in order. The refill goes to the stage read one step
  // before, whose values the last frame has already used.
  __device__ __forceinline__ void get(const Example& x, int k, float& e0, float& e1) {
    fetch(x, k + RING - 1);
    cp_async_wait<RING - 1>();
    const float* src = buf + (k % RING) * 2 * x.G + threadIdx.x;
    e0 = x.live0 ? src[0] : 0.f;
    e1 = x.live1 ? src[x.G] : 0.f;
  }
};

// Shared-memory layout of a block: [head: log p] [lattice, T x L pairs, when
// in shared memory] [exchange rows, 2 x (2G + 4) pairs] [ring, RING x 2G
// floats] and, in the fused kernel, [acc_rows rows of 2G floats] [head: V
// ints] [next, labels: G ints each]; G the recursion's threads.
struct Smem {
  double* logp;
  DF* lattice;
  DF* xrow;       // two rows; slot s at s + 2, the pads NEG_INF
  float* ring;
  float* part;
  int* head;
  int* next;
  int* zl;
  int xlen;
};

__device__ __forceinline__ Smem carve(unsigned char* smem, const Example& x, bool lattice_shared,
                                      int acc_rows) {
  Smem m;
  m.logp = reinterpret_cast<double*>(smem);
  unsigned char* p = smem + HEAD;
  m.lattice = reinterpret_cast<DF*>(p);
  if (lattice_shared) p += static_cast<long long>(x.T) * x.L * sizeof(DF);
  m.xlen = 2 * x.G + 4;
  m.xrow = reinterpret_cast<DF*>(p);
  p += 2 * m.xlen * sizeof(DF);
  m.ring = reinterpret_cast<float*>(p);
  p += RING * 2 * x.G * sizeof(float);
  m.part = reinterpret_cast<float*>(p);
  p += static_cast<long long>(acc_rows) * 2 * x.G * sizeof(float);
  m.head = reinterpret_cast<int*>(p);
  m.next = m.head + x.V;
  m.zl = m.next + x.G;
  return m;
}

// The alpha recursion over frames 0 .. n-1; alpha_t goes to lattice row t when
// a lattice is given. Ends with log p in *m.logp and the loss written.
__device__ void alpha_pass(const Example& x, const Smem& m, DF* lattice, int zero_infinity,
                           float* loss) {
  const int s0 = x.s0;
  bool skip1 = false;   // the move s0-1 -> s0+1 (label into label) is legal
  if (x.live1 && s0 >= 2) {
    const int prev = label(x.tgt, s0 / 2 - 1, x.V);
    skip1 = x.z1 != x.blank && x.z1 != prev;
  }
  for (int i = threadIdx.x; i < 2 * m.xlen; i += x.G) m.xrow[i] = df(NEG_INF);
  Ring ring{m.ring, 0, 1, x.n};
  ring.start(x);
  float e0, e1;
  ring.get(x, 0, e0, e1);
  // alpha_0: slot 0 and, for a non-empty target, slot 1.
  DF a0 = df(x.live0 && s0 == 0 ? e0 : NEG_INF);
  DF a1 = df(x.live1 && s0 == 0 ? e1 : NEG_INF);
  recursion_sync(x.G);   // the pads are set
  for (int t = 0;; ++t) {
    DF* row = m.xrow + (t & 1) * m.xlen;
    row[s0 + 2] = a0;
    row[s0 + 3] = a1;
    if (lattice) {
      DF* lrow = lattice + static_cast<long long>(t) * x.L;
      if (s0 < x.L) lrow[s0] = a0;
      if (s0 + 1 < x.L) lrow[s0 + 1] = a1;
    }
    recursion_sync(x.G);
    if (t + 1 >= x.n) break;
    const DF p1 = row[s0 + 1];                    // slot s0 - 1 of frame t
    ring.get(x, t + 1, e0, e1);
    const DF n0 = df_add(lse2(a0, p1), e0);       // blank: stay, advance
    const DF n1 = df_add(lse3(a1, a0, skip1 ? p1 : df(NEG_INF)), e1);   // label: and the skip
    a0 = x.live0 ? n0 : df(NEG_INF);
    a1 = x.live1 ? n1 : df(NEG_INF);
  }
  cp_async_wait<0>();
  if (threadIdx.x == 0) {
    // loss = -logsumexp(alpha_{n-1}[2Sb], alpha_{n-1}[2Sb-1])
    const DF* fin = m.xrow + ((x.n - 1) & 1) * m.xlen + 2;
    const double last_blank = df_to_double(fin[2 * x.Sb]);
    const double last_label =
        x.Sb > 0 ? df_to_double(fin[2 * x.Sb - 1]) : static_cast<double>(NEG_INF);
    const double lp = lse2_double(last_blank, last_label);
    double l = -lp;
    if (zero_infinity && l >= -NEG_INF_D / 2) l = 0.0;
    *loss = static_cast<float>(l);
    *m.logp = lp;
  }
}

// The beta recursion over frames n-1 .. 0 into lattice row t; rows t >= n of
// the occupancy output are zeroed on the way.
__device__ void beta_pass(const Example& x, const Smem& m, DF* lattice, float* occ) {
  const int s0 = x.s0;
  bool skip1 = false;   // the move s0+1 -> s0+3 (label into label) is legal
  if (x.live1 && s0 + 3 < x.Lb) {
    const int next = label(x.tgt, s0 / 2 + 1, x.V);
    skip1 = next != x.blank && next != x.z1;
  }
  for (int i = threadIdx.x; i < 2 * m.xlen; i += x.G) m.xrow[i] = df(NEG_INF);
  for (long long i = static_cast<long long>(x.n) * x.V + threadIdx.x;
       i < static_cast<long long>(x.T) * x.V; i += x.G)
    occ[i] = 0.f;
  Ring ring{m.ring, x.n - 1, -1, x.n - 1};   // frames n-1 .. 1
  ring.start(x);
  // beta_{n-1}: the terminal slots (last blank, last label).
  DF b0 = df(x.live0 && s0 == 2 * x.Sb ? 0.f : NEG_INF);
  DF b1 = df(x.live1 && s0 + 1 == 2 * x.Sb - 1 ? 0.f : NEG_INF);
  float e0 = 0.f, e1 = 0.f;
  if (x.n > 1) ring.get(x, 0, e0, e1);           // frame n-1
  recursion_sync(x.G);   // the pads are set
  for (int t = x.n - 1;; --t) {
    DF* lrow = lattice + static_cast<long long>(t) * x.L;
    if (s0 < x.L) lrow[s0] = b0;
    if (s0 + 1 < x.L) lrow[s0 + 1] = b1;
    if (t == 0) break;
    const DF term0 = x.live0 ? df_add(b0, e0) : df(NEG_INF);
    const DF term1 = x.live1 ? df_add(b1, e1) : df(NEG_INF);
    DF* row = m.xrow + (t & 1) * m.xlen;
    row[s0 + 2] = term0;
    row[s0 + 3] = term1;
    recursion_sync(x.G);
    const DF t2 = row[s0 + 4], t3 = row[s0 + 5];  // slots s0 + 2, s0 + 3
    // frame t-1's emissions for the next step, off this step's chain
    if (t > 1) ring.get(x, x.n - t, e0, e1);
    const DF n0 = lse2(term0, term1);             // blank: stay, advance
    const DF n1 = lse3(term1, t2, skip1 ? t3 : df(NEG_INF));   // label: and the skip
    b0 = x.live0 ? n0 : df(NEG_INF);
    b1 = x.live1 ? n1 : df(NEG_INF);
  }
  cp_async_wait<0>();
}

// exp(alpha + beta - log p) of a slot. alpha + beta - log p is near 0 where
// it matters: the hi parts by a two-sum, then log p's hi part exactly off the
// sum, then the small parts.
__device__ __forceinline__ float occupancy(DF a, DF b, float lp_hi, float lp_lo) {
  const DF h = two_sum(a.hi, b.hi);
  const float x = (h.hi - lp_hi) + ((h.lo + a.lo + b.lo) - lp_lo);
  return expf(fminf(x, 0.f));
}

// The label slots of each vocabulary entry as a chain: head[v] is the first
// label index g with z = v, next[g] the following one (-1 ends a chain).
// Built from the labels in shared memory by all the block's threads.
__device__ void label_chains(const Example& x, const Smem& m) {
  for (int q = threadIdx.x; q < x.Sb; q += blockDim.x) {
    const int z = m.zl[q];
    int next = -1;
    bool first = true;
    for (int k = 0; k < x.Sb; ++k) {
      const bool same = m.zl[k] == z;
      first = first && !(same && k < q);
      if (same && k > q && next < 0) next = k;
    }
    m.next[q] = next;
    if (first) m.head[z] = q;
  }
}

// occ[t, v] = sum over the slots s with z_s = v of exp(alpha_t[s] + beta_t[s]
// - log p) for t in [t0, t1), by all the block's threads. An item is a frame
// and a blank-label pair of slots; a thread takes four items at a time, their
// (remote) loads first, and writes the two occupancies to a row of shared
// memory (labels in columns [0, G), blanks in [G, 2G)): no atomics. The
// write-out sums each vocabulary entry over its chain of label slots (the
// blank over the blank slots) in a fixed order, acc_rows frames at a time:
// the same bits every run.
__device__ void occupancy_pass(const Example& x, const Smem& m, const DF* alpha, const DF* beta,
                               double logp, int t0, int t1, int acc_rows, float* occ) {
  const int G = x.G, P = blockDim.x, pairs = x.Sb + 1;
  const bool feasible = isfinite(logp) && logp > NEG_INF_D / 2;
  const float lp_hi = static_cast<float>(logp);
  const float lp_lo = static_cast<float>(logp - static_cast<double>(lp_hi));
  for (int c0 = t0; c0 < t1; c0 += acc_rows) {
    const int rows = min(acc_rows, t1 - c0);
    const int items = rows * pairs;
    for (int j0 = feasible ? threadIdx.x : items; j0 < items; j0 += 4 * P) {
      DF a[4][2], b[4][2];
      int r[4], g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = min(j0 + u * P, items - 1);
        r[u] = j / pairs;
        g[u] = j - r[u] * pairs;
        const long long at = static_cast<long long>(c0 + r[u]) * x.L + 2 * g[u];
        const bool label_live = g[u] < x.Sb;
        a[u][0] = alpha[at];
        b[u][0] = beta[at];
        a[u][1] = label_live ? alpha[at + 1] : df(NEG_INF);
        b[u][1] = label_live ? beta[at + 1] : df(NEG_INF);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u * P < items) {
          float* row = m.part + r[u] * 2 * G;
          row[g[u]] = g[u] < x.Sb ? occupancy(a[u][1], b[u][1], lp_hi, lp_lo) : 0.f;
          row[G + g[u]] = occupancy(a[u][0], b[u][0], lp_hi, lp_lo);
        }
      }
    }
    __syncthreads();
    float* out = occ + static_cast<long long>(c0) * x.V;
    for (int i = threadIdx.x; i < rows * x.V; i += P) {
      const int r = i / x.V, v = i - r * x.V;
      float sum = 0.f;
      if (feasible) {
        const float* row = m.part + r * 2 * G;
        for (int k = m.head[v]; k >= 0; k = m.next[k]) sum += row[k];
        if (v == x.blank)
          for (int k = 0; k <= x.Sb; ++k) sum += row[G + k];
      }
      out[i] = sum;
    }
    __syncthreads();
  }
}

// The forward without a gradient: one block an example runs alpha over its n
// frames and writes the loss.
__global__ void ctc_alpha_kernel(
    const float* __restrict__ log_probs,      // (B, T, V)
    const int* __restrict__ targets,          // (B, S)
    const int* __restrict__ input_lengths,    // (B,)
    const int* __restrict__ target_lengths,   // (B,)
    int T, int V, int S, int blank, int zero_infinity,
    float* __restrict__ loss) {               // (B,)
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const Example x = example(log_probs, targets, input_lengths, target_lengths, b, T, V, S, blank);
  const Smem m = carve(smem, x, false, 0);
  alpha_pass(x, m, nullptr, zero_infinity, loss + b);
}

// The forward with a gradient: a cluster of two blocks an example. In block 0
// the first G threads run alpha, in block 1 beta, at the same time; then all
// the threads of each block form the occupancies of half the frames:
// occ[b, t, v] = sum over the slots s with z_s = v of exp(alpha_t[s] +
// beta_t[s] - log p), 0 for t >= n and for an infeasible example.
__global__ void __launch_bounds__(FUSED_THREADS) ctc_alpha_beta_kernel(
    const float* __restrict__ log_probs,      // (B, T, V)
    const int* __restrict__ targets,          // (B, S)
    const int* __restrict__ input_lengths,    // (B,)
    const int* __restrict__ target_lengths,   // (B,)
    int T, int V, int S, int blank, int zero_infinity,
    int acc_rows,                             // frames of occupancy rows in shared memory
    double* __restrict__ scratch,             // (B, 2, T, L) pairs, or null: in shared memory
    float* __restrict__ loss,                 // (B,)
    float* __restrict__ occ) {                // (B, T, V)
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned rank = cluster_rank();
  const int b = blockIdx.x >> 1;
  const Example x = example(log_probs, targets, input_lengths, target_lengths, b, T, V, S, blank);
  const Smem m = carve(smem, x, scratch == nullptr, acc_rows);
  for (int v = threadIdx.x; v < V; v += blockDim.x) m.head[v] = -1;
  if (threadIdx.x < x.G) m.zl[threadIdx.x] = x.live1 ? x.z1 : -1;
  DF* lattices[2];   // alpha's and beta's, as this block addresses them
  for (unsigned r = 0; r < 2; ++r) {
    lattices[r] = scratch ? reinterpret_cast<DF*>(scratch) + (2LL * b + r) * T * x.L
                          : (r == rank ? m.lattice : in_rank(m.lattice, r));
  }
  float* g = occ + static_cast<long long>(b) * T * V;
  if (threadIdx.x < x.G) {   // the other warps wait at the cluster barrier
    if (rank == 0) {
      alpha_pass(x, m, lattices[0], zero_infinity, loss + b);
    } else {
      beta_pass(x, m, lattices[1], g);
    }
  }
  cluster_sync();   // both lattices and log p are complete
  const double logp = rank == 0 ? *m.logp : *in_rank(m.logp, 0);
  label_chains(x, m);
  __syncthreads();
  const int h = x.n / 2;
  occupancy_pass(x, m, lattices[0], lattices[1], logp, rank == 0 ? 0 : h, rank == 0 ? h : x.n,
                 acc_rows, g);
  cluster_sync();   // no block leaves while the other reads its shared memory
}

long long alpha_smem(int threads) {
  return HEAD + 2LL * (2 * threads + 4) * sizeof(DF) + static_cast<long long>(RING) * 2 * threads * 4;
}

// Frames of occupancy rows a block of the fused kernel keeps: its half of the
// frames, or as many as ACC_BYTES hold (at least one).
int acc_rows_for(int T, int G) {
  const int fit = ACC_BYTES / (8 * G) > 1 ? ACC_BYTES / (8 * G) : 1;
  return (T + 1) / 2 < fit ? (T + 1) / 2 : fit;
}

long long fused_smem(int T, int L, int V, int G, bool lattice_shared) {
  const long long bytes = alpha_smem(G) +
                          (lattice_shared ? static_cast<long long>(T) * L * sizeof(DF) : 0) +
                          static_cast<long long>(acc_rows_for(T, G)) * 2 * G * 4 +
                          (V + 2LL * G) * 4;
  return (bytes + 15) / 16 * 16;
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches one kernel on the given
// stream and returns cudaGetLastError() (0 on success). The caller states its
// whole plan (ops/ctc_cuda.py::ctc_plan): the kernel (fused: with the
// gradient), slots a thread, threads, shared memory, where the lattices live
// (0 none, 1 shared memory, 2 the global scratch) and blocks an example. A
// plan that differs from the kernel's own in any field is refused with
// cudaErrorInvalidValue.
extern "C" int ctc_launch(
    const float* log_probs, const int* targets, const int* input_lengths,
    const int* target_lengths, int B, int T, int V, int S, int blank, int zero_infinity,
    int fused, int slots, int threads, int smem_bytes, int lattice, int cluster,
    double* scratch, float* loss, float* occ, void* stream) {
  const int L = 2 * S + 1;
  if (B < 1 || T < 1 || V < 1 || V > MAX_VOCAB || S < 0 || L > MAX_SLOTS || blank < 0 ||
      blank >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = recursion_threads(L);
  int want_threads = G, want_lattice = LATTICE_NONE, want_cluster = 1;
  long long want_smem = (alpha_smem(G) + 15) / 16 * 16;
  if (fused) {
    want_threads = FUSED_THREADS;
    want_cluster = 2;
    want_lattice = fused_smem(T, L, V, G, true) <= MAX_SMEM ? LATTICE_SHARED : LATTICE_GLOBAL;
    want_smem = fused_smem(T, L, V, G, want_lattice == LATTICE_SHARED);
  }
  if (slots != SLOTS || threads != want_threads || smem_bytes != want_smem ||
      lattice != want_lattice || cluster != want_cluster || want_smem > MAX_SMEM ||
      loss == nullptr || (fused && occ == nullptr) ||
      ((lattice == LATTICE_GLOBAL) != (scratch != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The opt-in to more than 48 KB of shared memory, once a kernel and device
  // (outside any stream capture: the first launch runs eagerly).
  static bool opted[2][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[fused != 0][dev]) {
    err = fused ? cudaFuncSetAttribute(ctc_alpha_beta_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM)
                : cudaFuncSetAttribute(ctc_alpha_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[fused != 0][dev] = true;
  }
  if (!fused) {
    ctc_alpha_kernel<<<B, threads, smem_bytes, s>>>(log_probs, targets, input_lengths,
                                                    target_lengths, T, V, S, blank,
                                                    zero_infinity, loss);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * B);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, ctc_alpha_beta_kernel, log_probs, targets, input_lengths,
                           target_lengths, T, V, S, blank, zero_infinity, acc_rows_for(T, G),
                           scratch, loss, occ);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
