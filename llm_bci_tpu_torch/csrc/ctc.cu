// CTC loss kernels for Hopper (sm_90a): the alpha recursion (forward) and
// the beta recursion with posterior occupancy (backward).
//
// Replaces the Pallas TPU kernels of llm_bci_tpu/ops/ctc_pallas.py:
//   _fwd_kernel (launched by _run_fwd)  -> ctc_alpha_kernel
//   _bwd_kernel (launched by _run_bwd)  -> ctc_beta_kernel
// with the same semantics (torch CTCLoss(reduction="none", blank,
// zero_infinity)), not the same blocking:
//   * One block per example, one thread per lattice slot s of the
//     blank-interleaved label sequence z (L = 2S+1 <= 1024 slots). The
//     recursion over T is a loop inside the block; the stay / +1 / +2
//     neighbour exchange goes through shared memory, double-buffered, with
//     one __syncthreads() per frame. The loop runs min(T, input_length)
//     frames, so frames past the length cost nothing.
//   * Emissions are read straight from log_probs[b, t, z[s]]; the TPU
//     kernel's one-hot matmul was a workaround for slow gathers there. The
//     next frame's emission is loaded before the current frame's barrier.
//   * The s-1 and s-2 moves are bounds-checked: the TPU kernel's unmasked
//     circular roll was safe only thanks to its dead pad slots.
//   * NEG_INF = -1e30 is a finite sentinel and the log-sum-exp is clamped
//     at it, as in the JAX package, so zero_infinity (loss >= 5e29 -> 0)
//     and the infeasible-example guard of the gradient agree with it.
//   * The recursions run in double precision. Log-probabilities of a
//     lattice reach a few hundred at T=121, where a float32 ulp is ~3e-5;
//     summed over 121 sequential steps that is ~1e-4 relative error in the
//     occupancy exp(alpha + beta - log p), the size of the gradient's
//     tolerance. Doubles cost latency the kernel has to spare (few threads
//     per SM, one barrier per frame) and keep the error near 1e-7.
//   * The forward kernel stores the (B, T, L) alpha lattice when a gradient
//     is wanted (8 MB of doubles at B=64, T=121, L=129) instead of recomputing
//     it; the backward kernel runs beta from the terminal slots, forms the
//     occupancy exp(alpha + beta - log p) and scatters it from slots to the
//     vocabulary with shared-memory atomics: grad[b, t, v] =
//     -g[b] * sum_{s: z_s = v} occ[b, t, s]. Rows at and past the input
//     length get zero.
// What bounds it on an H100: latency. Each frame is a few exp/log per
// thread and one barrier, and the T frames are sequential; at B=64 only 64
// of the 132 SMs hold a block. Memory traffic is small (the emission reads
// of one (T, V) slab per example, the lattice and the gradient).
#include <cuda_runtime.h>

namespace {

constexpr double NEG_INF = -1e30;

__device__ __forceinline__ double lse2(double a, double b) {
  const double m = fmax(fmax(a, b), NEG_INF);
  return m + log(exp(a - m) + exp(b - m));
}

__device__ __forceinline__ double lse3(double a, double b, double c) {
  const double m = fmax(fmax(fmax(a, b), c), NEG_INF);
  return m + log(exp(a - m) + exp(b - m) + exp(c - m));
}

// Label of slot s: blank on even slots, targets[(s-1)/2] on odd ones
// (clamped into [0, V) so that a bad label cannot read out of bounds).
__device__ __forceinline__ int slot_label(const int* tgt, int s, int blank, int V) {
  if ((s & 1) == 0) return blank;
  return min(max(tgt[(s - 1) >> 1], 0), V - 1);
}

// The move s-2 -> s is legal into a label that differs from slot s-2's.
__device__ __forceinline__ bool can_skip_into(const int* tgt, int s, int blank, int V) {
  if (s < 2) return false;
  const int z = slot_label(tgt, s, blank, V);
  return z != blank && z != slot_label(tgt, s - 2, blank, V);
}

__global__ void ctc_alpha_kernel(
    const float* __restrict__ log_probs,      // (B, T, V)
    const int* __restrict__ targets,          // (B, S)
    const int* __restrict__ input_lengths,    // (B,)
    const int* __restrict__ target_lengths,   // (B,)
    int T, int V, int S, int blank, int zero_infinity,
    double* __restrict__ alpha_out,           // (B, T, L), or null
    float* __restrict__ loss,                 // (B,)
    double* __restrict__ log_p) {             // (B,)
  extern __shared__ double smem[];            // 2 * blockDim.x
  double* buf0 = smem;
  double* buf1 = smem + blockDim.x;
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int L = 2 * S + 1;
  const int Sb = min(max(target_lengths[b], 0), S);
  const int Lb = 2 * Sb + 1;
  const int n = min(max(input_lengths[b], 1), T);
  const bool live = s < Lb;
  const int* tgt = targets + (long long)b * S;
  const float* lp = log_probs + (long long)b * T * V;
  double* arow = alpha_out ? alpha_out + (long long)b * T * L : nullptr;

  int z = blank;
  bool skip_in = false;
  if (live) {
    z = slot_label(tgt, s, blank, V);
    skip_in = can_skip_into(tgt, s, blank, V);
  }
  // alpha_0: only slot 0 and (for a non-empty target) slot 1 are reachable.
  double a = (live && s <= 1) ? (double)lp[z] : NEG_INF;
  buf0[s] = a;
  if (arow && s < L) arow[s] = a;
  float e_next = (live && n > 1) ? lp[V + z] : 0.f;
  __syncthreads();

  for (int t = 1; t < n; ++t) {
    const double* prev = (t & 1) ? buf0 : buf1;
    double* cur = (t & 1) ? buf1 : buf0;
    const double e = e_next;
    if (live && t + 1 < n) e_next = lp[(long long)(t + 1) * V + z];
    a = NEG_INF;
    if (live) {
      const double adv1 = s >= 1 ? prev[s - 1] : NEG_INF;
      const double adv2 = skip_in ? prev[s - 2] : NEG_INF;
      a = lse3(prev[s], adv1, adv2) + e;
    }
    cur[s] = a;
    if (arow && s < L) arow[(long long)t * L + s] = a;
    __syncthreads();
  }

  if (s == 0) {
    const double* fin = ((n - 1) & 1) ? buf1 : buf0;
    const double last_label = Sb > 0 ? fin[2 * Sb - 1] : NEG_INF;
    const double lpv = lse2(fin[2 * Sb], last_label);
    double l = -lpv;
    if (zero_infinity && l >= -NEG_INF / 2) l = 0.0;
    loss[b] = (float)l;
    log_p[b] = lpv;
  }
}

__global__ void ctc_beta_kernel(
    const float* __restrict__ log_probs,      // (B, T, V)
    const int* __restrict__ targets,          // (B, S)
    const int* __restrict__ input_lengths,    // (B,)
    const int* __restrict__ target_lengths,   // (B,)
    const double* __restrict__ alpha,         // (B, T, L) from ctc_alpha_kernel
    const double* __restrict__ log_p,         // (B,)
    const float* __restrict__ grad_loss,      // (B,)
    int T, int V, int S, int blank,
    float* __restrict__ grad) {               // (B, T, V)
  extern __shared__ double smem[];            // blockDim.x doubles + V floats
  double* term = smem;                        // beta[t, s] + emission[t, s]
  float* row = reinterpret_cast<float*>(smem + blockDim.x);  // occupancy per label
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int L = 2 * S + 1;
  const int Sb = min(max(target_lengths[b], 0), S);
  const int Lb = 2 * Sb + 1;
  const int n = min(max(input_lengths[b], 1), T);
  const bool live = s < Lb;
  const int* tgt = targets + (long long)b * S;
  const float* lp = log_probs + (long long)b * T * V;
  const double* arow = alpha + (long long)b * T * L;
  float* g = grad + (long long)b * T * V;

  for (long long i = (long long)n * V + s; i < (long long)T * V; i += blockDim.x) g[i] = 0.f;
  const double lpb = log_p[b];
  if (!(isfinite(lpb) && lpb > NEG_INF / 2)) {
    // Infeasible example: zero loss under zero_infinity, zero gradient.
    for (long long i = s; i < (long long)n * V; i += blockDim.x) g[i] = 0.f;
    return;
  }
  const float scale = -grad_loss[b];

  int z = blank;
  bool skip_out = false;  // the move s -> s+2 is legal
  if (live) {
    z = slot_label(tgt, s, blank, V);
    skip_out = s + 2 < Lb && can_skip_into(tgt, s + 2, blank, V);
  }
  // beta at the last valid frame: the terminal gate (last blank, last label).
  double beta = (live && (s == 2 * Sb || (Sb > 0 && s == 2 * Sb - 1))) ? 0.0 : NEG_INF;
  double e = live ? lp[(long long)(n - 1) * V + z] : 0.0;
  double al = live ? arow[(long long)(n - 1) * L + s] : NEG_INF;

  for (int t = n - 1; t >= 0; --t) {
    for (int v = s; v < V; v += blockDim.x) row[v] = 0.f;
    const float occ = live ? (float)exp(fmin(al + beta - lpb, 0.0)) : 0.f;
    term[s] = live ? beta + e : NEG_INF;
    if (live && t > 0) {
      e = lp[(long long)(t - 1) * V + z];
      al = arow[(long long)(t - 1) * L + s];
    }
    __syncthreads();
    if (occ != 0.f) atomicAdd(&row[z], occ);
    double next_beta = NEG_INF;
    if (live) {
      const double t1 = s + 1 < Lb ? term[s + 1] : NEG_INF;
      const double t2 = skip_out ? term[s + 2] : NEG_INF;
      next_beta = lse3(term[s], t1, t2);
    }
    __syncthreads();
    for (int v = s; v < V; v += blockDim.x) g[(long long)t * V + v] = scale * row[v];
    beta = next_beta;
    __syncthreads();
  }
}

int threads_for(int S) {
  const int L = 2 * S + 1;
  return ((L + 31) / 32) * 32;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches one kernel
// on the given stream and returns cudaGetLastError() (0 on success).
extern "C" int ctc_alpha_launch(
    const float* log_probs, const int* targets, const int* input_lengths,
    const int* target_lengths, int B, int T, int V, int S, int blank,
    int zero_infinity, double* alpha_out, float* loss, double* log_p, void* stream) {
  const int threads = threads_for(S);
  const size_t smem = 2 * threads * sizeof(double);
  ctc_alpha_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_probs, targets, input_lengths, target_lengths, T, V, S, blank,
      zero_infinity, alpha_out, loss, log_p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctc_beta_launch(
    const float* log_probs, const int* targets, const int* input_lengths,
    const int* target_lengths, const double* alpha, const double* log_p,
    const float* grad_loss, int B, int T, int V, int S, int blank, float* grad,
    void* stream) {
  const int threads = threads_for(S);
  const size_t smem = threads * sizeof(double) + V * sizeof(float);
  ctc_beta_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_probs, targets, input_lengths, target_lengths, alpha, log_p,
      grad_loss, T, V, S, blank, grad);
  return static_cast<int>(cudaGetLastError());
}
