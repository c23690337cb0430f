// B2: particle-filter train-mode step tail, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of multimodalfilter_tpu/ops/pallas_pf.py:
//   B2f  _pf_estimate_fwd_kernel (:458), the forward of pf_update_estimate;
//   B2b  _pf_estimate_bwd_kernel (:486), its custom-VJP backward.
// For each batch row n, in fp32, with x = particles[n] (M, D):
//
//   forward   s       = log_weights + log_liks
//             lw'     = s - max s - log(sum exp(s - max s))
//             p       = exp(s - max s) / sum exp(s - max s)
//             est[d]  = sum_m p[m] * x[m, d]
//   backward  p       = exp(lw')
//             g_s[m]  = g_lw'[m] - p[m] * sum(g_lw') + p[m] * (x[m].g_est - est.g_est)
//             g_x[m,d]= p[m] * g_est[d]
//
// and the gradient of both log_weights and log_liks is g_s. No resampling:
// gradients flow through the weights during BPTT.
//
// Layout is the JAX public layout: (N, M) rows, particles and g_x (N, M, D)
// row-major, est and g_est (N, D). fp32, contiguous, one device, 1 <= D <= 8,
// any M >= 1 (B2 has no M cap).
//
// Design. The TPU kernels pad M to 128 lanes and D to 128 and form the
// estimate with an MXU dot_general. None of that is carried over: the main
// path has M = 30 and D = 3. One warp owns one batch row and its lanes
// stride over M, so any M works without padding; a block holds kRowsPerBlock
// rows (one per warp). The forward reads the row once for an online
// (max, sum-exp) pair per lane, merged across the warp by shuffles, and once
// more to write lw' and accumulate per-lane partial p*x[d] sums in registers
// (D <= 8), reduced by shuffles. The backward reduces sum(g_lw') by shuffle,
// then writes g_s and g_x in one pass. Nothing is staged in shared memory
// and no intermediate touches device memory.
//
// Bound. Forward: 4 * (N*M*(3 + D) + N*D) bytes, about 23 KB at N = 32,
// M = 30, D = 3 (7 ns at 3.35 TB/s); backward: 4 * (N*M*(3 + 2D) + 2*N*D)
// bytes, about 35 KB there. The arithmetic is a few tens of operations per
// particle. Both are launch-latency bound at the main path's shapes; the
// design answers with one launch each per filter step and no host
// synchronisation.
//
// Entry points: plain C functions (built with nvcc into a shared library and
// bound with ctypes). Each launches on the given stream, allocates nothing,
// and returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxD = 8;
constexpr int kRowsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Merge two (max, sum of exp(v - max)) pairs. An empty pair is (-inf, 0).
__device__ __forceinline__ void merge_max_sum(float& mx, float& sm, float mx2,
                                              float sm2) {
  const float m = fmaxf(mx, mx2);
  if (m == -INFINITY) return;  // both empty
  sm = sm * expf(mx - m) + sm2 * expf(mx2 - m);
  mx = m;
}

__global__ void pf_estimate_fwd_kernel(const float* __restrict__ lw,
                                       const float* __restrict__ ll,
                                       const float* __restrict__ particles,
                                       float* __restrict__ out_lw,
                                       float* __restrict__ est,
                                       int N, int M, int D) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  const size_t row = static_cast<size_t>(n) * M;

  // --- pass 1: per-lane online max and sum of exp, merged across the warp ---
  float mx = -INFINITY, sm = 0.0f;
  for (int m = lane; m < M; m += 32) {
    const float s = lw[row + m] + ll[row + m];
    if (s > mx) {
      sm = sm * expf(mx - s) + 1.0f;
      mx = s;
    } else if (mx != -INFINITY) {  // s = mx = -inf adds nothing
      sm += expf(s - mx);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float mx2 = __shfl_xor_sync(kFull, mx, o);
    const float sm2 = __shfl_xor_sync(kFull, sm, o);
    merge_max_sum(mx, sm, mx2, sm2);
  }
  const float log_total = logf(sm);
  const float inv_total = 1.0f / sm;

  // --- pass 2: normalised log-weights and per-lane estimate partials ---
  float acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = 0.0f;
  for (int m = lane; m < M; m += 32) {
    const float shifted = lw[row + m] + ll[row + m] - mx;
    out_lw[row + m] = shifted - log_total;
    const float p = expf(shifted) * inv_total;
    const float* x = particles + (row + m) * D;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) acc[d] += p * x[d];
    }
  }
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    if (d < D) {
      const float r = warp_sum(acc[d]);
      if (lane == 0) est[static_cast<size_t>(n) * D + d] = r;
    }
  }
}

__global__ void pf_estimate_bwd_kernel(const float* __restrict__ lwn,
                                       const float* __restrict__ particles,
                                       const float* __restrict__ est,
                                       const float* __restrict__ g_lw,
                                       const float* __restrict__ g_est,
                                       float* __restrict__ g_s,
                                       float* __restrict__ g_particles,
                                       int N, int M, int D) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (n >= N) return;
  const size_t row = static_cast<size_t>(n) * M;

  // Every lane holds the row's g_est and est . g_est (D <= 8 loads each).
  float ge[kMaxD];
  float eg = 0.0f;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) {
    ge[d] = d < D ? g_est[static_cast<size_t>(n) * D + d] : 0.0f;
    if (d < D) eg += est[static_cast<size_t>(n) * D + d] * ge[d];
  }

  float part = 0.0f;
  for (int m = lane; m < M; m += 32) part += g_lw[row + m];
  const float sum_glw = warp_sum(part);

  for (int m = lane; m < M; m += 32) {
    const float p = expf(lwn[row + m]);
    const float* x = particles + (row + m) * D;
    float* gx = g_particles + (row + m) * D;
    float xg = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) {
      if (d < D) {
        xg += x[d] * ge[d];
        gx[d] = p * ge[d];
      }
    }
    g_s[row + m] = g_lw[row + m] - p * sum_glw + p * (xg - eg);
  }
}

bool bad_shape(int N, int M, int D) {
  return N < 1 || M < 1 || D < 1 || D > kMaxD;
}

int blocks(int N) { return (N + kRowsPerBlock - 1) / kRowsPerBlock; }

}  // namespace

extern "C" int pf_update_estimate_fwd_f32(const float* lw, const float* ll,
                                          const float* particles, float* out_lw,
                                          float* est, int N, int M, int D,
                                          void* stream) {
  if (bad_shape(N, M, D)) return static_cast<int>(cudaErrorInvalidValue);
  pf_estimate_fwd_kernel<<<blocks(N), kRowsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lw, ll, particles, out_lw, est, N, M, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pf_update_estimate_bwd_f32(const float* lwn, const float* particles,
                                          const float* est, const float* g_lw,
                                          const float* g_est, float* g_s,
                                          float* g_particles, int N, int M, int D,
                                          void* stream) {
  if (bad_shape(N, M, D)) return static_cast<int>(cudaErrorInvalidValue);
  pf_estimate_bwd_kernel<<<blocks(N), kRowsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lwn, particles, est, g_lw, g_est, g_s, g_particles, N, M, D);
  return static_cast<int>(cudaGetLastError());
}
