// Particle-filter step tail, block-level device functions for one batch row
// (sm_90a). Shared by the eval tails B1, B4 and B5 (pf_resample.cu) and by
// the whole-trajectory kernel B3 (pf_fused_step.cu).
//
// One thread block owns one batch row of M particles; its threads stride
// over M, so any M works. Every function below is called by all threads of
// the block (each contains __syncthreads) and returns the same value to all
// of them. `red` is a scratch of 32 floats in shared memory.
//
// The row's values come through accessors (lambdas over shared or global
// memory), so B3 runs the tail on its shared-memory belief and B1/B4/B5 on
// rows in device memory:
//
//   logit(m)   updated log-weight lw[m] + ll[m]
//   x(m, d)    particle m, state dimension d
//
// The math is ops/pallas_pf.py's: p = exp(v - max v) / sum exp(v - max v);
// est[d] = sum_m p[m] x[m, d] (before resampling); an inclusive CDF of p
// (multinomial) or of the mixture alpha p + (1 - alpha) / M (soft), NOT
// divided by its last entry; idx[j] = #(cdf < target[j]) clipped to M - 1.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pf_tail {

constexpr int kMaxD = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Block reductions: every warp reduces the per-warp partials itself, so the
// result reaches all threads without a second barrier; the leading barrier
// keeps `red` free of an earlier call's readers.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_max(lane < nwarps ? red[lane] : -INFINITY);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nwarps ? red[lane] : 0.0f);
}

// Inclusive scan of one value per thread over the block, in thread order.
// Returns this thread's prefix; *total gets the block's sum.
__device__ __forceinline__ float block_inclusive_scan(float v, float* red,
                                                      float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_inclusive_scan(v, lane);
  __syncthreads();
  if (lane == 31) red[warp] = v;
  __syncthreads();
  const float w = warp_inclusive_scan(lane < nwarps ? red[lane] : 0.0f, lane);
  const float before = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
  *total = __shfl_sync(kFull, w, nwarps - 1);
  return warp > 0 ? v + before : v;
}

struct RowStats {
  float max;  // max_m logit(m)
  float sum;  // sum_m exp(logit(m) - max)
};

// Weight update and log-normalise: the row's max and sum of exponentials.
template <class Logit>
__device__ RowStats row_stats(Logit logit, int M, float* red) {
  float mx = -INFINITY;
  for (int m = threadIdx.x; m < M; m += blockDim.x) mx = fmaxf(mx, logit(m));
  mx = block_max(mx, red);
  float s = 0.0f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) s += expf(logit(m) - mx);
  return {mx, block_sum(s, red)};
}

__device__ __forceinline__ float prob(float logit, RowStats st) {
  return expf(logit - st.max) / st.sum;
}

// Soft resampling's proposal: the mixture alpha p + (1 - alpha) / M, with
// uniform_part = (1 - alpha) / M.
__device__ __forceinline__ float mixture(float p, float alpha, float uniform_part) {
  return alpha * p + uniform_part;
}

// Weighted-mean estimate sum_m p[m] x[m, d]; threads 0..D-1 write est[d].
template <class Prob, class X>
__device__ void row_estimate(Prob p, X x, int M, int D, float* red,
                             float* __restrict__ est) {
  float acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = 0.0f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float pm = p(m);
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) acc[d] += pm * x(m, d);
  }
  for (int d = 0; d < D; ++d) {
    const float r = block_sum(acc[d], red);
    if (threadIdx.x == d) est[d] = r;
  }
}

// Inclusive CDF of f over the row, written to cdf[0..M) (shared or device
// memory), one tile of blockDim values at a time with a running carry.
// Returns cdf[M - 1]. Ends with a barrier, so cdf is readable by all.
template <class F>
__device__ float row_cdf(F f, int M, float* cdf, float* red) {
  float carry = 0.0f;
  for (int base = 0; base < M; base += blockDim.x) {
    const int m = base + threadIdx.x;
    float total;
    const float c = block_inclusive_scan(m < M ? f(m) : 0.0f, red, &total);
    if (m < M) cdf[m] = carry + c;
    carry += total;
  }
  __syncthreads();
  return carry;
}

// First index whose CDF entry is >= target, i.e. #(cdf < target), clipped
// to M - 1 (the TPU kernel's compare-and-count, as a binary search).
__device__ __forceinline__ int cdf_lower_bound(const float* cdf, int M, float target) {
  int lo = 0, hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] < target) lo = mid + 1; else hi = mid;
  }
  return lo < M - 1 ? lo : M - 1;
}

}  // namespace pf_tail
