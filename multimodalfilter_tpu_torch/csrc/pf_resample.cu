// B1, B4 and B5: the particle-filter eval step tail for Hopper (sm_90a).
//
// Replaces the TPU kernels of multimodalfilter_tpu/ops/pallas_pf.py reached
// through pf_update_and_resample:
//   B1  _pf_kernel          :65   multinomial (alpha >= 1), M <= 1024
//   B4  _pf_soft_kernel     :134  soft (alpha < 1), M <= 1024
//   B5  _pf_kernel_chunked  :217  either mode, M > 1024 (the TPU's covers
//                                 M <= 16384; this one every M)
// For each batch row n it computes, in fp32 (pf_tail.cuh has the pieces):
//
//   v       = log_weights + log_liks
//   p       = exp(v - max v) / sum exp(v - max v)
//   est[d]  = sum_m p[m] * particles[m, d]              (before resampling)
//   multinomial: cdf = inclusive prefix sum of p, target[j] = u[j]
//   soft:        q = alpha p + (1 - alpha) / M, cdf = prefix sum of q,
//                target[j] = u[j] * cdf[M-1]     (compare, never divide)
//   idx[j]  = #(cdf < target[j]) clipped to M-1;  out[j] = particles[idx[j]]
//   out_lw  = -log M (multinomial), or the importance weights
//             lwn[idx] - log q[idx] log-normalised (soft), lwn = v - max - log sum
//
// Layout is the JAX public layout: lw, ll, u (N, M); particles and out
// (N, M, D) row-major; est (N, D). fp32, contiguous, one device.
//
// Design. One kernel, templated on the resampling mode; one thread block
// per batch row whose threads stride over M, so one source covers every M.
// The TPU kernels' triangular-matmul cumsum becomes a warp-shuffle block
// scan walked over the row in tiles of blockDim with a running carry; their
// (M x M) compare-and-count becomes one binary search per output slot; their
// one-hot-matmul gather becomes a direct load. Only the CDF is kept: in
// dynamic shared memory up to M = 16,384 (64 KB, opted in above the 48 KB
// default), and above that in a scratch row in device memory that the caller
// allocates. p, the mixture and its log are recomputed from lw + ll where
// they are needed, so no other M-long row is stored (four would need 256 KB
// at M = 16,384, more than a block's 227 KB). B1, B4 and B5 are three entry
// points of this kernel; they differ in mode and in the range of M they take.
//
// Bound. A row moves M * (3 + 2D + 1) * 4 bytes plus D * 4 (lw, ll, u and
// particles in; particles and lw out; est out) and does a few tens of
// operations per slot plus log2(M) for the search, so the card's memory
// bounds it: 0.2 MB at N = 16, M = 300, D = 3, under 0.1 us at 3.35 TB/s;
// 1.3 MB at N = 16, M = 2048, 0.4 us. At the main paths' shapes
// launch latency sets the floor; the design answers with one launch per
// filter step (normalise, estimate, scan, search, gather and reweight fused,
// nothing but the CDF spilled) and batch rows in parallel blocks.
//
// Entry points: plain C functions (built with nvcc into a shared library and
// bound with ctypes). Each launches on the given stream, allocates nothing,
// and returns cudaGetLastError() so the caller sees a refused launch.

#include "pf_tail.cuh"

namespace {

using namespace pf_tail;

constexpr int kSmallMaxM = 1024;       // B1 and B4
constexpr int kSharedCdfMaxM = 16384;  // CDF in shared memory up to here (64 KB)
constexpr int kMaxThreads = 1024;

template <bool kSoft>
__global__ void pf_tail_kernel(const float* __restrict__ lw,
                               const float* __restrict__ ll,
                               const float* __restrict__ u,
                               const float* __restrict__ particles,
                               float* __restrict__ out_particles,
                               float* __restrict__ out_lw,
                               float* __restrict__ est,
                               float* __restrict__ cdf_scratch,
                               int M, int D, float alpha, float uniform_part,
                               float neg_log_m) {
  extern __shared__ float s_cdf[];
  __shared__ float red[32];

  const size_t row = static_cast<size_t>(blockIdx.x) * M;
  float* cdf = cdf_scratch != nullptr ? cdf_scratch + row : s_cdf;
  const float* x_row = particles + row * D;

  const auto logit = [&](int m) { return lw[row + m] + ll[row + m]; };
  const RowStats st = row_stats(logit, M, red);
  const auto p = [&](int m) { return prob(logit(m), st); };
  const auto x = [&](int m, int d) { return x_row[static_cast<size_t>(m) * D + d]; };
  row_estimate(p, x, M, D, red, est + static_cast<size_t>(blockIdx.x) * D);

  float last;
  if (kSoft) {
    last = row_cdf([&](int m) { return mixture(p(m), alpha, uniform_part); }, M, cdf, red);
  } else {
    last = row_cdf(p, M, cdf, red);
  }

  const float log_sum = logf(st.sum);
  float new_max = -INFINITY;
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const float target = kSoft ? u[row + j] * last : u[row + j];
    const int src = cdf_lower_bound(cdf, M, target);
    const size_t s = (row + src) * D, o = (row + j) * D;
    for (int d = 0; d < D; ++d) out_particles[o + d] = particles[s + d];
    if (kSoft) {
      // Importance reweight at the drawn index: lwn - log q, both
      // recomputed from lw + ll (normalised below).
      const float v = logit(src);
      const float lwn = v - st.max - log_sum;
      const float w = lwn - logf(mixture(prob(v, st), alpha, uniform_part));
      out_lw[row + j] = w;
      new_max = fmaxf(new_max, w);
    } else {
      out_lw[row + j] = neg_log_m;
    }
  }
  if (kSoft) {
    // Log-normalise the new weights. Each thread reads back only the slots
    // it wrote, so the reductions' barriers are all the ordering it needs.
    new_max = block_max(new_max, red);
    float s = 0.0f;
    for (int j = threadIdx.x; j < M; j += blockDim.x) s += expf(out_lw[row + j] - new_max);
    const float shift = new_max + logf(block_sum(s, red));
    for (int j = threadIdx.x; j < M; j += blockDim.x) out_lw[row + j] -= shift;
  }
}

template <bool kSoft>
int launch(const float* lw, const float* ll, const float* u, const float* particles,
           float* out_particles, float* out_lw, float* est, float* cdf_scratch,
           int N, int M, int D, float alpha, void* stream) {
  int threads = ((M + 31) / 32) * 32;
  threads = threads < 256 ? 256 : (threads > kMaxThreads ? kMaxThreads : threads);
  size_t smem = 0;
  if (cdf_scratch == nullptr) {
    smem = static_cast<size_t>(M) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          pf_tail_kernel<kSoft>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const float uniform_part = static_cast<float>((1.0 - static_cast<double>(alpha)) / M);
  const float neg_log_m = static_cast<float>(-log(static_cast<double>(M)));
  pf_tail_kernel<kSoft><<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      lw, ll, u, particles, out_particles, out_lw, est, cdf_scratch, M, D, alpha,
      uniform_part, neg_log_m);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int N, int M, int D) { return N < 1 || M < 1 || D < 1 || D > kMaxD; }

}  // namespace

// B1: multinomial, M <= 1024.
extern "C" int pf_update_and_resample_f32(const float* lw, const float* ll,
                                          const float* u, const float* particles,
                                          float* out_particles, float* out_lw,
                                          float* est, int N, int M, int D,
                                          void* stream) {
  if (bad_shape(N, M, D) || M > kSmallMaxM) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(lw, ll, u, particles, out_particles, out_lw, est, nullptr, N, M,
                       D, 1.0f, stream);
}

// B4: soft resampling (alpha < 1), M <= 1024.
extern "C" int pf_soft_resample_f32(const float* lw, const float* ll, const float* u,
                                    const float* particles, float* out_particles,
                                    float* out_lw, float* est, int N, int M, int D,
                                    float alpha, void* stream) {
  if (bad_shape(N, M, D) || M > kSmallMaxM || !(alpha < 1.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(lw, ll, u, particles, out_particles, out_lw, est, nullptr, N, M, D,
                      alpha, stream);
}

// B5: any M, soft when alpha < 1. Above M = 16,384 the CDF lives in
// `cdf_scratch` (N * M floats, allocated by the caller); at or below it the
// scratch must be null.
extern "C" int pf_resample_large_f32(const float* lw, const float* ll, const float* u,
                                     const float* particles, float* out_particles,
                                     float* out_lw, float* est, float* cdf_scratch,
                                     int N, int M, int D, float alpha, void* stream) {
  if (bad_shape(N, M, D) || ((M > kSharedCdfMaxM) != (cdf_scratch != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (alpha < 1.0f) {
    return launch<true>(lw, ll, u, particles, out_particles, out_lw, est, cdf_scratch, N,
                        M, D, alpha, stream);
  }
  return launch<false>(lw, ll, u, particles, out_particles, out_lw, est, cdf_scratch, N, M,
                       D, 1.0f, stream);
}
