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
// gradients flow through the weights during BPTT. An absent g_lw' (a null
// pointer: the last step's lw', which nothing reads) is read as zeros.
//
// Layout is the JAX public layout: (N, M) rows, particles and g_x (N, M, D)
// row-major, est and g_est (N, D). fp32, contiguous, one device, 1 <= D <= 8,
// any M >= 1 (B2 has no M cap).
//
// Design. The TPU kernels pad M to 128 lanes and D to 128 and form the
// estimate with an MXU dot_general; none of that is carried over (the main
// path has M = 30, D = 3). One warp owns one batch row, `rows` warps a
// block; lane l holds slots l, l + 32, ... (kS of them, M <= 32 kS) and
// their particles in registers, one kernel for each D <= 8 and kS in
// {1, 2, 4, 8}, so no loop bound or `d < D` is a runtime predicate. Every
// load is issued at entry.
//   B2f: lw + ll and the particle of each slot. One warp max (redux.sync on
//   the float's order-preserving int), one expf a slot, then one 5-round
//   shuffle tree carries the sum of e and the D estimate sums together
//   (1 + D independent shuffles a round). lw' is written from registers.
//   B2b: lw', g_lw', the particle of each slot, est and g_est. One 5-round
//   tree for sum(g_lw'); x . g_est from registers; g_s and g_x written a
//   slot.
// A slot's particle is read (and its g_x written) as D floats at a stride of
// D: on the H100 that took 1.41 us for B2f at N = 32, M = 30, D = 3 against
// 1.44 for reading the row coalesced and bringing each float the e of its
// slot by shuffle (2.69 against 2.91 at M = 300), and writing g_x so was as
// fast or faster (PERF.md): the row's lines are in L1 after the first
// load, and a transpose adds shuffles to the chain.
// Rows longer than 256 slots take the looped instance of the same kernels
// (kLooped): B2f walks the row in chunks of 256 with an online rescale of
// its sums and writes lw' in a second pass; B2b sums g_lw' in a first pass.
//
// Bound. Forward: 4 * (N*M*(3 + D) + N*D) bytes, about 23 KB at N = 32,
// M = 30, D = 3 (7 ns at 3.35 TB/s); backward: 4 * (N*M*(3 + 2D) + 2*N*D)
// bytes, about 35 KB there. The arithmetic is a few tens of operations per
// particle. Both are latency bound at the main path's shapes (one launch,
// one round trip to memory, a chain of shuffles): ~1 us for one copy kernel
// over the same bytes on the H100. The design answers with one launch each
// per filter step, no host synchronisation, every load at entry and one
// reduction tree each.
//
// Entry points: plain C functions (built with nvcc into a shared library and
// bound with ctypes). Each launches on the given stream, allocates nothing,
// and returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxD = 8;
constexpr int kMaxSlots = 8;     // register slots a lane: rows of up to 256 in one pass
constexpr int kMaxRows = 8;      // warps (batch rows) a block
constexpr unsigned kFull = 0xffffffffu;

// An int that orders as the float does (a negative float's magnitude bits
// flipped), so a warp's float max is one redux.sync; the map is its own
// inverse.
__device__ __forceinline__ int float_order(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float warp_max(float x) {
  const int m = __reduce_max_sync(kFull, float_order(x));
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// B2f for rows of kD-dimensional particles, kS slots a lane; kLooped walks
// rows longer than 32 kS slots in chunks of 32 kS.
template <int kD, int kS, bool kLooped>
__global__ void __launch_bounds__(kMaxRows * 32)
pf_estimate_fwd_kernel(const float* __restrict__ lw, const float* __restrict__ ll,
                       const float* __restrict__ particles, float* __restrict__ out_lw,
                       float* __restrict__ est, int N, int M) {
  constexpr int kChunk = 32 * kS;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  const size_t row = static_cast<size_t>(n) * M;

  float v[kS];
  float mx = -INFINITY, total = 0.0f;
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.0f;

  for (int base = 0; base < (kLooped ? M : 1); base += kChunk) {  // one chunk unless looped
    // Every load of the chunk at once.
    float x[kS][kD];
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int m = base + lane + 32 * k;
      const bool ok = m < M;
      v[k] = ok ? lw[row + m] + ll[row + m] : -INFINITY;
#pragma unroll
      for (int d = 0; d < kD; ++d) x[k][d] = ok ? particles[(row + m) * kD + d] : 0.0f;
    }

    float cmax = v[0];
#pragma unroll
    for (int k = 1; k < kS; ++k) cmax = fmaxf(cmax, v[k]);
    cmax = warp_max(cmax);
    if (kLooped) {  // rescale what earlier chunks summed to the new max
      const float next = fmaxf(mx, cmax);
      const float scale = mx > -INFINITY ? expf(mx - next) : 0.0f;
      total *= scale;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= scale;
      cmax = next;
    }
    mx = cmax;

    float e[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      e[k] = v[k] > -INFINITY ? expf(v[k] - mx) : 0.0f;
      total += e[k];
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] += e[k] * x[k][d];
    }
  }

  // One tree for the sum and the D sums.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(kFull, total, o);
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] += __shfl_xor_sync(kFull, acc[d], o);
  }
  const float shift = mx + logf(total);
  const float inv_total = __frcp_rn(total);
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < kD; ++d) est[static_cast<size_t>(n) * kD + d] = acc[d] * inv_total;
  }
  if (!kLooped) {
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int m = lane + 32 * k;
      if (m < M) out_lw[row + m] = v[k] - shift;
    }
  } else {
    for (int m = lane; m < M; m += 32) out_lw[row + m] = lw[row + m] + ll[row + m] - shift;
  }
}

// B2b, as B2f's instances. g_lw may be null (read as zeros).
template <int kD, int kS, bool kLooped>
__global__ void __launch_bounds__(kMaxRows * 32)
pf_estimate_bwd_kernel(const float* __restrict__ lwn, const float* __restrict__ particles,
                       const float* __restrict__ est, const float* __restrict__ g_lw,
                       const float* __restrict__ g_est, float* __restrict__ g_s,
                       float* __restrict__ g_particles, int N, int M) {
  constexpr int kChunk = 32 * kS;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const size_t row = static_cast<size_t>(n) * M;
  const bool has_glw = g_lw != nullptr;

  float ge[kD], eg = 0.0f;  // g_est and est . g_est
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    ge[d] = g_est[static_cast<size_t>(n) * kD + d];
    eg += est[static_cast<size_t>(n) * kD + d] * ge[d];
  }

  float sum_glw = 0.0f;
  if (kLooped) {
    float part = 0.0f;
    if (has_glw)
      for (int m = lane; m < M; m += 32) part += g_lw[row + m];
    sum_glw = warp_sum(part);
  }

  for (int base = 0; base < (kLooped ? M : 1); base += kChunk) {  // one chunk unless looped
    float lv[kS], glw[kS], x[kS][kD];
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int m = base + lane + 32 * k;
      const bool ok = m < M;
      lv[k] = ok ? lwn[row + m] : -INFINITY;
      glw[k] = ok && has_glw ? g_lw[row + m] : 0.0f;
#pragma unroll
      for (int d = 0; d < kD; ++d) x[k][d] = ok ? particles[(row + m) * kD + d] : 0.0f;
    }
    if (!kLooped) {
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < kS; ++k) part += glw[k];
      sum_glw = warp_sum(part);
    }

#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int m = base + lane + 32 * k;
      if (m >= M) continue;
      const float p = expf(lv[k]);
      float xg = 0.0f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        xg += x[k][d] * ge[d];
        g_particles[(row + m) * kD + d] = p * ge[d];
      }
      g_s[row + m] = glw[k] - p * sum_glw + p * (xg - eg);
    }
  }
}

bool bad_shape(int N, int M, int D, int rows) {
  return N < 1 || M < 1 || D < 1 || D > kMaxD || rows < 1 || rows > kMaxRows;
}

// The instance for M slots: kS = the least of 1, 2, 4, 8 with M <= 32 kS,
// else the looped one.
template <int kD, typename Launch>
cudaError_t by_slots(int M, Launch launch) {
  if (M <= 32) return launch.template run<kD, 1, false>();
  if (M <= 64) return launch.template run<kD, 2, false>();
  if (M <= 128) return launch.template run<kD, 4, false>();
  if (M <= 32 * kMaxSlots) return launch.template run<kD, kMaxSlots, false>();
  return launch.template run<kD, kMaxSlots, true>();
}

template <typename Launch>
int by_shape(int D, int M, Launch launch) {
  switch (D) {
    case 1: return static_cast<int>(by_slots<1>(M, launch));
    case 2: return static_cast<int>(by_slots<2>(M, launch));
    case 3: return static_cast<int>(by_slots<3>(M, launch));
    case 4: return static_cast<int>(by_slots<4>(M, launch));
    case 5: return static_cast<int>(by_slots<5>(M, launch));
    case 6: return static_cast<int>(by_slots<6>(M, launch));
    case 7: return static_cast<int>(by_slots<7>(M, launch));
    case 8: return static_cast<int>(by_slots<8>(M, launch));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct FwdLaunch {
  const float *lw, *ll, *particles;
  float *out_lw, *est;
  int N, M, rows;
  cudaStream_t stream;
  template <int kD, int kS, bool kLooped>
  cudaError_t run() const {
    pf_estimate_fwd_kernel<kD, kS, kLooped><<<(N + rows - 1) / rows, rows * 32, 0, stream>>>(
        lw, ll, particles, out_lw, est, N, M);
    return cudaGetLastError();
  }
};

struct BwdLaunch {
  const float *lwn, *particles, *est, *g_lw, *g_est;
  float *g_s, *g_particles;
  int N, M, rows;
  cudaStream_t stream;
  template <int kD, int kS, bool kLooped>
  cudaError_t run() const {
    pf_estimate_bwd_kernel<kD, kS, kLooped><<<(N + rows - 1) / rows, rows * 32, 0, stream>>>(
        lwn, particles, est, g_lw, g_est, g_s, g_particles, N, M);
    return cudaGetLastError();
  }
};

}  // namespace

// `rows`: batch rows (warps) a block, 1 to 8.
extern "C" int pf_update_estimate_fwd_f32(const float* lw, const float* ll,
                                          const float* particles, float* out_lw,
                                          float* est, int N, int M, int D, int rows,
                                          void* stream) {
  if (bad_shape(N, M, D, rows)) return static_cast<int>(cudaErrorInvalidValue);
  return by_shape(D, M, FwdLaunch{lw, ll, particles, out_lw, est, N, M, rows,
                                  static_cast<cudaStream_t>(stream)});
}

// g_lw may be null: an absent gradient of lw', read as zeros.
extern "C" int pf_update_estimate_bwd_f32(const float* lwn, const float* particles,
                                          const float* est, const float* g_lw,
                                          const float* g_est, float* g_s,
                                          float* g_particles, int N, int M, int D, int rows,
                                          void* stream) {
  if (bad_shape(N, M, D, rows)) return static_cast<int>(cudaErrorInvalidValue);
  return by_shape(D, M, BwdLaunch{lwn, particles, est, g_lw, g_est, g_s, g_particles, N, M,
                                  rows, static_cast<cudaStream_t>(stream)});
}
