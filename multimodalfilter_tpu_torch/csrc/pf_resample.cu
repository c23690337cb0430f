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
// Design of B1 and B4 (M <= 1024): one thread block per batch row, one
// thread per slot (M rounded up to whole warps), one kernel per D <= 8 so
// no loop over D is predicated, and one pass: every input is read from
// device memory once, nothing written is read back.
//   1. Every load at entry: the thread's lw + ll, u and particle (into
//      registers), the particle also stored into the block's shared copy of
//      the row, by coordinate (D planes of M floats: conflict-free stores,
//      and the gather's source).
//   2. Per warp, from registers: the warp's max (one redux.sync on the
//      float's order-preserving int), e = exp(logit - warp max) (the only
//      exp of a slot), the inclusive shuffle scan of e in slot order, and
//      the estimate's sums of e x[., d]. The warp's last slot publishes
//      (max, scan, sums) in shared memory.  -- barrier 1
//   3. Every warp merges the warps' partials, lane w holding warp w's: the
//      row max (redux), each warp's factor exp(max_w - max) and one shuffle
//      scan of the warps' rescaled totals, whose last entry is the row's sum
//      and whose entries are the warps' CDF offsets; warp 0 sums the
//      estimate in the same shuffle rounds. All warps compute the same
//      values in the same order, so they agree bit for bit. Each thread
//      writes its slot's CDF entry (offset + scale scan, pf_tail.cuh's
//      cluster_cdf) to shared memory at an XOR-swizzled position, the CDF
//      padded with +inf to twice the largest power of two <= M; in soft
//      mode also the importance weight lwn - log q its slot would carry.
//      -- barrier 2
//   4. Each thread finds #(cdf < target) by binary lifting over the padded
//      CDF (no probe branches; the swizzle spreads a warp's probes, which
//      share their low bits, over the banks) and records its draw in shared
//      memory; in soft mode it keeps the drawn slot's weight in a register
//      and the warp publishes the (max, sum of exp) of its new weights.
//      -- barrier 3
//   5. The outputs, each written once: the log-normalised weights from
//      registers, and the row's M x D particle floats in order (consecutive
//      threads on consecutive floats) from the shared copy.
// Three barriers in either mode (13 and 17 in the design this replaced).
// The TPU kernels' triangular-matmul cumsum becomes the shuffle scans;
// their (M x M) compare-and-count the binary search; their one-hot-matmul
// gather a shared-memory read.
//
// Design of B5 (M > 1024): each batch row is split over a thread-block
// cluster of C <= 8 blocks (C chosen by the caller from M), each block
// owning one contiguous slice of S = ceil(M / C) slots (rounded up to 32),
// and runs pf_tail.cuh's cluster row tail. A block reads its slice of
// lw + ll, u and the particles from device memory once, each thread holding
// its (up to 8) slots in registers, scans the slice into its shared memory
// and pushes its partials into every block's. After one cluster barrier it
// pushes its slice's scan to every peer with one bulk copy each
// (cp.async.bulk into the peer's shared memory, counted in bytes on the
// peer's mbarrier) while warp 0 merges the partials in rank order, so all
// blocks hold the same CDF offsets; it then searches the whole row in its
// own shared memory for its own slots (the first level of the search over
// the offsets, the second inside the owning slice) and gathers the drawn
// particles from device memory, writing its outputs coalesced. Measured on
// the H100 against the alternatives: DSMEM loads, one request a slot or 16
// bytes a thread, and copies through L2 each took 1.5-4x longer for the
// row; drawing in the block that owns a target's CDF range scattered the
// outputs. Slices of more than 8,192 slots, or rows of more than 55,000
// floats in shared memory (M > ~52,000 at C = 6), take a strided kernel with
// a two-level search over a device-memory scratch, so every M runs.
// Cluster barriers: 1 after the partials and scans (every block needs all
// of them), 1 in soft mode after the new weights' partials (their
// normaliser), and a split one (arrive once a block has its peers' bytes,
// wait before exit) so no block exits while its own bulk copies are in
// flight.
//
// Bound. A row moves M * (3 + 2D + 1) * 4 bytes plus D * 4 (lw, ll, u and
// particles in; particles and lw out; est out) and does a few tens of
// operations per slot plus log2(M) for the search, so the card's memory
// bounds it: 0.2 MB at N = 16, M = 300, D = 3, under 0.1 us at 3.35 TB/s;
// 10.5 MB at N = 16, M = 16,384, 3.1 us. At B1's and B4's shapes latency
// sets the time instead: on the H100 (700 W) B1 takes 2.6-2.7 us a launch
// at N = 16, M = 300 (the previous design 3.7), B4 3.0-3.1 (4.6-4.7),
// against ~1 us for one copy kernel over the same particles; phase timers
// put ~1,000 cycles in the first read from L2, ~1,000 in the merge's
// dependent shuffles and ~900 in the search's nine dependent shared
// reads (PERF.md). The design answers with one launch per filter step,
// batch rows in parallel blocks, one round trip to device memory in and
// one out, and three block barriers. B5 adds N C blocks and a single pass
// over device memory.
//
// Entry points: plain C functions (built with nvcc into a shared library and
// bound with ctypes). Each launches on the given stream, allocates nothing,
// and returns the launch's error (cudaGetLastError() for B1 and B4) so the
// caller sees a refused launch.

#include "pf_tail.cuh"

namespace {

using namespace pf_tail;

constexpr int kSmallMaxM = 1024;  // B1 and B4
// B1 and B4: one thread a slot.
constexpr int kRowThreads = kSmallMaxM;
constexpr int kRowWarps = kRowThreads / 32;
// B5: blocks of at most 1,024 threads, each holding up to kMaxPer slots of
// its slice in registers: slices of up to 8,192 slots, with the row's scans
// in shared memory (C S floats up to 55,000, 215 KB); the strided kernel
// above.
constexpr int kClusterThreads = 1024;
constexpr int kSharedRowMax = 55000;
constexpr int kMaxPer = 8;

// What a warp of B1/B4 publishes after its loads.
struct WarpPartials {
  float max;         // max logit over the warp's slots
  float total;       // sum of exp(logit - max) over them: the scan at its last slot
  float est[kMaxD];  // sum of exp(logit - max) x[., d]
};

// B1's and B4's static shared memory: the warps' partials, in soft mode
// also the new weights'.
constexpr size_t kRowStaticSmem = kRowWarps * (sizeof(WarpPartials) + sizeof(float2));

// An int that orders as the float does (a negative float's magnitude bits
// flipped), so a warp's float max is one redux.sync; the map is its own
// inverse.
__device__ __forceinline__ int float_order(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float warp_max_redux(float x) {
  const int m = __reduce_max_sync(kFull, float_order(x));
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// Position of CDF slot i in shared memory: the low five bits XOR-folded
// with the next five, so the search's probes, which share their low bits,
// spread over the 32 banks.
__device__ __forceinline__ int cdf_slot(int i) { return i ^ ((i >> 5) & 31); }

// B1 (kSoft false) and B4 (kSoft true) for rows of kD-dimensional
// particles: one block per batch row, thread i owning slot i; the steps are
// numbered as in the design note above. Dynamic shared memory: the row's
// particles by coordinate (kD planes of M), its CDF (M, at cdf_slot), the
// drawn slots (M) and, in soft mode, each slot's importance weight (M).
template <bool kSoft, int kD>
__global__ void __launch_bounds__(kRowThreads)
pf_row_tail_kernel(const float* __restrict__ lw, const float* __restrict__ ll,
                   const float* __restrict__ u, const float* __restrict__ particles,
                   float* __restrict__ out_particles, float* __restrict__ out_lw,
                   float* __restrict__ est, int M, float alpha, float uniform_part,
                   float neg_log_m) {
  extern __shared__ float4 s_dyn4[];
  __shared__ WarpPartials parts[kRowWarps];
  __shared__ float2 soft_parts[kRowWarps];  // soft: (max, sum of exp) of the new weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool valid = tid < M;
  const int top = 1 << (31 - __clz(M));  // the largest power of two <= M
  const size_t row = static_cast<size_t>(blockIdx.x) * M;
  float* xs = reinterpret_cast<float*>(s_dyn4);
  float* cdf = xs + kD * M;
  int* drawn = reinterpret_cast<int*>(cdf + 2 * top);
  float* reweight = reinterpret_cast<float*>(drawn + M);

  // 1. Every load of the thread's slot at once.
  const float v = valid ? lw[row + tid] + ll[row + tid] : -INFINITY;
  float target = valid ? u[row + tid] : 0.0f;
  float x[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) x[d] = valid ? particles[(row + tid) * kD + d] : 0.0f;
  if (valid) {
    if (!kSoft) out_lw[row + tid] = neg_log_m;
#pragma unroll
    for (int d = 0; d < kD; ++d) xs[d * M + tid] = x[d];
  }

  // 2. The warp's max, e, the inclusive scan of e in slot order, the
  // estimate's sums.
  const float wmax = warp_max_redux(v);
  const float e = v > -INFINITY ? expf(v - wmax) : 0.0f;
  const float pre = warp_inclusive_scan(e, lane);
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = e * x[d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] += __shfl_xor_sync(kFull, acc[d], o);
  }
  // The warp's last slot publishes: its scan is the warp's total.
  if (lane == min(31, M - 1 - 32 * warp)) {
    parts[warp].max = wmax;
    parts[warp].total = pre;
#pragma unroll
    for (int d = 0; d < kD; ++d) parts[warp].est[d] = acc[d];
  }
  __syncthreads();  // barrier 1: the partials and the shared particles

  // 3. Every warp merges the warps' partials, lane w holding warp w's: the
  // row's max g, y_w = total_w exp(max_w - g) and their inclusive scan (its
  // last entry the row's sum), so warp w's CDF starts at
  // alpha scan_{w-1} / sum + 32 w (1 - alpha) / M. Warp 0 also sums the
  // estimate, in the same shuffle rounds.
  const bool has = lane < nwarps;
  const float pmax = has ? parts[lane].max : -INFINITY;
  const float g = warp_max_redux(pmax);
  const float f = pmax > -INFINITY ? expf(pmax - g) : 0.0f;
  float y = has ? __fmul_rn(parts[lane].total, f) : 0.0f;
  float r[kD];
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < kD; ++d) r[d] = has ? __fmul_rn(parts[lane].est[d], f) : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float below = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += below;
#pragma unroll
      for (int d = 0; d < kD; ++d) r[d] += __shfl_xor_sync(kFull, r[d], o);
    }
  } else {
    y = warp_inclusive_scan(y, lane);
  }
  const float sum = __shfl_sync(kFull, y, 31), inv_sum = __frcp_rn(sum);
  if (warp == 0 && lane == 0) {
#pragma unroll
    for (int d = 0; d < kD; ++d)
      est[static_cast<size_t>(blockIdx.x) * kD + d] = __fmul_rn(r[d], inv_sum);
  }
  // Warp w's CDF entry at lane l: offset_w + (scale_w scan_l + (l + 1) (1 - alpha) / M).
  const auto offset_of = [&](int w) {
    const float before = w > 0 ? __shfl_sync(kFull, y, w - 1) : 0.0f;
    return __fadd_rn(__fmul_rn(alpha, __fmul_rn(before, inv_sum)),
                     __fmul_rn(static_cast<float>(32 * w), uniform_part));
  };
  const float prob_scale = __fmul_rn(__shfl_sync(kFull, f, warp), inv_sum);  // p = e prob_scale
  const float scale = __fmul_rn(alpha, prob_scale);
  const float offset = offset_of(warp);
  // The padding, [M, 2 top - 1): fewer than top <= M slots, one a thread.
  if (M + tid < 2 * top - 1) cdf[cdf_slot(M + tid)] = INFINITY;
  if (valid) {
    cdf[cdf_slot(tid)] = cluster_cdf(offset, scale, pre, lane, uniform_part);
    if (kSoft) {
      // The importance weight a draw of this slot carries: lwn - log q.
      const float q = mixture(__fmul_rn(e, prob_scale), alpha, uniform_part);
      reweight[tid] = (v - g - logf(sum)) - logf(q);
    }
  }
  if (kSoft) {
    // Soft targets are u cdf[M - 1]: that entry, formed as its owner forms
    // it (its scan is the last warp's total).
    const int last = nwarps - 1;
    const float last_scale = __fmul_rn(alpha, __fmul_rn(__shfl_sync(kFull, f, last), inv_sum));
    target *= cluster_cdf(offset_of(last), last_scale, parts[last].total, (M - 1) & 31,
                          uniform_part);
  }
  __syncthreads();  // barrier 2: the CDF (and the importance weights)

  // 4. The draw: #(cdf < target) clipped to M - 1, by binary lifting over
  // the CDF padded with +inf to twice the largest power of two <= M, so no
  // probe needs a bound.
  int lo = 0;
  for (int step = top; step > 0; step >>= 1)
    lo += cdf[cdf_slot(lo + step - 1)] < target ? step : 0;
  const int src = min(lo, M - 1);
  float w = -INFINITY;
  if (valid) {
    drawn[tid] = src;
    if (kSoft) w = reweight[src];
  }
  if (kSoft) {
    const float m2 = warp_max_redux(w);
    const float s2 = warp_sum(w > -INFINITY ? expf(w - m2) : 0.0f);
    if (lane == 0) soft_parts[warp] = make_float2(m2, s2);
  }
  __syncthreads();  // barrier 3: the draws (and the new weights' partials)

  // 5. The outputs.
  if (kSoft) {
    const float2 sp = has ? soft_parts[lane] : make_float2(-INFINITY, 0.0f);
    const float g2 = warp_max_redux(sp.x);
    const float shift = g2 + logf(warp_sum(sp.x > -INFINITY ? sp.y * expf(sp.x - g2) : 0.0f));
    if (valid) out_lw[row + tid] = w - shift;
  }
  // Float f of the row's output is coordinate f % kD of slot f / kD; a
  // block of at least M threads covers the row's M kD floats in kD rounds,
  // all their reads issued at once.
  float* out_row = out_particles + row * kD;
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    const int fl = tid + k * blockDim.x;
    if (fl < M * kD) out_row[fl] = xs[(fl % kD) * M + drawn[fl / kD]];
  }
}

template <bool kSoft, int kD>
cudaError_t launch_row_d(const float* lw, const float* ll, const float* u, const float* particles,
                  float* out_particles, float* out_lw, float* est, int N, int M, float alpha,
                  float uniform_part, float neg_log_m, cudaStream_t stream) {
  const int threads = (M + 31) / 32 * 32;
  // The CDF padded to 2 top floats, top the largest power of two <= M: at
  // most 1024 x (8 + 4) floats, 49,152 bytes, which with the static partials
  // passes the 48 KB a block may use without raising its limit.
  int top = 1;
  while (2 * top <= M) top *= 2;
  const size_t smem = (static_cast<size_t>(M) * (kD + (kSoft ? 2 : 1)) + 2 * top) * sizeof(float);
  if (smem + kRowStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(pf_row_tail_kernel<kSoft, kD>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pf_row_tail_kernel<kSoft, kD><<<N, threads, smem, stream>>>(
      lw, ll, u, particles, out_particles, out_lw, est, M, alpha, uniform_part, neg_log_m);
  return cudaGetLastError();
}

// B1 and B4: one thread a slot, rounded up to whole warps; one kernel for
// each D <= kMaxD.
template <bool kSoft>
int launch_row(const float* lw, const float* ll, const float* u, const float* particles,
               float* out_particles, float* out_lw, float* est, int N, int M, int D,
               float alpha, void* stream) {
  const float uniform_part = kSoft ? static_cast<float>((1.0 - static_cast<double>(alpha)) / M)
                                   : 0.0f;
  const float neg_log_m = static_cast<float>(-log(static_cast<double>(M)));
  alpha = kSoft ? alpha : 1.0f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define ROW_LAUNCH(DIM)                                                                  \
  case DIM:                                                                              \
    return static_cast<int>(launch_row_d<kSoft, DIM>(lw, ll, u, particles, out_particles, \
                                                     out_lw, est, N, M, alpha,            \
                                                     uniform_part, neg_log_m, s));
    ROW_LAUNCH(1)
    ROW_LAUNCH(2)
    ROW_LAUNCH(3)
    ROW_LAUNCH(4)
    ROW_LAUNCH(5)
    ROW_LAUNCH(6)
    ROW_LAUNCH(7)
    ROW_LAUNCH(8)
#undef ROW_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B5's importance reweight at a drawn slot (soft mode): the normalised
// log-weight minus the mixture's log, before the row's log-normalise.
__device__ __forceinline__ float soft_weight(float v, const ClusterRow& row, float log_sum,
                                             float alpha, float uniform_part) {
  return (v - row.max - log_sum) -
         logf(mixture(expf(v - row.max) / row.sum, alpha, uniform_part));
}

// Soft mode: log-normalise the new weights over the row. Each block
// publishes its slots' (max, sum of exp(w - max)); barrier 2; every block
// merges them in rank order. Returns the shift to subtract, to all threads.
__device__ float soft_shift(float new_max, float sum_part, SlicePartials* part2, float* shift,
                            int C) {
  if (threadIdx.x == 0) {
    part2->max = new_max;
    part2->total = sum_part;
  }
  cluster_sync();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float m = lane < C ? peer(part2, lane)->max : -INFINITY;
    const float t = lane < C ? peer(part2, lane)->total : 0.0f;
    const float g = warp_max(m);
    const float e = lane < C ? __fmul_rn(t, expf(m - g)) : 0.0f;
    float sum = 0.0f;
    for (int r = 0; r < C; ++r) sum = __fadd_rn(sum, __shfl_sync(kFull, e, r));
    if (lane == 0) *shift = g + logf(sum);
  }
  __syncthreads();
  return *shift;
}

// Bulk copies between the shared memories of a cluster (the async proxy),
// with completion counted in bytes on an mbarrier.
__device__ __forceinline__ unsigned cta_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of this block's shared address `a` in rank r.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(r));
  return out;
}

__device__ __forceinline__ void mbar_init_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// Copy `bytes` (a multiple of 16) of this block's shared memory at `src`
// to the shared::cluster address `dst`, counted on the mbarrier `bar`
// (a shared::cluster address in the destination block).
__device__ __forceinline__ void bulk_push(unsigned dst, unsigned src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory position of row slot g in B5's row buffer: the low five
// bits XOR-folded with higher ones, so a warp's binary searches, whose
// probes share their low bits (j 2^a - 1), spread over the 32 banks.
__device__ __forceinline__ int swizzle(int g) { return g ^ (((g >> 5) ^ (g >> 10)) & 31); }

// B5: one cluster of C blocks per batch row; block r owns the slots
// [min(r S, M), min((r + 1) S, M)) (S a multiple of 32), kPer of them a
// thread (slot k blockDim + threadIdx), held in registers from one batch of
// loads. Each block scans its slice into its place in its shared copy of
// the row, pushes its partials to every block, and after barrier 1 pushes
// its slice to every peer with a bulk copy; then it searches the whole row
// for its own slots, forming each probe's CDF entry from its slice's scan,
// offset and scale.
template <bool kSoft, int kPer>
__global__ void __launch_bounds__(kClusterThreads)
pf_cluster_tail_kernel(const float* __restrict__ lw, const float* __restrict__ ll,
                       const float* __restrict__ u, const float* __restrict__ particles,
                       float* __restrict__ out_particles, float* __restrict__ out_lw,
                       float* __restrict__ est, int M, int D, int S, float alpha,
                       float uniform_part, float neg_log_m) {
  extern __shared__ float4 s_dyn4[];
  __shared__ float red[32 * kMaxD];
  __shared__ SlicePartials parts[kMaxCluster];   // every slice's partials
  __shared__ SlicePartials parts2[kMaxCluster];  // soft: the new weights' max and sum
  __shared__ ClusterRow merged;
  __shared__ alignas(8) unsigned long long row_bar;  // the peers' slices have landed

  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n = static_cast<int>(blockIdx.x) / C;
  const size_t row = static_cast<size_t>(n) * M;
  const int start = min(rank * S, M);
  const int count = min(start + S, M) - start;
  const size_t base = row + start;
  const int T = blockDim.x, tid = threadIdx.x;
  // The row's scans (C S floats), slot g at swizzle(g): S is a multiple of
  // 32 and the swizzle permutes aligned groups of 32, so every slice is a
  // contiguous, self-contained range that its owner pushes as it stands.
  float* s_row = reinterpret_cast<float*>(s_dyn4);
  const auto copy_bytes = [&](int r) {  // slice r's bulk copy, whole groups of 32
    const int r_start = r * S, r_count = min(r_start + S, M) - r_start;
    return static_cast<unsigned>((r_count + 31) / 32 * 32 * sizeof(float));
  };
  if (tid == 0) {
    unsigned incoming = 0;
    for (int r = 0; r < C; ++r)
      if (r != rank) incoming += copy_bytes(r);
    mbar_init_expect(cta_addr(&row_bar), incoming);
  }

  // a. Every load of the thread's slots at once; the estimate's partial
  // sums against the thread's own max, rescaled to the block's below.
  float v[kPer], target[kPer];
  float tmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * T + tid;
    v[k] = i < count ? lw[base + i] + ll[base + i] : -INFINITY;
    target[k] = i < count ? u[base + i] : 0.0f;
    tmax = fmaxf(tmax, v[k]);
  }
  float acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * T + tid;
    if (i < count) {
      const float e = expf(v[k] - tmax);
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) acc[d] += e * particles[(base + i) * D + d];
    }
  }
  const float mx = block_max(tmax, red);
  const float rescale = tid < count ? expf(tmax - mx) : 0.0f;
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] *= rescale;
  // The slice's inclusive scan of exp(logit - max), in slot order.
  float carry = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * T + tid;
    float tile;
    const float c = block_inclusive_scan(i < count ? expf(v[k] - mx) : 0.0f, red, &tile);
    if (i < count) s_row[swizzle(start + i)] = carry + c;
    carry += tile;
  }
  block_sums(acc, D, red);  // its barriers also publish the scan
  if (tid == 0) {
    SlicePartials p;
    p.max = mx;
    p.total = s_row[swizzle(start + count - 1)];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) p.est[d] = acc[d];
    for (int r = 0; r < C; ++r) peer(parts, r)[rank] = p;
  }

  // b-c. Barrier 1: every slice's scan and partials are in place, and
  // every block's mbarrier is set up. One thread of each block pushes its
  // slice to every peer with one bulk copy each, while warp 0 merges the
  // partials in rank order; then the block waits for its peers' bytes.
  cluster_sync();
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned src = cta_addr(s_row + start), bytes = copy_bytes(rank);
    for (int r = 0; r < C; ++r)
      if (r != rank)
        bulk_push(cluster_addr(src, r), src, bytes, cluster_addr(cta_addr(&row_bar), r));
  }
  if (tid < 32) {
    merge_partials([&](int r) { return &parts[r]; }, C, S, M, D, alpha, uniform_part,
                   &merged);
  }
  mbar_wait(cta_addr(&row_bar), 0);
  __syncthreads();
  // This block has received its peers' slices: arrive at the barrier that
  // keeps every block resident until its own pushes have landed, and wait
  // for the others only where it must (before barrier 2, or at exit).
  cluster_arrive();
  if (rank == 0 && tid < D) est[n * D + tid] = merged.est[tid];

  // d. The thread's searches at once: the slice whose CDF range holds the
  // target (a count over the offsets), then #(cdf < target) inside it by
  // binary lifting, each probe's CDF entry formed from the slice's scan as
  // cluster_cdf forms it (in multinomial mode without its zero last term).
  float offsets[kMaxCluster];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) offsets[r] = r < C ? merged.offset[r] : INFINITY;
  int lo[kPer], first_slot[kPer], hi[kPer];
  float off[kPer], scl[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (kSoft) target[k] *= merged.offset[C];
    int r = 0;
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) r += offsets[q] < target[k];
    first_slot[k] = lo[k] = r * S;
    hi[k] = min(lo[k] + S, M);
    off[k] = merged.offset[r];
    scl[k] = merged.scale[r];
  }
  for (int step = 1 << (31 - __clz(S)); step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int g = lo[k] + step - 1;
      if (g < hi[k]) {
        const float raw_scan = s_row[swizzle(g)];
        const float cdf =
            kSoft ? cluster_cdf(off[k], scl[k], raw_scan, g - first_slot[k], uniform_part)
                  : __fadd_rn(off[k], __fmul_rn(scl[k], raw_scan));
        if (cdf < target[k]) lo[k] += step;
      }
    }
  }

  // e. Gather (every load of the thread's draws in flight at once), and
  // the new weights.
  const float log_sum = logf(merged.sum);
  float w[kPer];
  float new_max = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * T + tid;
    if (i >= count) continue;
    const size_t src = row + min(lo[k], M - 1);
    float x[kMaxD];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d) x[d] = d < D ? particles[src * D + d] : 0.0f;
    float vsrc = 0.0f;
    if (kSoft) vsrc = lw[src] + ll[src];
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) out_particles[(base + i) * D + d] = x[d];
    if (kSoft) {
      w[k] = soft_weight(vsrc, merged, log_sum, alpha, uniform_part);
      new_max = fmaxf(new_max, w[k]);
    } else {
      out_lw[base + i] = neg_log_m;
    }
  }
  if (kSoft) {
    // Log-normalise the new weights over the row: each block pushes its
    // slots' (max, sum of exp(w - max)); barrier 2; a merge in rank order.
    new_max = block_max(new_max, red);
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k * T + tid < count) s += expf(w[k] - new_max);
    s = block_sum(s, red);
    cluster_wait();  // the split barrier: every block has its peers' slices
    if (tid == 0) {
      for (int r = 0; r < C; ++r) {
        peer(parts2, r)[rank].max = new_max;
        peer(parts2, r)[rank].total = s;
      }
    }
    cluster_sync();
    float g = -INFINITY, sum = 0.0f;
    for (int r = 0; r < C; ++r) g = fmaxf(g, parts2[r].max);
    for (int r = 0; r < C; ++r)
      sum = __fadd_rn(sum, __fmul_rn(parts2[r].total, expf(parts2[r].max - g)));
    const float shift = g + logf(sum);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * T + tid;
      if (i < count) out_lw[base + i] = w[k] - shift;
    }
  } else {
    // Stay resident until every block has its peers' slices: the bulk
    // copies read this block's shared memory until they land.
    cluster_wait();
  }
}

// B5 for rows too long for shared memory: the same steps with the slice's
// scan in `scratch` (N x M floats), the logits read again from lw + ll, the
// slots strided over the threads, and a two-level search over the scratch.
template <bool kSoft>
__global__ void __launch_bounds__(512)
pf_cluster_tail_scratch_kernel(const float* __restrict__ lw, const float* __restrict__ ll,
                               const float* __restrict__ u,
                               const float* __restrict__ particles,
                               float* __restrict__ out_particles, float* __restrict__ out_lw,
                               float* __restrict__ est, float* __restrict__ scratch, int M,
                               int D, int S, float alpha, float uniform_part,
                               float neg_log_m) {
  __shared__ float red[32 * kMaxD];
  __shared__ SlicePartials part;
  __shared__ SlicePartials part2;
  __shared__ ClusterRow merged;
  __shared__ float shift;

  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int n = static_cast<int>(blockIdx.x) / C;
  const size_t row = static_cast<size_t>(n) * M;
  const int start = min(rank * S, M);
  const int count = min(start + S, M) - start;
  const size_t base = row + start;
  float* scan_row = scratch + row;
  float* scan = scan_row + start;
  const auto logit = [&](int i) { return lw[base + i] + ll[base + i]; };

  float mx = -INFINITY;
  for (int i = threadIdx.x; i < count; i += blockDim.x) mx = fmaxf(mx, logit(i));
  mx = block_max(mx, red);
  float acc[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d) acc[d] = 0.0f;
  float carry = 0.0f;
  for (int b = 0; b < count; b += blockDim.x) {
    const int i = b + threadIdx.x;
    const float e = i < count ? expf(logit(i) - mx) : 0.0f;
    float tile;
    const float c = block_inclusive_scan(e, red, &tile);
    if (i < count) {
      scan[i] = carry + c;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) acc[d] += e * particles[(base + i) * D + d];
    }
    carry += tile;
  }
  block_sums(acc, D, red);  // its barriers also publish scan
  if (threadIdx.x == 0) {
    part.max = mx;
    part.total = scan[count - 1];
    for (int d = 0; d < D; ++d) part.est[d] = acc[d];
  }

  cluster_sync();
  if (threadIdx.x < 32) {
    merge_partials([&](int r) { return peer(&part, r); }, C, S, M, D, alpha,
                   uniform_part, &merged);
  }
  __syncthreads();
  if (rank == 0 && threadIdx.x < D) est[n * D + threadIdx.x] = merged.est[threadIdx.x];

  const auto scan_of = [&](int r) -> const float* { return scan_row + merged.start[r]; };
  const float target_scale = kSoft ? merged.offset[C] : 1.0f;
  const float log_sum = logf(merged.sum);
  float new_max = -INFINITY;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const Draw draw = cluster_lower_bound(merged, C, scan_of, uniform_part,
                                          u[base + j] * target_scale);
    const size_t src = row + merged.start[draw.rank] + draw.local;
    for (int d = 0; d < D; ++d) out_particles[(base + j) * D + d] = particles[src * D + d];
    if (kSoft) {
      const float w = soft_weight(lw[src] + ll[src], merged, log_sum, alpha, uniform_part);
      out_lw[base + j] = w;
      new_max = fmaxf(new_max, w);
    } else {
      out_lw[base + j] = neg_log_m;
    }
  }
  if (kSoft) {
    // Each thread reads back only the slots it wrote.
    new_max = block_max(new_max, red);
    float s = 0.0f;
    for (int j = threadIdx.x; j < count; j += blockDim.x) s += expf(out_lw[base + j] - new_max);
    const float sh = soft_shift(new_max, block_sum(s, red), &part2, &shift, C);
    for (int j = threadIdx.x; j < count; j += blockDim.x) out_lw[base + j] -= sh;
  }
  cluster_sync();
}

// B5's launch for rows of M in clusters of C: which kernel, its block and
// its shared memory.
struct ClusterLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  int S;
  int per;  // slots a thread (shared-memory kernel), 0 for the scratch kernel
};

// B5's slice: ceil(M / C) rounded up to a multiple of 32 (the swizzle
// keeps each slice to itself, and bulk copies are whole 16-byte units).
int slice_of(int M, int C) { return ((M + C - 1) / C + 31) / 32 * 32; }

// The register kernel takes slices of up to kMaxPer * kClusterThreads
// slots; longer ones go to the strided kernel.
bool strided(int M, int C) {
  const int S = slice_of(M, C);
  return S > kMaxPer * kClusterThreads || C * S > kSharedRowMax;
}

template <bool kSoft, int kPer>
void* shared_kernel_for() {
  return reinterpret_cast<void*>(pf_cluster_tail_kernel<kSoft, kPer>);
}

template <bool kSoft>
void* kernel_for(int per) {
  switch (per) {
    case 0: return reinterpret_cast<void*>(pf_cluster_tail_scratch_kernel<kSoft>);
    case 1: return shared_kernel_for<kSoft, 1>();
    case 2: return shared_kernel_for<kSoft, 2>();
    case 3: return shared_kernel_for<kSoft, 3>();
    case 4: return shared_kernel_for<kSoft, 4>();
    case 6: return shared_kernel_for<kSoft, 6>();
    default: return shared_kernel_for<kSoft, 8>();
  }
}

int cluster_config(int N, int M, int C, bool soft, void* stream, ClusterLaunch* out) {
  const int S = slice_of(M, C);
  if ((C - 1) * S >= M) return static_cast<int>(cudaErrorInvalidValue);  // an empty slice
  int per = 0, threads = 512;  // the strided kernel: 512 threads
  size_t smem = 0;
  if (!strided(M, C)) {
    // Slots a thread: the fewest of 1, 2, 3, 4, 6 and 8 that cover the slice.
    constexpr int kPers[] = {1, 2, 3, 4, 6, 8};
    for (const int p : kPers) {
      per = p;
      if (p * kClusterThreads >= S) break;
    }
    threads = ((S + per - 1) / per + 31) / 32 * 32;
    threads = threads < 64 ? 64 : threads;
    smem = static_cast<size_t>(C) * S * sizeof(float);  // the row's scans
  }
  void* kernel = soft ? kernel_for<true>(per) : kernel_for<false>(per);
  // Always: with its static shared memory a block may pass 48 KB already.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out->S = S;
  out->per = per;
  out->config = cudaLaunchConfig_t{};
  out->config.gridDim = dim3(static_cast<unsigned>(N * C));
  out->config.blockDim = dim3(static_cast<unsigned>(threads));
  out->config.dynamicSmemBytes = smem;
  out->config.stream = static_cast<cudaStream_t>(stream);
  out->attribute.id = cudaLaunchAttributeClusterDimension;
  out->attribute.val.clusterDim.x = static_cast<unsigned>(C);
  out->attribute.val.clusterDim.y = 1;
  out->attribute.val.clusterDim.z = 1;
  out->config.attrs = &out->attribute;
  out->config.numAttrs = 1;
  return 0;
}

template <bool kSoft>
int launch_cluster(const float* lw, const float* ll, const float* u,
                   const float* particles, float* out_particles, float* out_lw, float* est,
                   float* scratch, int N, int M, int D, int C, float alpha,
                   void* stream) {
  ClusterLaunch cl;
  const int rc = cluster_config(N, M, C, kSoft, stream, &cl);
  if (rc != 0) return rc;
  const float uniform_part =
      kSoft ? static_cast<float>((1.0 - static_cast<double>(alpha)) / M) : 0.0f;
  const float neg_log_m = static_cast<float>(-log(static_cast<double>(M)));
  alpha = kSoft ? alpha : 1.0f;
  cudaError_t err;
  switch (cl.per) {
    case 0:
      err = cudaLaunchKernelEx(&cl.config, pf_cluster_tail_scratch_kernel<kSoft>, lw, ll, u,
                               particles, out_particles, out_lw, est, scratch, M, D, cl.S,
                               alpha, uniform_part, neg_log_m);
      break;
#define B5_LAUNCH(P)                                                                       \
  case P:                                                                                  \
    err = cudaLaunchKernelEx(&cl.config, pf_cluster_tail_kernel<kSoft, P>, lw, ll, u,      \
                             particles, out_particles, out_lw, est, M, D, cl.S, alpha,     \
                             uniform_part, neg_log_m);                                     \
    break;
      B5_LAUNCH(1)
      B5_LAUNCH(2)
      B5_LAUNCH(3)
      B5_LAUNCH(4)
      B5_LAUNCH(6)
      B5_LAUNCH(8)
#undef B5_LAUNCH
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
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
  return launch_row<false>(lw, ll, u, particles, out_particles, out_lw, est, N, M, D,
                           1.0f, stream);
}

// B4: soft resampling (alpha < 1), M <= 1024.
extern "C" int pf_soft_resample_f32(const float* lw, const float* ll, const float* u,
                                    const float* particles, float* out_particles,
                                    float* out_lw, float* est, int N, int M, int D,
                                    float alpha, void* stream) {
  if (bad_shape(N, M, D) || M > kSmallMaxM || !(alpha < 1.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_row<true>(lw, ll, u, particles, out_particles, out_lw, est, N, M, D,
                          alpha, stream);
}

// B5: any M, soft when alpha < 1, in clusters of `cluster` blocks a row
// (the slice S = ceil(M / cluster) rounded up to a multiple of 32). Rows
// that take the strided kernel (slices of more than 8,192 slots, or C S >
// 55,000) keep their scans in `scratch` (N * M floats, allocated by the
// caller); otherwise the scratch must be null. A cluster size the card
// cannot schedule is refused by the launch, whose error is returned.
extern "C" int pf_resample_large_f32(const float* lw, const float* ll, const float* u,
                                     const float* particles, float* out_particles,
                                     float* out_lw, float* est, float* scratch, int N,
                                     int M, int D, int cluster, float alpha, void* stream) {
  if (bad_shape(N, M, D) || cluster < 1 || strided(M, cluster) != (scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (alpha < 1.0f) {
    return launch_cluster<true>(lw, ll, u, particles, out_particles, out_lw, est, scratch,
                                N, M, D, cluster, alpha, stream);
  }
  return launch_cluster<false>(lw, ll, u, particles, out_particles, out_lw, est, scratch,
                               N, M, D, cluster, 1.0f, stream);
}

// What pf_resample_large_f32 launches for N rows of M in clusters of
// `cluster`: the blocks in all, whether the rows take the strided kernel
// (and so need the scratch), and, unless `max_clusters` is null, how many
// such clusters the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int pf_resample_large_plan(int N, int M, int cluster, int soft, int* blocks,
                                      int* strided_rows, int* max_clusters) {
  if (N < 1 || M < 1 || cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch cl;
  const int rc = cluster_config(N, M, cluster, soft != 0, nullptr, &cl);
  if (rc != 0) return rc;
  *blocks = static_cast<int>(cl.config.gridDim.x);
  *strided_rows = cl.per == 0 ? 1 : 0;
  if (max_clusters == nullptr) return 0;
  void* kernel = soft ? kernel_for<true>(cl.per) : kernel_for<false>(cl.per);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cl.config));
}
